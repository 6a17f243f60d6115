"""The port's ``MeshFarm`` over process workers, cases that kill no worker:
twins of tests/test_mesh_workers.py and tests/test_mesh_smoke.py on the
CPU (``device="cpu"``, the pickle transport, 2 shards, a worker timeout
of 60 s). One spawned mesh serves the cases that only read it (the
module fixture keeps the log of what it was delivered), and ``SyncFarm``
and the serving stack run over it unmodified, byte-identical to the JAX
package's ``SyncFarm`` over its ``MeshFarm``.
"""
import json
import multiprocessing

import numpy as np
import pytest
import torch

from automerge_tpu.parallel import MeshFarm as JaxMeshFarm
from automerge_tpu.tpu.sync_farm import SyncFarm as JaxSyncFarm
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu_torch import SyncFarm, TorchDocFarm
from automerge_tpu_torch.obs.metrics import enabled_metrics
from automerge_tpu_torch.obs.scope import dispatch_context, get_amscope
from automerge_tpu_torch.opset import OpSet
from automerge_tpu_torch.parallel import make_mesh
from automerge_tpu_torch.parallel.meshfarm import MeshFarm
from automerge_tpu_torch.serve import LoadConfig, LoadGen
from test_farm import Workload

NUM_DOCS = 8
NUM_SHARDS = 2
TIMEOUT_S = 60.0


def _rounds(seed=3, rounds=6):
    gen = OpSet()
    w = Workload(seed)
    return [r for r in (w.next_round(gen) for _ in range(rounds)) if r]


def _mesh(backend, num_docs=NUM_DOCS, **kw):
    return MeshFarm(num_docs, num_shards=NUM_SHARDS, capacity=64,
                    mesh_backend=backend, mesh_transport="pickle",
                    worker_timeout=TIMEOUT_S, device="cpu", **kw)


def _final_patches(mesh):
    return [json.dumps(mesh.get_patch(d), sort_keys=True)
            for d in range(mesh.num_docs)]


class Shared:
    """One process mesh shared by the read-only cases, with the log of
    every delivery it took (so a twin can replay them)."""

    def __init__(self):
        self.mesh = _mesh("process")
        self.log = []

    def apply(self, per_doc):
        self.log.append(per_doc)
        return self.mesh.apply_changes(per_doc)


@pytest.fixture(scope="module")
def shared():
    s = Shared()
    try:
        yield s
    finally:
        s.mesh.close()
    assert multiprocessing.active_children() == []


def test_quarantine_reads_are_rpc_free_on_process_backend(shared):
    """The serve batcher checks ``farm.quarantine`` on every submit, so the
    process controller answers from its mirror without a round trip."""
    calls = []
    originals = []
    for h in shared.mesh._handles:
        orig = h.call
        originals.append((h, orig))
        h.call = (lambda orig: lambda *a, **k: (
            calls.append(a[0]), orig(*a, **k))[1])(orig)
    try:
        for _ in range(50):
            assert shared.mesh.quarantine == {}
        assert calls == []
    finally:
        for h, orig in originals:
            h.call = orig


def test_worker_exemplar_resolves_to_controller_span(shared):
    """A latency exemplar recorded inside a worker
    (``farm.dispatch.latency_ms``) resolves to the controller's dispatch
    span id in one lookup: the id rides the fan-out payload and the
    shipped metric delta carries it back."""
    deliveries = _rounds(rounds=1)
    with enabled_metrics() as reg:
        reg.reset()
        span = get_amscope().begin_dispatch([], 0.0)
        with dispatch_context(span):
            shared.apply([list(deliveries[0]) for _ in range(NUM_DOCS)])
        hist = reg.find("farm.dispatch.latency_ms")
        assert hist is not None and hist.count > 0, \
            "no worker-side dispatch observations merged back"
        assert hist.exemplar_for(0.99) == span.dispatch_id


def test_pipe_payload_control_split_under_pickle(shared):
    """``mesh.pipe.<s>.*`` splits column-payload frames from control
    frames: under the pickle transport the apply batches and result frames
    are payload, the rest (acks, RPCs) control."""
    deliveries = _rounds(seed=4, rounds=3)
    with enabled_metrics() as reg:
        reg.reset()
        for buffers in deliveries:
            shared.apply([list(buffers) for _ in range(NUM_DOCS)])
        shared.mesh.heartbeat()
        snap = reg.as_dict()

    def total(suffix, field):
        return sum(snap.get(f"mesh.pipe.{s}.{suffix}", {}).get(field, 0)
                   for s in range(NUM_SHARDS))

    assert total("payload_ms", "count") == 2 * 2 * len(deliveries)
    assert total("payload_bytes", "value") > 0
    assert total("control_ms", "count") > 0
    assert total("control_bytes", "value") > 0
    assert total("bytes_out", "value") + total("bytes_in", "value") == \
        total("payload_bytes", "value") + total("control_bytes", "value")


def _sync_log(server, replica, docs, init):
    """Sweeps a replica against a server until no message moves; returns
    every message and patch in order."""
    s_states = [init() for _ in range(docs)]
    r_states = [init() for _ in range(docs)]
    out = []
    for _ in range(16):
        moved = 0
        for src, dst, src_states, dst_states in (
                (replica, server, r_states, s_states),
                (server, replica, s_states, r_states)):
            batch = []
            for d, (state, msg) in enumerate(src.generate_messages(
                    [(d, src_states[d]) for d in range(docs)])):
                src_states[d] = state
                out.append(msg)
                if msg is not None:
                    batch.append((d, dst_states[d], msg))
            moved += len(batch)
            if batch:
                for (d, _, _), (state, patch) in zip(
                        batch, dst.receive_messages(batch)):
                    dst_states[d] = state
                    out.append(json.dumps(patch, sort_keys=True))
        if not moved:
            return out
    raise AssertionError("sync did not quiesce")


def test_sync_farm_over_a_mesh_matches_jax(shared):
    """``SyncFarm`` runs over a ``MeshFarm`` (it reads ``farm.device``, the
    controller's): a fresh replica catches up from the process mesh and
    from an inline mesh with the same history, and every message and
    patch equals the JAX ``SyncFarm`` over the JAX ``MeshFarm``."""
    shared.apply([list(b) for b in [_rounds(seed=5, rounds=2)[0]]]
                 * NUM_DOCS)
    inline = _mesh("inline")
    jax_mesh = JaxMeshFarm(NUM_DOCS, num_shards=NUM_SHARDS, capacity=64)
    for per_doc in shared.log:
        inline.apply_changes(per_doc)
        jax_mesh.apply_changes(per_doc)
    assert shared.mesh.device == inline.device == torch.device("cpu")
    want = _sync_log(JaxSyncFarm(jax_mesh),
                     JaxSyncFarm(TpuDocFarm(NUM_DOCS, capacity=64)),
                     NUM_DOCS, JaxSyncFarm.init_state)
    assert sum(m is not None for m in want) > NUM_DOCS
    for mesh in (shared.mesh, inline):
        got = _sync_log(SyncFarm(mesh),
                        SyncFarm(TorchDocFarm(NUM_DOCS, capacity=64,
                                              device="cpu")),
                        NUM_DOCS, SyncFarm.init_state)
        assert got == want
    assert _final_patches(inline) == _final_patches(shared.mesh)


def test_serving_front_door_runs_over_a_mesh():
    """``LoadGen`` -> ``AmServer`` -> ``DynamicBatcher`` over an inline and
    a process mesh (with the batcher's per-shard accounting) gives the
    single farm's report and documents."""
    config = LoadConfig(clients=16, docs=4, edits_per_client=2,
                        ops_per_edit=4, spread=0.2, seed=3)
    runs = []
    for farm in (TorchDocFarm(4, capacity=256, device="cpu"),
                 _mesh("inline", num_docs=4),
                 _mesh("process", num_docs=4)):
        try:
            report = LoadGen(farm, config).run()
            assert report["converged"], report
            report.pop("host_s", None)
            runs.append((json.dumps(report, sort_keys=True, default=repr),
                         [json.dumps(farm.get_patch(d), sort_keys=True)
                          for d in range(4)]))
        finally:
            if isinstance(farm, MeshFarm):
                farm.close()
    assert runs[1] == runs[0]
    assert runs[2] == runs[0]


def test_migration_and_rebalance_over_the_pipe_match_inline():
    before = set(multiprocessing.active_children())  # the shared mesh's

    def drive(backend):
        mesh = _mesh(backend)
        try:
            for r, buffers in enumerate(_rounds(seed=5)):
                mesh.apply_changes([list(buffers) for _ in range(NUM_DOCS)])
                if r == 2:
                    d = next(x for x in range(NUM_DOCS)
                             if mesh.shard_of(x) == 0)
                    mesh.migrate_doc(d, 1)
                    mesh.audit()
            mid = _final_patches(mesh)
            mesh.rebalance(max_moves=1, min_gain_pages=0)
            mesh.audit()
            return mid, _final_patches(mesh)
        finally:
            mesh.close()

    assert drive("inline") == drive("process")
    assert set(multiprocessing.active_children()) <= before


def test_shards_take_their_devices_round_robin():
    """``devices=`` places shard s on devices[s % len(devices)]; the
    controller's device is the first; the default is one device."""
    mesh = MeshFarm(6, num_shards=3, capacity=16,
                    devices=["cpu", torch.device("cpu")])
    try:
        assert mesh.device == torch.device("cpu")
        assert [f.device for f in mesh.shards] == [torch.device("cpu")] * 3
        assert [mesh._shard_device(s) for s in range(3)] == \
            [torch.device("cpu")] * 3
    finally:
        mesh.close()


def test_make_mesh_validates_the_split():
    devices = [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(devices, sp=3)
    with pytest.raises(ValueError, match="sp must be >= 1"):
        make_mesh(devices, sp=0)
    grid = make_mesh(devices, sp=2)
    assert grid.shape == (4, 2)
    assert grid.dtype == np.dtype(object)
    assert all(d == torch.device("cpu") for d in grid.flat)


def test_meshfarm_rejects_bad_shapes_and_batch_isolation():
    with pytest.raises(ValueError):
        MeshFarm(2, num_shards=3, capacity=32, device="cpu")
    with pytest.raises(ValueError):
        MeshFarm(4, num_shards=2, capacity=32, mesh_backend="bogus",
                 device="cpu")
    mesh = MeshFarm(4, num_shards=2, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="isolation='doc'"):
        mesh.apply_changes([[] for _ in range(4)], isolation="batch")

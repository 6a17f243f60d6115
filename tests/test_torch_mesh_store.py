"""The port's mesh over its persistence tier, and the flight recorder's
black box: twins of the mesh tests of tests/test_store.py and of the
black-box round trips (tests/test_flight.py, tests/test_store.py), on the
CPU (``device="cpu"``, the pickle transport, a worker timeout of 60 s).

- a process worker SIGKILLed mid-commit re-hydrates from its shard store
  on respawn, and a brand-new ``MeshFarm`` over the same ``store_dir``
  serves the same patches after ``close()``;
- the inline backend writes the same per-shard stores, and its store
  directories are byte-identical to the JAX ``MeshFarm``'s;
- ``store_dir`` with automatic rebalancing is refused;
- ``write_blackbox``/``read_blackbox`` round-trip a bounded, shard-tagged
  tail through the atomic writer, in the JAX package's bytes.
"""
import json
import multiprocessing
import os

import pytest

from automerge_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from automerge_tpu.obs.flight import write_blackbox as jax_write_blackbox
from automerge_tpu.parallel import MeshFarm as JaxMeshFarm
from automerge_tpu_torch.obs.flight import (BLACKBOX_TAIL, FlightRecorder,
                                            read_blackbox, write_blackbox)
from automerge_tpu_torch.parallel.meshfarm import MeshFarm
from chip_smoke import dir_files, store_streams

OPS = 6
ROUNDS = 3
CAP = ROUNDS * OPS + 8
TIMEOUT_S = 60.0


def _streams(num_docs, rounds=ROUNDS, seed=0):
    """Per doc, one actor's stream (the JAX suite's, seeded seed + 31 d)."""
    return [store_streams(1, rounds, OPS, seed + 31 * d)[0]
            for d in range(num_docs)]


def _round_delivery(streams, r):
    return [[streams[d][r]] for d in range(len(streams))]


def _patches(mesh):
    return [json.dumps(mesh.get_patch(d), sort_keys=True)
            for d in range(mesh.num_docs)]


def _mesh(num_docs, backend, store_dir):
    return MeshFarm(num_docs, num_shards=2, capacity=CAP,
                    mesh_backend=backend, mesh_transport="pickle",
                    worker_timeout=TIMEOUT_S, store_dir=store_dir,
                    device="cpu")


def test_mesh_worker_sigkill_mid_commit_then_cold_restart(tmp_path):
    """A shard worker SIGKILLs itself mid-delivery: the controller
    quarantines the in-flight docs, the respawned worker re-hydrates from
    its shard store (plus the delivery-log replay), a release and
    re-delivery completes the round, and a new MeshFarm over the same
    store_dir serves identical patches after close()."""
    store_dir = str(tmp_path / "mesh-store")
    num_docs, rounds = 6, 2
    streams = _streams(num_docs, rounds=rounds + 1, seed=100)
    mesh = _mesh(num_docs, "process", store_dir)
    try:
        for r in range(rounds):
            mesh.apply_changes(_round_delivery(streams, r))
        mesh.inject_worker_fault(1, when="next_apply")
        res = mesh.apply_changes(_round_delivery(streams, rounds))
        crashed = [d for d in range(num_docs)
                   if res.outcomes[d].status == "quarantined"]
        assert crashed, "the SIGKILL round should quarantine in-flight docs"
        for d in crashed:
            mesh.release_quarantine(d)
        delivery = [[] for _ in range(num_docs)]
        for d in crashed:
            delivery[d] = [streams[d][rounds]]
        res = mesh.apply_changes(delivery)
        assert all(res.outcomes[d].status == "applied" for d in crashed)
        before = _patches(mesh)
    finally:
        mesh.close()
    assert multiprocessing.active_children() == []

    cold = _mesh(num_docs, "process", store_dir)
    try:
        assert _patches(cold) == before
    finally:
        cold.close()
    assert multiprocessing.active_children() == []


def test_mesh_inline_backend_persists_in_the_jax_bytes(tmp_path):
    """store_dir is backend-agnostic: the inline mesh writes per-shard
    stores, cold-restarts from them, and its directories are
    byte-identical to the JAX MeshFarm's on the same deliveries."""
    num_docs = 6
    streams = _streams(num_docs, seed=200)
    store_dir = str(tmp_path / "mesh-store")
    jax_dir = str(tmp_path / "jax-store")
    mesh = _mesh(num_docs, "inline", store_dir)
    jax_mesh = JaxMeshFarm(num_docs, num_shards=2, capacity=CAP,
                           store_dir=jax_dir)
    try:
        for r in range(ROUNDS):
            mesh.apply_changes(_round_delivery(streams, r))
            jax_mesh.apply_changes(_round_delivery(streams, r))
        before = _patches(mesh)
        assert before == [json.dumps(jax_mesh.get_patch(d), sort_keys=True)
                          for d in range(num_docs)]
    finally:
        mesh.close()
        jax_mesh.close()
    assert sorted(os.listdir(store_dir)) == ["shard-000", "shard-001"]
    assert dir_files(store_dir) == dir_files(jax_dir)

    cold = _mesh(num_docs, "inline", store_dir)
    try:
        assert _patches(cold) == before
    finally:
        cold.close()


def test_mesh_store_dir_vs_rebalance_is_an_error(tmp_path):
    with pytest.raises(ValueError, match="rebalanc"):
        MeshFarm(4, num_shards=2, store_dir=str(tmp_path / "s"),
                 rebalance_interval=2, device="cpu")


def _recorders():
    """A port and a JAX recorder holding the same shard-tagged events."""
    out = []
    for cls in (FlightRecorder, JaxFlightRecorder):
        rec = cls(clock=lambda: 2.0)
        rec.enabled = True
        rec.shard = 1
        rec.epoch = 2
        for i in range(BLACKBOX_TAIL + 10):
            rec.record("e", i=i)
        out.append(rec)
    return out


def test_blackbox_write_read_round_trip(tmp_path):
    rec, jax_rec = _recorders()
    path = str(tmp_path / "bb.json")
    write_blackbox(path, rec, phases_jsonl="{}")
    bb = read_blackbox(path)
    assert bb["pid"] == os.getpid()
    assert (bb["shard"], bb["epoch"]) == (1, 2)
    assert len(bb["events"]) == BLACKBOX_TAIL     # bounded tail
    assert bb["events"][-1]["fields"]["i"] == BLACKBOX_TAIL + 9
    assert bb["phases"] == "{}"
    # the JAX package's black box of the same events: the same bytes
    jax_path = str(tmp_path / "jax-bb.json")
    jax_write_blackbox(jax_path, jax_rec, phases_jsonl="{}")
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    # best-effort by contract: absent and torn files read as None
    assert read_blackbox(str(tmp_path / "missing.json")) is None
    (tmp_path / "torn.json").write_text("{not json", encoding="utf-8")
    assert read_blackbox(str(tmp_path / "torn.json")) is None


def test_blackbox_rides_the_atomic_writer(tmp_path):
    """The black box goes through the store's atomic_write (tmp + rename):
    a reader never sees a half-written file and no tmp litter survives."""
    rec = FlightRecorder(capacity=8)
    rec.enabled = True
    rec.record("mesh.worker.spawn", shard=0, pid=1)
    path = str(tmp_path / "bb.json")
    write_blackbox(path, rec)
    payload = read_blackbox(path)
    assert payload is not None
    assert payload["events"][-1]["event"] == "mesh.worker.spawn"
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]

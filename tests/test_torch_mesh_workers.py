"""Worker supervision, crash recovery and controller policy of the port's
``MeshFarm(mesh_backend="process")``: twins of tests/test_mesh_workers.py
and tests/test_mesh_workers_smoke.py on the CPU (``device="cpu"``), over
the pickle transport (no ``/dev/shm``), 2 shards, with a worker timeout
of 60 s so a hung worker cannot eat the suite's time.

The crash tests use ``inject_worker_fault`` (the worker SIGKILLs itself,
indistinguishable from an external kill -9) and pin the recovery
contract: the mesh keeps serving, the in-flight docs land in quarantine
under ``WorkerCrashError`` (kind "worker_crash"), and after
``release_quarantine`` and re-delivery the recovered docs converge to the
inline oracle (the respawned worker was re-hydrated from the controller's
delivery log). The spawn-safety, no-CPU-fallback and transport-resolution
contracts ride along.
"""
import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from automerge_tpu_torch.errors import WorkerCrashError, error_kind
from automerge_tpu_torch.obs.flight import enabled_flight, load_jsonl
from automerge_tpu_torch.opset import OpSet
from automerge_tpu_torch.parallel.meshfarm import MeshFarm
from automerge_tpu_torch.parallel.workers import WorkerHandle
from test_farm import Workload

ROOT = Path(__file__).resolve().parent.parent
NUM_DOCS = 8
NUM_SHARDS = 2
ROUNDS = 6
CRASH_ROUND = 2
TIMEOUT_S = 60.0


def _rounds(seed=3, rounds=ROUNDS):
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


def _drive_inline(deliveries):
    mesh = _mesh("inline")
    try:
        for buffers in deliveries:
            mesh.apply_changes([list(buffers) for _ in range(NUM_DOCS)])
        return _final_patches(mesh)
    finally:
        mesh.close()


def drive(backend, seed=7, rounds=5):
    """Every observable byte of one workload: per-round patches and
    outcome statuses, final patches, quarantine, the reconcile count."""
    mesh = _mesh(backend)
    gen = OpSet()
    w = Workload(seed)
    outs = []
    try:
        for _ in range(rounds):
            buffers = w.next_round(gen)
            if not buffers:
                continue
            res = mesh.apply_changes([list(buffers) for _ in range(NUM_DOCS)])
            outs.append([json.dumps(res[d], sort_keys=True)
                         for d in range(NUM_DOCS)])
            outs.append([o.status for o in res.outcomes])
        outs.append(_final_patches(mesh))
        outs.append(sorted(mesh.quarantine))
        outs.append(mesh.reconcile_actors())
        mesh.audit()
    finally:
        mesh.close()
    return outs


def test_process_backend_parity_and_clean_close():
    assert drive("inline") == drive("process")
    assert multiprocessing.active_children() == []


def test_worker_crash_mid_delivery_recovers_to_oracle():
    deliveries = _rounds()
    oracle = _drive_inline(deliveries)
    mesh = _mesh("process")
    try:
        for r, buffers in enumerate(deliveries):
            per_doc = [list(buffers) for _ in range(NUM_DOCS)]
            if r == CRASH_ROUND:
                mesh.inject_worker_fault(1, when="next_apply")
            res = mesh.apply_changes(per_doc)
            if r != CRASH_ROUND:
                assert not res.quarantined
                continue
            q = res.quarantined
            assert sorted(q) == sorted(
                d for d in range(NUM_DOCS) if mesh.shard_of(d) == 1)
            for outcome in q.values():
                assert isinstance(outcome.error, WorkerCrashError)
                assert error_kind(outcome.error) == "worker_crash"
            assert set(q) == set(mesh.quarantine)
            for d in range(NUM_DOCS):
                if d not in q:
                    assert res.outcomes[d].status == "applied"
            assert sorted(mesh.release_quarantine()) == sorted(q)
            redo = [per_doc[d] if d in q else [] for d in range(NUM_DOCS)]
            redo_res = mesh.apply_changes(redo)
            assert all(o.status == "applied" for o in redo_res.outcomes)
        assert _final_patches(mesh) == oracle
        mesh.audit()
    finally:
        mesh.close()
    assert multiprocessing.active_children() == []


def test_heartbeat_detects_and_respawns_dead_worker():
    mesh = _mesh("process", num_docs=4)
    try:
        assert mesh.heartbeat() == {0: "ok", 1: "ok"}
        mesh.inject_worker_fault(0, when="now")
        deadline = time.monotonic() + 10.0
        while mesh._handles[0].alive and time.monotonic() < deadline:
            time.sleep(0.05)
        assert mesh.heartbeat() == {0: "respawned", 1: "ok"}
        assert mesh.heartbeat() == {0: "ok", 1: "ok"}
    finally:
        mesh.close()
    assert multiprocessing.active_children() == []


def test_worker_crash_flight_dump_contains_blackbox_forensics(tmp_path):
    """SIGKILL a worker mid-delivery with the flight plane on: the
    controller's ``mesh.worker.crash`` auto-dump holds the dead worker's
    shard-tagged pre-crash events (shipped live, topped up from its black
    box) before the crash entry and its forensic fields."""
    deliveries = _rounds(rounds=2)
    with enabled_flight(dump_dir=str(tmp_path)) as rec:
        rec.clear()
        mesh = _mesh("process")
        try:
            mesh.apply_changes([list(deliveries[0]) for _ in range(NUM_DOCS)])
            assert any(e.get("shard") == 1 for e in rec.snapshot()), \
                "round 0 shipped no shard-1 worker events"
            # the worker flushes its black box after sending the result;
            # a heartbeat round trip sequences behind that flush
            assert mesh.heartbeat() == {0: "ok", 1: "ok"}
            bb_path = mesh._handles[1].spec["blackbox_path"]
            assert os.path.exists(bb_path), "worker wrote no black box"
            mesh.inject_worker_fault(1, when="next_apply")
            res = mesh.apply_changes(
                [list(deliveries[1]) for _ in range(NUM_DOCS)])
            assert res.quarantined
        finally:
            mesh.close()
        assert not os.path.exists(bb_path), "close() left the black box"
    assert multiprocessing.active_children() == []
    assert rec.dump_paths, "the crash did not auto-dump the timeline"
    events = load_jsonl(Path(rec.dump_paths[-1]).read_text(encoding="utf-8"))
    crashes = [e for e in events if e["event"] == "mesh.worker.crash"]
    assert crashes, [e["event"] for e in events]
    fields = crashes[-1]["fields"]
    assert fields["shard"] == 1
    assert isinstance(fields["pid"], int) and fields["pid"] > 0
    assert fields["phase"] == "apply"
    assert "heartbeat_age_s" in fields
    assert fields["blackbox"] == bb_path
    assert fields["blackbox_events"] >= 0
    worker_events = [e for e in events
                     if e.get("shard") == 1
                     and e["event"] != "mesh.worker.crash"]
    assert worker_events, "no shard-1 pre-crash events in the crash dump"
    assert events.index(worker_events[0]) < events.index(crashes[-1])
    # the inline backend on the same rounds records an untagged timeline
    with enabled_flight() as rec2:
        rec2.clear()
        _drive_inline(deliveries)
        assert all("shard" not in e for e in rec2.snapshot())


def test_dispatch_shards_reraises_first_shard_error_after_draining(
        monkeypatch):
    """A mid-dispatch shard exception neither deadlocks the pool nor
    abandons other shards' results, and the FIRST failing shard (lowest
    id) surfaces with its id attached."""
    monkeypatch.setenv("AM_MESH_CONCURRENCY", "4")
    mesh = MeshFarm(9, num_shards=3, capacity=16, mesh_backend="inline",
                    device="cpu")
    monkeypatch.delenv("AM_MESH_CONCURRENCY")
    try:
        assert mesh._executor is not None
        done = []

        def fn(s):
            done.append(s)
            if s in (1, 2):
                raise RuntimeError(f"boom shard {s}")
            return s * 10

        with pytest.raises(RuntimeError) as ei:
            mesh._dispatch_shards([0, 1, 2], fn)
        assert ei.value.shard == 1
        assert ei.value.args[0].startswith("[shard 1]")
        assert sorted(done) == [0, 1, 2]  # every future drained

        mesh._executor.shutdown(wait=True)
        mesh._executor = None
        done.clear()
        with pytest.raises(RuntimeError) as ei:
            mesh._dispatch_shards([0, 1, 2], fn)
        assert ei.value.shard == 1
        assert ei.value.args[0].startswith("[shard 1]")
        assert sorted(done) == [0, 1, 2]
    finally:
        mesh.close()


def test_mesh_transport_resolution(monkeypatch):
    """``mesh_transport=None`` reads AM_MESH_TRANSPORT; non-process
    backends always resolve to pickle; an unknown value is an API-usage
    error."""
    monkeypatch.setenv("AM_MESH_TRANSPORT", "pickle")
    mesh = MeshFarm(4, num_shards=NUM_SHARDS, capacity=16,
                    mesh_backend="process", worker_timeout=TIMEOUT_S,
                    device="cpu")
    try:
        assert mesh.transport == "pickle"
        assert mesh._rings == []  # pickle mode maps no rings
    finally:
        mesh.close()
    inline = MeshFarm(4, num_shards=NUM_SHARDS, capacity=16,
                      mesh_backend="inline", mesh_transport="shm",
                      device="cpu")
    try:
        assert inline.transport == "pickle"
    finally:
        inline.close()
    with pytest.raises(ValueError):
        MeshFarm(4, num_shards=NUM_SHARDS, capacity=16,
                 mesh_backend="inline", mesh_transport="bogus", device="cpu")
    assert multiprocessing.active_children() == []


def test_rebalance_policy_hook_is_called_on_interval():
    calls = []
    mesh = _mesh("inline", rebalance_policy=calls.append,
                 rebalance_interval=2)
    try:
        gen = OpSet()
        w = Workload(9)
        applied = 0
        while applied < 4:
            buffers = w.next_round(gen)
            if not buffers:
                continue
            mesh.apply_changes([list(buffers) for _ in range(NUM_DOCS)])
            applied += 1
        assert calls == [mesh, mesh]
    finally:
        mesh.close()


def test_workers_module_imports_without_torch():
    """Spawn safety: importing the worker module loads neither torch, jax
    nor the farm (the heavy imports happen inside ``_worker_main``)."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; import automerge_tpu_torch.parallel.workers; "
         "bad = [m for m in ('torch', 'jax', 'automerge_tpu_torch.tpu.farm',"
         " 'automerge_tpu_torch.parallel.meshfarm') if m in sys.modules]; "
         "assert not bad, bad"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_cpu_farm_stands_in_for_the_card():
    """The mesh and its workers default to the card and raise without one:
    the controller before it spawns anything, a worker through the
    readiness barrier (its farm's own error, shipped home)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshFarm(4, num_shards=NUM_SHARDS, capacity=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshFarm(4, num_shards=NUM_SHARDS, capacity=16,
                 mesh_backend="process", mesh_transport="pickle")
    spec = dict(shard=0, num_docs=2, capacity=16, quarantine_threshold=3,
                page_size=None, device="cuda", epoch=0, blackbox_path=None,
                warm_buffers=None, store_dir=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerHandle(spec, timeout=TIMEOUT_S)
    assert multiprocessing.active_children() == []

"""Phase 19's steps (``chip_smoke.run_mesh_*``) and phase 4's mesh on
the CPU at a small size: 32 docs over 2 process workers (``device="cpu"``,
the pickle transport: no ``/dev/shm`` here), 2 rounds of one 16-op change
per doc, the same change stream for every doc. The steps run once (a
module fixture) and the tests read what each found; the phase's own
checks raise inside those functions, so a passing fixture is most of the
contract. The first mesh is also held against the JAX package's
``MeshFarm`` on the same stream.
"""
import json
import multiprocessing
import shutil
import tempfile

import pytest

import chip_smoke
from automerge_tpu.parallel import MeshFarm as JaxMeshFarm

DOCS, SHARDS, ROUNDS, OPS = 32, 2, 2, 16
CATCHUP_DOCS = 8


@pytest.fixture(scope="module")
def phase19():
    """Steps (a)-(e) of phase 19 at the small size, as ``run_mesh_phase``
    runs them: returns what each step reported."""
    with chip_smoke.counting_fallbacks():
        mesh, stream, st = chip_smoke.run_mesh_throughput(
            "cpu", DOCS, SHARDS, ROUNDS, OPS, 0, transport="pickle")
        try:
            results = st.pop("results")
            want = [[chip_smoke.canon(res[d]) for d in range(DOCS)]
                    for res in results]
            root = tempfile.mkdtemp(prefix="mesh-smoke-flight-")
            try:
                ps = chip_smoke.run_mesh_parity(
                    "cpu", DOCS, SHARDS, stream, ROUNDS, st["capacity"],
                    want, root)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            with chip_smoke.recorded_bloom_launches() as (build, query):
                sweeps, _ = chip_smoke.run_mesh_catchup(
                    "cpu", mesh, CATCHUP_DOCS, st["capacity"],
                    lambda _msg: None)
        finally:
            mesh.close()
    return {"stream": stream, "want": want, "a": st, "b": ps,
            "sweeps": sweeps, "build": build, "query": query}


def test_throughput_run_commits_every_change(phase19):
    st = phase19["a"]
    assert st["applied"] == DOCS * ROUNDS
    assert st["total_ops"] == DOCS * ROUNDS * OPS
    traffic = st["traffic"]
    assert sum(t["docs"] for t in traffic.values()) == DOCS * ROUNDS
    assert all(t["dispatch_s"] > 0 for t in traffic.values())
    # the pickle transport carries the columns in payload frames
    assert all(t["payload_bytes"] > 0 and t["control_bytes"] >= 0
               and t["shm_bytes"] == 0 for t in traffic.values())
    assert st["rate"] > 0 and st["wall_scaling"] > 0 and st["cores"] >= 1
    assert "patch_assembly" in st["prof"].totals_by_path()


def test_pickle_and_inline_meshes_reproduce_the_first_run(phase19):
    ps = phase19["b"]
    assert ps["parity_s"] > 0
    src, dest = ps["migrated"]
    assert src != dest
    assert ps["reconcile"][1] == 0


def test_worker_crash_recovers_with_its_black_box(phase19):
    ps = phase19["b"]
    assert 0 < ps["lost"] < DOCS
    assert ps["worker_events"] > 0
    assert multiprocessing.active_children() == []


def test_catch_up_over_the_mesh_runs_both_bloom_programs(phase19):
    assert phase19["sweeps"][-1].moved == 0
    assert sum(sw.moved for sw in phase19["sweeps"]) > 0
    assert phase19["build"].shapes and phase19["query"].shapes


def test_mesh_matches_the_jax_mesh_on_the_stream(phase19):
    """The phase's stream through the JAX package's inline ``MeshFarm``:
    every round's patches equal the port mesh's."""
    jax_mesh = JaxMeshFarm(DOCS, num_shards=SHARDS,
                           capacity=(ROUNDS + 1) * OPS)
    for r, buf in enumerate(phase19["stream"][:ROUNDS]):
        got = jax_mesh.apply_changes([[buf]] * DOCS)
        assert [json.dumps(got[d], sort_keys=True)
                for d in range(DOCS)] == phase19["want"][r]


def test_phase4_mesh_inline_equals_process():
    records = {}
    for backend in ("inline", "process"):
        chip_smoke.run_mesh_small("cpu", backend, 0,
                                  records.setdefault(backend, []))
    docs, _, rounds, _ = chip_smoke.MESH_SMALL
    assert len(records["inline"]) == docs * rounds + docs + 1
    assert records["inline"] == records["process"]
    assert records["inline"][-1][1] == 0  # the second reconcile syncs 0
    assert multiprocessing.active_children() == []

"""chip_smoke.py's phase 21 runs on the CPU at a small size, each held
against the JAX package fed the same inputs: (a) the degradation curve at
32 docs against a ``TpuDocFarm`` taking the same deliveries (outcomes,
patches, quarantine causes), (b) shedding and release, (c) the
batch-isolated rejection, (d) the gate in both modes, (e) the batched have
filters and the sync sweep with malformed peers."""
import numpy as np
import pytest

import chip_smoke as c
from automerge_tpu import backend as JaxBackend
from automerge_tpu.obs.metrics import enabled_metrics as jax_enabled_metrics
from automerge_tpu.obs.metrics import get_metrics as jax_get_metrics
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu.tpu.sync_batch import batched_have_filters
from bench import _make_change_stream

DOCS = 32
SEED = 0


def jax_causes():
    return {name.rsplit(".", 1)[-1]: entry["value"]
            for name, entry in jax_get_metrics().as_dict().items()
            if name.startswith("farm.quarantine.causes.")}


def replay(farm, deliveries):
    """The JAX farm's record of the same deliveries, as `record_result`
    writes it."""
    rec = []
    for delivery in deliveries:
        c.record_result(rec, farm.apply_changes(delivery))
    return rec


@pytest.fixture(scope="module")
def clean():
    """The clean (0 %) run on the port at 32 docs and its patches."""
    farm, stats = c.run_faults("cpu", DOCS, 0, SEED)
    return farm, [c.canon(farm.get_patch(d)) for d in range(DOCS)], stats


def test_fault_stream_is_bench_streams_shape():
    assert c.fault_stream(c.FAULT_ROUNDS, c.FAULT_OPS, SEED) == \
        _make_change_stream(c.FAULT_ROUNDS, c.FAULT_OPS, SEED)


@pytest.mark.parametrize("pct", c.FAULT_PCTS)
def test_degradation_run_matches_jax(pct, clean):
    """Phase 21 (a) at 32 docs: the phase's checks hold on the CPU, and a
    JAX ``TpuDocFarm`` fed the same deliveries gives the same outcomes,
    patches and quarantine causes."""
    record = []
    farm, stats = c.run_faults("cpu", DOCS, pct, SEED, record=record)
    c.check_faults(farm, clean[0], clean[1], stats["poisoned"], "cpu",
                   f"{pct} %")
    assert len(stats["poisoned"]) == round(DOCS * pct / 100)
    assert stats["quarantined_deliveries"] == \
        len(stats["poisoned"]) * c.FAULT_ROUNDS
    jax = TpuDocFarm(DOCS, capacity=c.FAULT_ROUNDS * c.FAULT_OPS,
                     quarantine_threshold=None)
    before = jax_causes()
    with jax_enabled_metrics():
        want = replay(jax, stats["rounds"])
    causes = {k: v - before.get(k, 0) for k, v in jax_causes().items()
              if v != before.get(k, 0)}
    assert record == want
    assert stats["causes"] == causes
    for d in range(DOCS):
        assert farm.get_heads(d) == jax.get_heads(d)
        assert c.canon(farm.get_patch(d)) == c.canon(jax.get_patch(d))


def test_check_faults_reads_every_doc_past_the_patch_prefix(clean):
    """The phase's check reads the whole-doc patch of a prefix only, and
    every doc through heads, log, pages and the full readback: a poisoned
    doc passed off as healthy, or a healthy one as poisoned, fails it."""
    farm, stats = c.run_faults("cpu", DOCS, 25, SEED)
    poisoned = stats["poisoned"]
    assert c.check_faults(farm, clean[0], clean[1][:8], poisoned, "cpu",
                          "prefix") == (DOCS - len(poisoned)) * c.FAULT_ROUNDS
    with pytest.raises(RuntimeError, match="readback"):
        c.check_faults(farm, clean[0], clean[1][:8], poisoned[:-1], "cpu",
                       "poisoned as healthy")
    with pytest.raises(RuntimeError, match="holds rows"):
        c.check_faults(clean[0], clean[0], clean[1][:8], poisoned[-1:],
                       "cpu", "healthy as poisoned")


def test_shedding_and_release_match_jax(clean):
    record = []
    stats = c.run_shedding("cpu", DOCS, SEED, clean[0], clean[1],
                           record=record)
    jax = TpuDocFarm(DOCS, capacity=c.FAULT_ROUNDS * c.FAULT_OPS)
    want = replay(jax, stats["rounds"])
    released = sorted(jax.release_quarantine())
    want += replay(jax, [stats["catch_up"]])
    assert record == want
    assert released == [d for d in range(DOCS) if stats["catch_up"][d]]
    assert stats["counters"]["farm.quarantine.shed"] == \
        len(released) * (c.FAULT_ROUNDS - 3)


def test_batch_isolation_rejects_like_jax(clean):
    stream = clean[2]["stream"]
    k, err = c.run_batch_isolation(clean[0], stream, SEED)
    jax = TpuDocFarm(DOCS, capacity=c.FAULT_ROUNDS * c.FAULT_OPS,
                     quarantine_threshold=None)
    for buf in stream:
        jax.apply_changes([[buf]] * DOCS)
    delivery, k_jax = c.batch_delivery(DOCS, stream, SEED)
    before = [np.asarray(a) for a in jax._read_visibility()]
    with pytest.raises(ValueError) as exc_info:
        jax.apply_changes(delivery, isolation="batch")
    assert k == k_jax
    assert (type(err).__name__, str(err)) == (
        type(exc_info.value).__name__, str(exc_info.value))
    after = clean[0]._read_visibility()
    for a, b in zip(before, after):
        np.testing.assert_array_equal(np.asarray(a)[:, :b.shape[1]], b)


@pytest.mark.parametrize("mode", ["columnar", "oracle"])
def test_gate_deferral_matches_jax(mode):
    record = []
    c.run_gate("cpu", 8, SEED, mode, record)
    jax = TpuDocFarm(8, capacity=c.MAP_REPLICAS * c.MAP_CHANGES * c.MAP_OPS,
                     gate_mode=mode)
    want = replay(jax, c.gate_deliveries(8, SEED))
    want += [c.canon(jax.get_patch(d)) for d in range(8)]
    assert record == want


def test_have_filters_match_jax():
    record = []
    c.run_have_filters("cpu", 16, SEED, record)
    edits = c.make_edits(16, 2, c.MAP_CHANGES, c.MAP_OPS, SEED + 21)[1]
    backends = [JaxBackend.apply_changes(
        JaxBackend.init(), [edits[i][d] for i in range(c.MAP_CHANGES)])[0]
        for d in range(16)]
    from automerge_tpu.columnar import decode_change_meta_cached

    last_syncs = [JaxBackend.get_heads(backends[d]) if d % 8 == 7 else
                  [decode_change_meta_cached(edits[3][d])["hash"]]
                  if d % 2 else [] for d in range(16)]
    want = [h["bloom"] for h in batched_have_filters(backends, last_syncs)]
    assert record == want
    assert b"" in record


def test_bad_peers_converge_to_the_jax_farms_state():
    """The sweep's checks hold on the CPU (14 channels converge, 2
    rejected), and the server's docs equal a JAX farm holding both
    replicas' changes on the good channels and replica 0's alone on the
    malformed ones."""
    stats = c.run_bad_peers("cpu", 16, SEED, [])
    assert (stats["converged"], stats["rejected"]) == (14, 2)
    edits = c.make_edits(16, 2, c.MAP_CHANGES, c.MAP_OPS, SEED + 21)
    jax = TpuDocFarm(16, capacity=2 * c.MAP_CHANGES * c.MAP_OPS)
    jax.apply_changes([
        [edits[r][i][d] for r in ((0,) if d in c.SYNC_BAD else (0, 1))
         for i in range(c.MAP_CHANGES)] for d in range(16)])
    server = stats["server"]
    for d in range(16):
        assert sorted(server.get_heads(d)) == sorted(jax.get_heads(d))
        assert c.canon(server.get_patch(d)) == c.canon(jax.get_patch(d))

"""The columnar causal gate and its scalar ``gate_mode="oracle"`` chain, the
port against the JAX package: twins of every case of
tests/test_gate_vectorized.py. Each scenario runs a ``"columnar"`` and an
``"oracle"`` farm (and the reference walk) of one package, makes the JAX
test's assertions there, and records every patch as canonical JSON, the
routing metrics and the host caches; ``twin_pkgs`` holds the port's record
equal to the JAX package's. The delivered buffers are recorded too, so
both packages see the same inputs from the same seeds."""
import json

import pytest

import automerge_tpu
import automerge_tpu_torch
from test_farm import Workload, make_change
from test_torch_api_doc import PACKAGES
from test_torch_faults_domain import Pkg, twin_pkgs

SEEDS = [11, 23, 47]
ROUNDS = 10
CORPUS = ("truncated", "bit_flipped", "corrupt_checksum", "bad_chunk_type",
          "garbage")


def canon(patch):
    return json.dumps(patch, sort_keys=True)


def make_farms(P, num_docs, capacity=64):
    return tuple(P.farm(num_docs, capacity=capacity,
                        quarantine_threshold=None, gate_mode=mode)
                 for mode in ("columnar", "oracle"))


def set_change(actor, seq, start_op, deps, key, value, pred=()):
    ops = [{"action": "set", "obj": "_root", "key": key,
            "datatype": "uint", "value": value, "pred": list(pred)}]
    return make_change(actor, seq, start_op, deps, ops)


def assert_farm_state_equal(columnar, oracle, rec, context=""):
    """The observable state the two gate chains must agree on, recorded."""
    for d in range(columnar.num_docs):
        assert columnar.get_heads(d) == oracle.get_heads(d), (context, d)
        assert columnar.get_missing_deps(d) == oracle.get_missing_deps(d), (
            context, d)
        assert canon(columnar.get_patch(d)) == canon(oracle.get_patch(d)), (
            f"{context}: whole-doc patch diverged for doc {d}")
        rec.value((columnar.get_heads(d), columnar.get_missing_deps(d),
                   canon(columnar.get_patch(d))))


def run_differential(P, rec, seed, num_docs=3, rounds=ROUNDS, deliver=None,
                     with_oracle_walk=True):
    """One workload through a columnar farm, an oracle farm and per-doc
    walks of package P, asserting canonical patch equality per delivery
    and recording every delivery and patch."""
    columnar, oracle = make_farms(P, num_docs)
    walks = [P.OpSet() for _ in range(num_docs)]
    workload = Workload(seed)
    for r in range(rounds):
        buffers = workload.next_round(walks[0])
        if not buffers:
            continue
        per_doc = [list(buffers) for _ in range(num_docs)]
        if deliver is not None:
            per_doc = deliver(P, r, per_doc)
        got_c = columnar.apply_changes([list(b) for b in per_doc])
        got_o = oracle.apply_changes([list(b) for b in per_doc])
        rec.value([[bytes(b) for b in bufs] for bufs in per_doc])
        rec.value([(o.status, o.error_kind) for o in got_c.outcomes])
        for d in range(num_docs):
            assert canon(got_c[d]) == canon(got_o[d]), (
                f"seed={seed} round={r} doc={d}: columnar diverged from "
                f"the scalar gate")
            if with_oracle_walk:
                want = walks[d].apply_changes(list(per_doc[d]))
                assert canon(got_c[d]) == canon(want)
            rec.value(canon(got_c[d]))
    assert_farm_state_equal(columnar, oracle, rec, f"seed={seed}")
    if with_oracle_walk:
        for d in range(num_docs):
            assert canon(columnar.get_patch(d)) == canon(walks[d].get_patch())
    return columnar, oracle


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_corpus_gate_parity(seed, monkeypatch):
    twin_pkgs(lambda P, rec: run_differential(P, rec, seed), monkeypatch)


@pytest.mark.parametrize("name", CORPUS)
def test_byte_corpus_quarantine_parity(name, monkeypatch):
    poison_round, poison_doc = 3, 1

    def deliver(P, r, per_doc):
        corrupt = next(c for c in P.faults.BYTE_CORPUS if c[0] == name)[1]
        if r == poison_round and per_doc[poison_doc]:
            per_doc[poison_doc] = [bytes(corrupt(buf))
                                   for buf in per_doc[poison_doc]]
        return per_doc

    twin_pkgs(lambda P, rec: run_differential(
        P, rec, 7, deliver=deliver, with_oracle_walk=False), monkeypatch)


def test_mid_gate_deferral_ready_next_delivery(monkeypatch):
    def scenario(P, rec):
        buf_a, h_a = set_change("aaaaaaaa", 1, 1, [], "x", 1)
        buf_b, _ = set_change("aaaaaaaa", 2, 2, [h_a], "x", 2,
                              pred=["1@aaaaaaaa"])
        columnar, oracle = make_farms(P, 1)
        walk = P.OpSet()
        want_defer = walk.apply_changes([buf_b])
        (got_c,) = columnar.apply_changes([[buf_b]])
        (got_o,) = oracle.apply_changes([[buf_b]])
        assert canon(got_c) == canon(got_o) == canon(want_defer)
        assert columnar.get_missing_deps(0) == [h_a]
        rec.value(canon(got_c))
        want_both = walk.apply_changes([buf_a])
        (got_c,) = columnar.apply_changes([[buf_a]])
        (got_o,) = oracle.apply_changes([[buf_a]])
        assert canon(got_c) == canon(got_o) == canon(want_both)
        assert columnar.get_missing_deps(0) == []
        rec.value(canon(got_c))
        assert_farm_state_equal(columnar, oracle, rec, "deferral")

    twin_pkgs(scenario, monkeypatch)


def test_deferral_across_interleaved_deliveries(monkeypatch):
    def scenario(P, rec):
        buf_a, h_a = set_change("aaaaaaaa", 1, 1, [], "x", 1)
        buf_b, h_b = set_change("bbbbbbbb", 1, 2, [h_a], "y", 2)
        buf_c, _ = set_change("bbbbbbbb", 2, 3, [h_b], "y", 3,
                              pred=["2@bbbbbbbb"])
        columnar, oracle = make_farms(P, 1)
        walk = P.OpSet()
        for delivery in ([buf_b, buf_c], [buf_a]):
            want = walk.apply_changes(list(delivery))
            (got_c,) = columnar.apply_changes([list(delivery)])
            (got_o,) = oracle.apply_changes([list(delivery)])
            assert canon(got_c) == canon(got_o) == canon(want)
            rec.value(canon(got_c))
        assert_farm_state_equal(columnar, oracle, rec, "partial deferral")

    twin_pkgs(scenario, monkeypatch)


def test_device_fault_fallback_parity(monkeypatch):
    def run(P, mode):
        farm = P.farm(3, capacity=64, quarantine_threshold=None,
                      gate_mode=mode)
        walks = [P.OpSet() for _ in range(3)]
        workload = Workload(13)
        out = []
        for r in range(ROUNDS):
            buffers = workload.next_round(walks[0])
            if not buffers:
                continue
            per_doc = [list(buffers) for _ in range(3)]
            if r == 4:
                with P.faults.inject("farm.device_dispatch",
                                     P.faults.fail_docs([2])):
                    patches = farm.apply_changes(per_doc)
            else:
                patches = farm.apply_changes(per_doc)
            out.append([canon(p) for p in patches])
            out.append([(o.status, o.error_kind, o.fallback)
                        for o in patches.outcomes])
        out.append([canon(farm.get_patch(d)) for d in range(3)])
        return out

    def scenario(P, rec):
        columnar = run(P, "columnar")
        assert columnar == run(P, "oracle")
        rec.value(columnar)

    twin_pkgs(scenario, monkeypatch)


def _metric_state(reg):
    """Metric snapshot minus the chain-routing counters themselves and the
    counters of process-global caches (decode LRU, compile caches). An
    instrument reading 0 is left out: the farm makes some instruments
    lazily (``farm.quarantine.causes.<kind>``), so whether a reset one is
    there depends on what ran earlier in the process, and a missing one
    reads as 0, as ``metric_values`` reads it."""
    skip = {
        "farm.gate.vector_changes", "farm.gate.oracle_docs",
        "farm.transcode.oracle_docs", "farm.patch.device_columns",
    }
    out = {}
    for name, snap in reg.as_dict().items():
        if name in skip or snap["type"] == "histogram":
            continue
        if "decode" in name or "jit" in name or name.startswith("codecs."):
            continue
        if snap["value"] != 0:
            out[name] = snap["value"]
    return out


def _cache_state(farm):
    """The row mirror, the visibility cache and the queue."""
    state = []
    for d in range(farm.num_docs):
        state.append((
            farm._vis_mkey[d].tolist(),
            farm._vis_visible[d].tolist(),
            farm._vis_total[d].tolist(),
            sorted(farm._vis_stale[d]),
            bool(farm._vis_all_stale[d]),
            [c["hash"] for c in farm.queue[d]],
        ))
    return state


def _reroute_scenario(P, rec):
    buf_a, h_a = set_change("aaaaaaaa", 1, 1, [], "x", 1)
    buf_b, _ = set_change("aaaaaaaa", 2, 2, [h_a], "y", 2)

    def run(mode):
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            farm = P.farm(1, capacity=32, quarantine_threshold=None,
                          gate_mode=mode)
            (p1,) = farm.apply_changes([[buf_a]])
            (p2,) = farm.apply_changes([[buf_b, buf_b]])
        return farm, [canon(p1), canon(p2)], _metric_state(reg)

    farm_c, patches_c, metrics_c = run("columnar")
    farm_o, patches_o, metrics_o = run("oracle")
    assert patches_c == patches_o
    assert metrics_c == metrics_o
    assert _cache_state(farm_c) == _cache_state(farm_o)
    assert_farm_state_equal(farm_c, farm_o, rec, "dup re-route")
    rec.value(patches_c)
    rec.value({k: v for k, v in metrics_c.items()
               if k.startswith(("farm.", "sync."))})
    rec.value(_cache_state(farm_c))


def test_oracle_reroute_matches_scalar_only_run(monkeypatch):
    """Besides the JAX test's checks, the farm metrics that both packages
    keep (the port's registry also holds kernel and engine counters of its
    own) must agree between the packages."""
    twin_pkgs(_reroute_scenario, monkeypatch)


def test_oracle_reroute_twin_after_one_registry_made_the_cause(monkeypatch):
    """The twin above must not read the process's history: an earlier
    file in the same worker may have quarantined a doc for packing in one
    package only, so that package's registry already holds
    ``farm.quarantine.causes.packing`` when the scenario resets it. That
    state is made here: the cause is taken out of both registries, then
    created in the port's alone."""
    name = "farm.quarantine.causes.packing"
    for P in map(Pkg, PACKAGES):
        monkeypatch.delitem(P.registry()._instruments, name, raising=False)
        monkeypatch.delitem(P.farm_mod._QUARANTINE_CAUSES, "packing",
                            raising=False)
    port = Pkg(automerge_tpu_torch)
    monkeypatch.setitem(port.farm_mod._QUARANTINE_CAUSES, "packing",
                        port.registry().counter(name))
    assert name not in Pkg(automerge_tpu).registry().as_dict()
    twin_pkgs(_reroute_scenario, monkeypatch)


def test_seq_anomaly_reroutes_to_canonical_error(monkeypatch):
    def scenario(P, rec):
        buf_a, h_a = set_change("aaaaaaaa", 1, 1, [], "x", 1)
        buf_bad, _ = set_change("aaaaaaaa", 3, 2, [h_a], "y", 2)
        columnar, oracle = make_farms(P, 1)
        for farm in (columnar, oracle):
            farm.apply_changes([[buf_a]])
            result = farm.apply_changes([[buf_bad]])
            (o,) = result.outcomes
            assert o.status == "quarantined"
            assert o.error_kind == "causality"
            rec.value((o.status, type(o.error).__name__, str(o.error),
                       o.error_kind, tuple(o.offending_hashes)))
        assert_farm_state_equal(columnar, oracle, rec, "seq anomaly")

    twin_pkgs(scenario, monkeypatch)


def test_reroute_then_columnar_again(monkeypatch):
    def scenario(P, rec):
        buf_a, h_a = set_change("aaaaaaaa", 1, 1, [], "x", 1)
        buf_b, h_b = set_change("aaaaaaaa", 2, 2, [h_a], "y", 2)
        buf_c, _ = set_change("aaaaaaaa", 3, 3, [h_b], "z", 3)
        columnar, oracle = make_farms(P, 1)
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            for delivery in ([buf_a, buf_a], [buf_b], [buf_c]):
                (got_c,) = columnar.apply_changes([list(delivery)])
                (got_o,) = oracle.apply_changes([list(delivery)])
                assert canon(got_c) == canon(got_o)
                rec.value(canon(got_c))
        snap = reg.as_dict()
        assert snap["farm.gate.oracle_docs"]["value"] == 1
        assert snap["farm.gate.vector_changes"]["value"] == 2
        rec.value([snap[k]["value"] for k in (
            "farm.gate.oracle_docs", "farm.gate.vector_changes")])
        assert_farm_state_equal(columnar, oracle, rec, "re-route recovery")

    twin_pkgs(scenario, monkeypatch)


def test_rollback_scopes_mirror_invalidation(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(2, capacity=64, quarantine_threshold=None)
        walk = P.OpSet()
        deps, seq, start = [], 1, 1
        for r in range(6):
            buf, h = set_change("aaaaaaaa", seq, start, deps, f"k{r}", r)
            farm.apply_changes([[buf], [buf]])
            walk.apply_changes([buf])
            deps, seq, start = [h], seq + 1, start + 1
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            buf_bad, _ = set_change("aaaaaaaa", seq, start, deps, "k6", 99)
            with P.faults.inject("farm.device_dispatch",
                                 P.faults.fail_docs([0])):
                result = farm.apply_changes([[buf_bad], [buf_bad]])
            assert result.outcomes[0].status == "quarantined"
            rec.value(_cache_state(farm))
            reg.reset()
            buf_ok, _ = set_change("aaaaaaaa", seq, start, deps, "k7", 7)
            got = farm.apply_changes([[buf_ok], []])[0]
        want = walk.apply_changes([buf_ok])
        assert canon(got) == canon(want)
        rows = reg.as_dict()["farm.readback.rows"]["value"]
        assert rows <= 2, f"the recovery readback transferred {rows} rows"
        assert canon(farm.get_patch(0)) == canon(walk.get_patch())
        rec.value((canon(got), rows, canon(farm.get_patch(0))))

    twin_pkgs(scenario, monkeypatch)


def test_gate_verdict_columns_order_matches_append_order(monkeypatch):
    def scenario(P, rec):
        bufs, deps, hashes = [], [], []
        seq, start = 1, 1
        for i in range(5):
            buf, h = set_change("aaaaaaaa", seq, start, deps, "x", i,
                                pred=[f"{start - 1}@aaaaaaaa"] if i else ())
            bufs.append(buf)
            deps, seq, start = [h], seq + 1, start + 1
            hashes.append(h)
        shuffled = [bufs[3], bufs[0], bufs[4], bufs[2], bufs[1]]
        columnar, oracle = make_farms(P, 1)
        walk = P.OpSet()
        want = walk.apply_changes(list(shuffled))
        (got_c,) = columnar.apply_changes([list(shuffled)])
        (got_o,) = oracle.apply_changes([list(shuffled)])
        assert canon(got_c) == canon(got_o) == canon(want)
        assert columnar.get_heads(0) == oracle.get_heads(0) == [hashes[-1]]
        rec.value(canon(got_c))
        rec.changes(columnar.get_all_changes(0))
        rec.changes(oracle.get_all_changes(0))

    twin_pkgs(scenario, monkeypatch)

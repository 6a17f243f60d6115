"""The incremental visibility readback and the vectorised patch assembly
under rollback and fallback, the port against the JAX package: twins of
tests/test_parity_incremental.py (its ``test_mirror_matches_device_state``
cases are twinned in test_torch_readback.py). Each scenario drives one
package's farm beside its reference walk, makes the JAX test's assertions
there, and records every delivery and every patch as canonical JSON;
``twin_pkgs`` holds the port's record equal to the JAX package's."""
import json

import pytest

from test_farm import Workload
from test_torch_faults_domain import twin_pkgs

SEEDS = [11, 23, 47]
ROUNDS = 10
CORPUS = ("truncated", "bit_flipped", "corrupt_checksum", "bad_chunk_type",
          "garbage")


def canon(patch):
    return json.dumps(patch, sort_keys=True)


def assert_patch_equal(rec, got, want, context=""):
    assert canon(got) == canon(want), f"{context}: patch diverged"
    rec.value(canon(got))


def run_workload(P, rec, seed, num_docs=3, rounds=ROUNDS, deliver=None):
    farm = P.farm(num_docs, capacity=64, quarantine_threshold=None)
    oracles = [P.OpSet() for _ in range(num_docs)]
    workload = Workload(seed)
    for r in range(rounds):
        buffers = workload.next_round(oracles[0])
        if not buffers:
            continue
        per_doc = [list(buffers) for _ in range(num_docs)]
        if deliver is not None:
            per_doc = deliver(r, per_doc)
        rec.changes(buffers)
        patches = farm.apply_changes(per_doc)
        for d in range(num_docs):
            want = oracles[d].apply_changes(list(per_doc[d]))
            assert_patch_equal(rec, patches[d], want,
                               f"seed={seed} round={r} doc={d}")
    for d in range(num_docs):
        assert_patch_equal(rec, farm.get_patch(d), oracles[d].get_patch(),
                           f"seed={seed} whole-doc doc={d}")
    return farm


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_corpus_patch_parity(seed, monkeypatch):
    twin_pkgs(lambda P, rec: run_workload(P, rec, seed), monkeypatch)


@pytest.mark.parametrize("name", CORPUS)
def test_quarantine_rollback_keeps_parity(name, monkeypatch):
    poison_round, poison_doc, num_docs = 3, 1, 3

    def scenario(P, rec):
        corrupt = next(c for c in P.faults.BYTE_CORPUS if c[0] == name)[1]
        farm = P.farm(num_docs, capacity=64, quarantine_threshold=None)
        oracles = [P.OpSet() for _ in range(num_docs)]
        workload = Workload(7)
        saw_quarantine = False
        for r in range(ROUNDS):
            buffers = workload.next_round(oracles[0])
            if not buffers:
                continue
            per_doc = [list(buffers) for _ in range(num_docs)]
            if r == poison_round and per_doc[poison_doc]:
                per_doc[poison_doc] = [bytes(corrupt(buf))
                                       for buf in per_doc[poison_doc]]
            rec.value([[bytes(b) for b in bufs] for bufs in per_doc])
            patches = farm.apply_changes(per_doc)
            rec.value([(o.status, o.error_kind) for o in patches.outcomes])
            for d in range(num_docs):
                if patches.outcomes[d].status == "quarantined":
                    saw_quarantine = True
                    assert d == poison_doc and r == poison_round
                    rec.value(canon(patches[d]))
                    continue
                want = oracles[d].apply_changes(list(per_doc[d]))
                assert_patch_equal(rec, patches[d], want,
                                   f"{name} round={r} doc={d}")
        for d in range(num_docs):
            if d == poison_doc and saw_quarantine:
                rec.value(canon(farm.get_patch(d)))
                continue
            assert_patch_equal(rec, farm.get_patch(d), oracles[d].get_patch(),
                               name)

    twin_pkgs(scenario, monkeypatch)


def test_gate_rollback_mid_batch_keeps_parity(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(2, capacity=64, quarantine_threshold=None)
        oracle = P.OpSet()
        faults, col = P.faults, P.columnar
        a1 = faults.make_change("aa" * 4, 1, 1, [], [faults.set_op("k", 1)])
        farm.apply_changes([[a1], [a1]])
        oracle.apply_changes([a1])
        h1 = col.decode_change_columns(a1)["hash"]
        a2 = faults.make_change("aa" * 4, 2, 2, [h1], [faults.set_op("k", 2)])
        a2_dup_seq = faults.make_change(
            "aa" * 4, 2, 3, [col.decode_change_columns(a2)["hash"]],
            [faults.set_op("k", 3)])
        result = farm.apply_changes([[a2, a2_dup_seq], [a2]])
        assert result.outcomes[0].status == "quarantined"
        assert result.outcomes[1].status == "applied"
        o = result.outcomes[0]
        rec.value((o.error_kind, str(o.error), o.offending_hashes))
        want = oracle.apply_changes([a2])
        assert_patch_equal(rec, result[1], want, "doc 1 beside a rollback")
        pre = P.OpSet()
        pre.apply_changes([a1])
        assert_patch_equal(rec, farm.get_patch(0), pre.get_patch(),
                           "rolled-back doc")
        retry = farm.apply_changes([[a2], []])
        assert_patch_equal(rec, retry[0], want, "retry after rollback")

    twin_pkgs(scenario, monkeypatch)


def test_device_failure_fallback_interleaving_keeps_parity(monkeypatch):
    def scenario(P, rec):
        num_docs = 4
        farm = P.farm(num_docs, capacity=64, quarantine_threshold=None)
        oracles = [P.OpSet() for _ in range(num_docs)]
        workload = Workload(13)
        for r in range(ROUNDS):
            buffers = workload.next_round(oracles[0])
            if not buffers:
                continue
            per_doc = [list(buffers) for _ in range(num_docs)]
            rec.changes(buffers)
            if r == 4:
                with P.faults.inject("farm.device_dispatch",
                                     P.faults.fail_docs([2])):
                    patches = farm.apply_changes(per_doc)
            else:
                patches = farm.apply_changes(per_doc)
            rec.value([(o.status, o.error_kind, o.fallback)
                       for o in patches.outcomes])
            for d in range(num_docs):
                if patches.outcomes[d].status == "quarantined":
                    assert r == 4 and d == 2
                    continue
                want = oracles[d].apply_changes(list(per_doc[d]))
                assert_patch_equal(rec, patches[d], want, f"round={r} doc={d}")
        for d in range(num_docs):
            if d == 2:
                rec.value(canon(farm.get_patch(d)))
                continue
            assert_patch_equal(rec, farm.get_patch(d), oracles[d].get_patch(),
                               f"whole-doc {d}")
        rec.value(sorted(farm.degraded))

    twin_pkgs(scenario, monkeypatch)


def test_decode_cache_shares_parses_not_state(monkeypatch):
    """The hit and miss counts depend on what earlier tests left in each
    package's process-global LRU, so the record keeps the JAX test's
    bounds (held in both packages), not the counts."""
    def scenario(P, rec):
        num_docs = 8
        farm = P.farm(num_docs, capacity=32)
        oracles = [P.OpSet() for _ in range(num_docs)]
        a1 = P.faults.make_change("bb" * 4, 1, 1, [],
                                  [P.faults.set_op("x", 41)])
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            patches = farm.apply_changes([[a1]] * num_docs)
            for d in range(num_docs):
                want = oracles[d].apply_changes([a1])
                assert_patch_equal(rec, patches[d], want, f"fanout doc={d}")
            dup = farm.apply_changes([[a1]] * num_docs)
            for d in range(num_docs):
                want = oracles[d].apply_changes([a1])
                assert_patch_equal(rec, dup[d], want, f"duplicate doc={d}")
        hits = reg.counter("codecs.decode_cache.hits").value
        misses = reg.counter("codecs.decode_cache.misses").value
        assert hits >= 2 * num_docs - 1 - misses
        assert misses <= 1
        rec.value((hits + misses >= 2 * num_docs - 1, misses <= 1))

    twin_pkgs(scenario, monkeypatch)

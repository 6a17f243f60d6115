"""The per-document fault domains of the port's farm against the JAX
farm's, twins of tests/test_faults.py's farm classes (the 64-doc batch
with 8 poisoned docs, ``isolation="batch"``, the cause counters, state
equal to never poisoned, list-doc rollback, the quarantine lifecycle, the
degraded walk and the fault points). The taxonomy, the byte corpus and the
sync layer are in test_torch_faults_sync.py.

Each twin is the JAX test written once over a package namespace (``Pkg``)
and run through ``automerge_tpu`` and ``automerge_tpu_torch`` in turn
(``twin_pkgs``, over test_torch_api_doc's ``twin``). The scenario makes
the JAX test's assertions on each package and records what it observed:
outcomes (status, error class and message, kind, offending hashes,
fallback flag), patches and whole-document reads as canonical JSON, the
metrics the case reads in each package's own registry, page counts. The
two records must be equal: the tolerance is zero. A limit the JAX test
monkeypatches is patched in each package's own module.

``Pkg``, ``twin_pkgs`` and ``outcome`` serve the other twin files of the
fault-isolation layer too.
"""
import importlib

import pytest

from test_torch_api_doc import twin

#: module attribute -> submodule, the same in both packages
_MODULES = {
    "faults": "testing.faults", "errors": "errors", "rga": "tpu.rga",
    "metrics": "obs.metrics", "opset": "opset", "columnar": "columnar",
    "backend": "backend", "sync": "sync", "farm_mod": "tpu.farm",
    "engine": "tpu.engine", "transcode": "tpu.transcode",
    "paging": "tpu.paging", "sync_farm": "tpu.sync_farm",
    "sync_batch": "tpu.sync_batch", "decode": "tpu.decode",
    "codecs": "codecs", "flight": "obs.flight", "native": "native",
    "sync_session": "sync_session", "sync_v2": "sync_v2",
    "text_engine": "tpu.text_engine", "fingerprint": "tpu.fingerprint",
    "prof": "obs.prof", "profiling": "profiling", "obs_main": "obs.__main__",
}


class Pkg:
    """One package's modules under one set of names, so that a scenario is
    written once: ``P.farm(...)`` builds a ``TpuDocFarm`` or a CPU
    ``TorchDocFarm``, ``P.cpu`` is the device keyword the port's entry
    points need on the CPU (empty for JAX)."""

    def __init__(self, am):
        self.am = am
        self.is_port = am.__name__ == "automerge_tpu_torch"
        self.cpu = {"device": "cpu"} if self.is_port else {}
        for attr, name in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{am.__name__}.{name}"))
        self.Farm = (self.farm_mod.TorchDocFarm if self.is_port
                     else self.farm_mod.TpuDocFarm)
        self.OpSet = self.opset.OpSet

    def farm(self, *args, **kwargs):
        return self.Farm(*args, **kwargs, **self.cpu)

    def registry(self):
        return self.metrics.get_metrics()

    def healthy_change(self, actor, seq, start_op, deps=(), key="k", value=1):
        return self.faults.make_change(actor, seq, start_op, deps,
                                       [self.faults.set_op(key, value)])

    def change_hash(self, buf):
        return self.columnar.decode_change_columns(buf)["hash"]


def twin_pkgs(scenario, monkeypatch):
    """Runs ``scenario(P, rec)`` with ``P`` the JAX package's namespace,
    then the port's; the two records must be equal. Returns the port's."""
    return twin(lambda am, rec: scenario(Pkg(am), rec), monkeypatch)


def outcome(o):
    """A DocOutcome as comparable data: status, error class and message,
    kind, offending hashes, fallback flag."""
    return (o.status, type(o.error).__name__ if o.error else None,
            str(o.error) if o.error else None, o.error_kind,
            tuple(o.offending_hashes), o.fallback)


def record_result(rec, result):
    rec.value([outcome(o) for o in result.outcomes])
    for patch in result:
        rec.patch(patch)


def record_docs(rec, farm):
    """Every doc's whole-document read: heads, patch, committed log."""
    for d in range(farm.num_docs):
        rec.value(farm.get_heads(d))
        rec.patch(farm.get_patch(d))
        rec.changes(farm.get_all_changes(d))


def metric_values(P, names):
    snap = P.registry().as_dict()
    return {name: snap.get(name, {"value": 0})["value"] for name in names}


# ---------------------------------------------------------------------- #
# the acceptance batch: 64 docs, 8 poisoned, one call

N = 64


def _setup_farms(P, monkeypatch, threshold=None):
    monkeypatch.setattr(P.rga, "MAX_ELEMS", 4)
    farm = P.farm(N, capacity=64, quarantine_threshold=threshold)
    control = P.farm(N, capacity=64, quarantine_threshold=threshold)
    seeds = [P.healthy_change(f"{d:08x}", 1, 1, value=d) for d in range(N)]
    farm.apply_changes([[b] for b in seeds])
    control.apply_changes([[b] for b in seeds])
    heads = [farm.get_heads(d) for d in range(N)]
    return farm, control, seeds, heads


def _poison_delivery(P, heads):
    """Second-round delivery: 8 poisoned docs spanning every taxonomy
    bucket, 56 healthy. Returns (delivery, poison: doc -> expected)."""
    e, faults, rga = P.errors, P.faults, P.rga
    delivery = []
    poison = {
        1: e.ChecksumError, 9: e.ChecksumError,
        17: e.DecodeError, 25: e.DecodeError,
        33: e.CausalityError,
        41: e.PackingLimitError, 49: e.PackingLimitError,
        57: e.PackingLimitError,
    }
    for d in range(N):
        actor = f"{d:08x}"
        good = P.healthy_change(actor, 2, 2, heads[d], key="r2", value=d)
        if d in (1, 9):
            delivery.append([faults.corrupt_checksum(good)])
        elif d in (17, 25):
            delivery.append([faults.truncated(good)])
        elif d == 33:
            delivery.append([faults.seq_reused(actor, 1, 2, heads[d])])
        elif d in (41, 49):
            delivery.append([faults.counter_overflow(
                actor, 2, rga.MAX_COUNTER, heads[d])])
        elif d == 57:
            make_list = faults.make_change(
                actor, 2, 2, heads[d],
                [{"action": "makeList", "obj": "_root", "key": "l",
                  "pred": []}])
            flood = faults.insert_flood(
                actor, 3, 3, f"2@{actor}", rga.MAX_ELEMS + 1,
                [P.change_hash(make_list)])
            delivery.append([make_list, flood])
        else:
            delivery.append([good])
    return delivery, poison


def test_64_doc_batch_with_8_poisoned(monkeypatch):
    def scenario(P, rec):
        farm, control, _seeds, heads = _setup_farms(P, monkeypatch)
        delivery, poison = _poison_delivery(P, heads)
        for bufs in delivery:
            rec.changes(bufs)
        result = farm.apply_changes(delivery)
        expected = control.apply_changes(
            [[] if d in poison else delivery[d] for d in range(N)])
        for d in range(N):
            if d in poison:
                continue
            assert result.outcomes[d].status == "applied"
            assert result[d] == expected[d]
        assert set(result.quarantined) == set(poison)
        for d, expected_cls in poison.items():
            o = result.outcomes[d]
            assert o.status == "quarantined"
            assert isinstance(o.error, expected_cls), (d, o.error)
            assert o.error_kind == P.errors.error_kind(o.error)
            assert len(farm.get_all_changes(d)) == 1
            assert farm.get_heads(d) == heads[d]
            assert farm.get_patch(d) == control.get_patch(d)
        assert result.outcomes[33].offending_hashes
        assert result.outcomes[41].offending_hashes
        record_result(rec, result)
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


def test_batch_isolation_reproduces_all_or_nothing(monkeypatch):
    def scenario(P, rec):
        farm, _control, _seeds, heads = _setup_farms(P, monkeypatch)
        delivery, _poison = _poison_delivery(P, heads)
        committed = [len(farm.get_all_changes(d)) for d in range(N)]
        with pytest.raises(ValueError) as exc_info:
            farm.apply_changes(delivery, isolation="batch")
        assert [len(farm.get_all_changes(d)) for d in range(N)] == committed
        rec.value((type(exc_info.value).__name__, str(exc_info.value)))
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


def test_unknown_isolation_mode_rejected(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(1)
        with pytest.raises(ValueError, match="isolation") as exc_info:
            farm.apply_changes([[]], isolation="nope")
        rec.value((type(exc_info.value).__name__, str(exc_info.value)))

    twin_pkgs(scenario, monkeypatch)


CAUSES = ("farm.quarantine.causes.checksum", "farm.quarantine.causes.decode",
          "farm.quarantine.causes.causality", "farm.quarantine.causes.packing",
          "farm.prevalidation.aborts")


def test_quarantine_cause_counters(monkeypatch):
    def scenario(P, rec):
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            farm, _control, _seeds, heads = _setup_farms(P, monkeypatch)
            delivery, _poison = _poison_delivery(P, heads)
            farm.apply_changes(delivery)
        counts = metric_values(P, CAUSES)
        assert counts == {
            "farm.quarantine.causes.checksum": 2,
            "farm.quarantine.causes.decode": 2,
            "farm.quarantine.causes.causality": 1,
            "farm.quarantine.causes.packing": 3,
            "farm.prevalidation.aborts": 0,
        }
        rec.value(counts)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# error-path state invariance (property-style over the fault corpus)


def _fault_corpus_for(P, actor, seq, start_op, deps):
    """Poisoned second-round deliveries for one doc, spanning the corpus."""
    faults, rga = P.faults, P.rga
    good = faults.make_change(actor, seq, start_op, deps,
                              [faults.set_op("r2", 7)])
    return [
        ("truncated", [faults.truncated(good)]),
        ("bit_flipped", [faults.bit_flipped(good, bit=13)]),
        ("corrupt_checksum", [faults.corrupt_checksum(good)]),
        ("bad_chunk_type", [faults.bad_chunk_type(good)]),
        ("garbage", [faults.garbage(40, seed=3)]),
        ("seq_reuse", [faults.seq_reused(actor, seq - 1, start_op, deps)]),
        ("seq_skip", [faults.seq_skipped(actor, seq + 5, start_op, deps)]),
        ("counter_overflow",
         [faults.counter_overflow(actor, seq, rga.MAX_COUNTER, deps)]),
        ("mixed_good_then_poison",
         [good, faults.corrupt_checksum(
             faults.make_change(actor, seq + 1, start_op + 1,
                                [P.change_hash(good)],
                                [faults.set_op("r3", 8)]))]),
    ]


def test_quarantine_leaves_state_equal_to_never_poisoned(monkeypatch):
    def scenario(P, rec):
        seed = P.healthy_change("bbbbbbbb", 1, 1, value=3)
        seed_hash = P.change_hash(seed)
        for name, poisoned in _fault_corpus_for(P, "bbbbbbbb", 2, 2,
                                                [seed_hash]):
            farm = P.farm(2, capacity=32)
            control = P.farm(2, capacity=32)
            neighbour = P.healthy_change("aaaaaaaa", 1, 1, value=9)
            for f in (farm, control):
                f.apply_changes([[neighbour], [seed]])
            result = farm.apply_changes([[], poisoned])
            assert result.outcomes[1].status == "quarantined", name
            assert result.outcomes[0].status == "applied", name
            assert farm.get_heads(1) == control.get_heads(1), name
            assert farm.get_all_changes(1) == control.get_all_changes(1), name
            replica = P.OpSet()
            replica.apply_changes(farm.get_all_changes(1))
            saved = replica.save()
            reloaded = P.OpSet(saved)
            assert reloaded.heads == farm.get_heads(1), name
            assert reloaded.get_patch() == control.get_patch(1), name
            clean = P.healthy_change("bbbbbbbb", 2, 2, [seed_hash],
                                     key="after", value=11)
            got = farm.apply_changes([[], [clean]])
            want = control.apply_changes([[], [clean]])
            assert got[1] == want[1], name
            assert got.outcomes[1].status == "applied", name
            assert farm.get_patch(1) == control.get_patch(1), name
            rec.value(name)
            record_result(rec, result)
            rec.value(saved)
            record_result(rec, got)
            record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


def test_poisoned_list_doc_rolls_back_element_tables(monkeypatch):
    def scenario(P, rec):
        faults = P.faults
        limit = P.rga.MAX_ELEMS
        monkeypatch.setattr(P.rga, "MAX_ELEMS", 8)
        farm = P.farm(1, capacity=32)
        control = P.farm(1, capacity=32)
        mk = faults.make_change(
            "aaaaaaaa", 1, 1, [],
            [{"action": "makeList", "obj": "_root", "key": "l", "pred": []}])
        ins = faults.insert_flood("aaaaaaaa", 2, 2, "1@aaaaaaaa", 2,
                                  [P.change_hash(mk)])
        for f in (farm, control):
            f.apply_changes([[mk]])
            f.apply_changes([[ins]])
        deps = farm.get_heads(0)
        more = faults.insert_flood("aaaaaaaa", 3, 4, "1@aaaaaaaa", 3, deps)
        flood = faults.insert_flood("aaaaaaaa", 4, 7, "1@aaaaaaaa", 20,
                                    [P.change_hash(more)])
        result = farm.apply_changes([[more, flood]])
        assert result.outcomes[0].status == "quarantined"
        assert result.outcomes[0].error_kind == "packing"
        assert int(farm.num_elems[0]) == int(control.num_elems[0]) == 2
        record_result(rec, result)
        got = farm.apply_changes([[more]])
        want = control.apply_changes([[more]])
        assert got[0] == want[0]
        assert int(farm.num_elems[0]) == 5
        record_result(rec, got)
        rec.value(int(farm.num_elems[0]))
        # the rank refuses an element table wider than the patched limit:
        # whole-document reads run under the real one
        monkeypatch.setattr(P.rga, "MAX_ELEMS", limit)
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# quarantine lifecycle

LIFECYCLE = ("farm.quarantine.entered", "farm.quarantine.shed",
             "farm.quarantine.released", "farm.quarantine.active")


def test_threshold_shedding_and_release(monkeypatch):
    def scenario(P, rec):
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            farm = P.farm(2, capacity=32, quarantine_threshold=2)
            good = P.healthy_change("aaaaaaaa", 1, 1)
            bad = P.faults.garbage(32)
            first = farm.apply_changes([[bad], []])
            assert first.outcomes[0].status == "quarantined"
            assert 0 not in farm.quarantine
            second = farm.apply_changes([[bad], []])
            assert second.outcomes[0].status == "quarantined"
            assert 0 in farm.quarantine
            shed = farm.apply_changes([[good], []])
            assert isinstance(shed.outcomes[0].error,
                              P.errors.QuarantinedError)
            assert len(farm.get_all_changes(0)) == 0
            ok = farm.apply_changes([[], [good]])
            assert ok.outcomes[1].status == "applied"
            assert farm.release_quarantine(0) == [0]
            back = farm.apply_changes([[good], []])
            assert back.outcomes[0].status == "applied"
            assert len(farm.get_all_changes(0)) == 1
        counts = metric_values(P, LIFECYCLE)
        assert counts == {"farm.quarantine.entered": 1,
                          "farm.quarantine.shed": 1,
                          "farm.quarantine.released": 1,
                          "farm.quarantine.active": 0}
        for result in (first, second, shed, ok, back):
            record_result(rec, result)
        rec.value(counts)
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


def test_clean_delivery_resets_failure_streak(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(1, capacity=32, quarantine_threshold=2)
        bad = P.faults.garbage(32)
        farm.apply_changes([[bad]])
        assert farm.fault_counts[0] == 1
        rec.value(list(farm.fault_counts))
        farm.apply_changes([[P.healthy_change("aaaaaaaa", 1, 1)]])
        assert farm.fault_counts[0] == 0
        rec.value(list(farm.fault_counts))
        farm.apply_changes([[bad]])
        assert 0 not in farm.quarantine
        rec.value((list(farm.fault_counts), sorted(farm.quarantine)))

    twin_pkgs(scenario, monkeypatch)


def test_release_all(monkeypatch):
    def scenario(P, rec):
        farm = P.farm(3, capacity=32, quarantine_threshold=1)
        bad = P.faults.garbage(32)
        farm.apply_changes([[bad], [], [bad]])
        assert set(farm.quarantine) == {0, 2}
        released = sorted(farm.release_quarantine())
        assert released == [0, 2]
        assert farm.quarantine == {}
        rec.value(released)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# degraded mode: device-dispatch bisection + sequential fallback

DEGRADED = ("farm.bisect.rounds", "farm.fallback.calls", "farm.fallback.docs",
            "farm.quarantine.causes.device")


def _seeded(P, n):
    farm = P.farm(n, capacity=64, quarantine_threshold=None)
    control = P.farm(n, capacity=64, quarantine_threshold=None)
    seeds = [P.healthy_change(f"{d:08x}", 1, 1, value=d) for d in range(n)]
    farm.apply_changes([[b] for b in seeds])
    control.apply_changes([[b] for b in seeds])
    return farm, control


def test_bisect_isolates_poison_doc_and_survivors_get_patches(monkeypatch):
    def scenario(P, rec):
        reg = P.registry()
        reg.reset()
        farm, control = _seeded(P, 8)
        second = [P.healthy_change(f"{d:08x}", 2, 2, farm.get_heads(d),
                                   key="r2", value=d * 10) for d in range(8)]
        with P.metrics.enabled_metrics():
            with P.faults.inject("farm.device_dispatch",
                                 P.faults.fail_docs([3])):
                result = farm.apply_changes([[b] for b in second])
        assert result.outcomes[3].status == "quarantined"
        assert isinstance(result.outcomes[3].error, P.errors.DeviceFaultError)
        assert result.outcomes[3].error_kind == "device"
        assert len(farm.get_all_changes(3)) == 1
        expected = control.apply_changes(
            [[] if d == 3 else [second[d]] for d in range(8)])
        for d in range(8):
            if d == 3:
                continue
            assert result.outcomes[d].status == "applied"
            assert result.outcomes[d].fallback
            assert result[d] == expected[d]
        counts = metric_values(P, DEGRADED)
        assert counts["farm.bisect.rounds"] > 0
        assert counts["farm.fallback.calls"] == 1
        assert counts["farm.fallback.docs"] == 7
        assert counts["farm.quarantine.causes.device"] == 1
        record_result(rec, result)
        rec.value(counts)
        rec.value(sorted(farm.degraded))
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


def test_degraded_docs_keep_working_after_fallback(monkeypatch):
    def scenario(P, rec):
        farm, control = _seeded(P, 4)
        second = [P.healthy_change(f"{d:08x}", 2, 2, farm.get_heads(d),
                                   key="r2") for d in range(4)]
        with P.faults.inject("farm.device_dispatch", P.faults.fail_docs([2])):
            record_result(rec, farm.apply_changes([[b] for b in second]))
        control.apply_changes([[] if d == 2 else [second[d]]
                               for d in range(4)])
        third = [P.healthy_change(f"{d:08x}", 3, 3, farm.get_heads(d),
                                  key="r3") for d in range(4)]
        third[2] = P.healthy_change("00000002", 2, 2, farm.get_heads(2),
                                    key="r2")
        got = farm.apply_changes([[b] for b in third])
        want = control.apply_changes([[b] for b in third])
        for d in range(4):
            assert got.outcomes[d].status == "applied"
            assert got[d] == want[d]
            assert farm.get_patch(d) == control.get_patch(d)
        record_result(rec, got)
        rec.value(sorted(farm.degraded))
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


def test_wedged_device_serves_whole_batch_sequentially(monkeypatch):
    def scenario(P, rec):
        farm, control = _seeded(P, 4)
        second = [P.healthy_change(f"{d:08x}", 2, 2, farm.get_heads(d),
                                   key="r2") for d in range(4)]
        with P.faults.inject("farm.device_dispatch", P.faults.fail_always()):
            result = farm.apply_changes([[b] for b in second])
        expected = control.apply_changes([[b] for b in second])
        for d in range(4):
            assert result.outcomes[d].status == "applied"
            assert result.outcomes[d].fallback
            assert result[d] == expected[d]
        record_result(rec, result)
        record_docs(rec, farm)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# injection points in engine + opset atomicity


def test_engine_apply_batch_point_fires(monkeypatch):
    def scenario(P, rec):
        engine = P.engine.BatchedMapEngine(1, 8, **P.cpu)
        batch = P.transcode.BatchTranscoder().changes_to_batch(
            [[({"action": "set", "obj": "_root", "key": "k", "value": 1,
                "pred": []}, 1, "aaaaaaaa")]], **P.cpu)
        with P.faults.inject("engine.apply_batch", P.faults.fail_always()):
            with pytest.raises(RuntimeError, match="injected") as exc_info:
                engine.apply_batch(batch)
        rec.value((type(exc_info.value).__name__, str(exc_info.value)))
        engine.apply_batch(batch)  # hook removed on exit
        rec.value((int(engine.lengths[0]), engine.version))

    twin_pkgs(scenario, monkeypatch)


def test_inject_is_scoped(monkeypatch):
    def scenario(P, rec):
        fired = []
        with P.faults.inject("sync.receive_message",
                             lambda **kw: fired.append(1)):
            assert "sync.receive_message" in P.faults._HOOKS
        assert "sync.receive_message" not in P.faults._HOOKS
        rec.value(sorted(P.faults._HOOKS))

    twin_pkgs(scenario, monkeypatch)


def test_opset_apply_is_atomic_on_gate_failure(monkeypatch):
    def scenario(P, rec):
        opset = P.OpSet()
        opset.apply_changes([P.healthy_change("aaaaaaaa", 1, 1)])
        good = P.healthy_change("aaaaaaaa", 2, 2, opset.heads)
        poison = P.faults.seq_reused("aaaaaaaa", 1, 3, [P.change_hash(good)])
        before_index = dict(opset.change_index_by_hash)
        before_heads = list(opset.heads)
        with pytest.raises(P.errors.CausalityError) as exc_info:
            opset.apply_changes([good, poison])
        assert opset.change_index_by_hash == before_index
        assert opset.heads == before_heads
        patch = opset.apply_changes([good])
        assert patch["clock"]["aaaaaaaa"] == 2
        rec.value(str(exc_info.value))
        rec.patch(patch)

    twin_pkgs(scenario, monkeypatch)

"""The farm's, the engine's and sync's instruments in the port against the
JAX package's: twins of the seven cases of tests/test_obs.py that read
them (sequential and batched sync sharing instruments, the session
quarantine gauge after a mid-run reset, the farm's phases through the
``PhaseProfile`` shim, the farm and engine counts per call, pad waste
with uneven docs, gate deferrals and prevalidation aborts, the sync
round trip's counts).

Each scenario is the JAX test written once over a package namespace
(``Pkg``) and run through both packages (``twin_pkgs``). Each package
reads its own registry, reset and enabled under its own
``enabled_metrics``; the scenario makes the JAX test's assertions there
(``engine.device.dispatches == 6``, hits plus recompiles equal to the
dispatches) and records every count it read, so the two registries must
read the same counts. The tolerance is zero. The JAX case's
``recompiles >= 1`` is left out: it holds only in a process that has not
compiled these shapes before, which a file sharing its worker with
test_obs.py or test_torch_farm_smoke.py cannot promise."""
import pytest

import automerge_tpu
import automerge_tpu_torch
from test_torch_api_doc import PACKAGES
from test_torch_faults_domain import Pkg, metric_values, twin_pkgs


def _stream(P, rounds, ops, actor="aaaaaaaa", seed=0):
    return P.obs_main._change_stream(actor, rounds, ops, seed=seed)


def _counts(P, names):
    """The named instruments' values in `P`'s registry, in order, read by
    ``metric_values``: one this process has not created yet reads 0, as a
    freshly reset counter does. The farm makes each
    ``farm.quarantine.causes.<kind>`` counter at its first quarantine of
    that kind, so whether the name is there depends on what ran earlier
    in the process, not on the scenario."""
    values = metric_values(P, names)
    return [values[name] for name in names]


def test_sequential_and_batched_sync_share_instruments(monkeypatch):
    def scenario(P, rec):
        assert P.sync._M_MSGS_GEN is P.sync_farm._M_MSGS_GEN
        assert P.sync._M_BLOOM_PROBES is P.sync_farm._M_BLOOM_PROBES
        rec.value([P.sync._M_MSGS_GEN.name, P.sync._M_BLOOM_PROBES.name])

    twin_pkgs(scenario, monkeypatch)


def test_quarantine_gauge_consistent_with_counters_after_midrun_reset(
        monkeypatch):
    def scenario(P, rec):
        ss, reg = P.sync_session, P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            ss._M_CHQ_ENTERED.inc()
            ss._set_active_quarantined()
            assert ss._M_CHQ_ACTIVE.value == 1
            rec.value(ss._M_CHQ_ACTIVE.value)
            reg.reset()
            assert ss._M_CHQ_ENTERED.value == 0
            assert ss._M_CHQ_RELEASED.value == 0
            assert ss._M_CHQ_ACTIVE.value == 0
            ss._M_CHQ_RELEASED.inc()
            ss._set_active_quarantined()
            assert ss._M_CHQ_ACTIVE.value == 0
            assert ss._M_CHQ_ACTIVE.value == max(
                0, ss._M_CHQ_ENTERED.value - ss._M_CHQ_RELEASED.value)
            rec.value([ss._M_CHQ_ENTERED.value, ss._M_CHQ_RELEASED.value,
                       ss._M_CHQ_ACTIVE.value])
        reg.reset()

    twin_pkgs(scenario, monkeypatch)


#: the port's phases that the JAX farm's table does not have: the batched
#: parse inside decode, and the prevalidation between decode and walk
PORT_ONLY_PHASES = {"decode/decode_parse", "prevalidate"}


def test_farm_phases_flow_through_the_shim(monkeypatch):
    """The JAX package's paths, with their call counts, are recorded twin
    to twin; the port's paths beyond them must be `PORT_ONLY_PHASES`,
    each called once."""
    jax_paths = set()

    def scenario(P, rec):
        farm = P.farm(2, capacity=32)
        buf = _stream(P, 1, 4)[0]
        prof = P.profiling.PhaseProfile()
        with P.profiling.use_profile(prof):
            farm.apply_changes([[buf], [buf]])
        d = prof.as_dict()
        for phase in ("decode", "gate_verdicts", "transcode_columns",
                      "gate+transcode", "pack", "device_dispatch",
                      "visibility", "patch_assembly"):
            assert phase in d, phase
            assert d[phase]["calls"] == 1
        if P.is_port:
            extra = set(d) - jax_paths
            assert extra == PORT_ONLY_PHASES, extra
            assert all(d[path]["calls"] == 1 for path in extra)
        else:
            assert not PORT_ONLY_PHASES & set(d)
            jax_paths.update(d)
        rec.value(sorted((path, entry["calls"]) for path, entry in d.items()
                         if path in jax_paths))

    twin_pkgs(scenario, monkeypatch)


def test_farm_and_engine_metrics_count_real_work(monkeypatch):
    def scenario(P, rec):
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            farm = P.farm(5, capacity=96)
            for buf in _stream(P, 2, 4):
                farm.apply_changes([[buf]] * 5)
        assert reg.counter("farm.rows.transcoded").value == 40
        assert reg.counter("farm.rows.padding").value == 0
        assert reg.gauge("farm.pad_waste_ratio").value == 0.0
        assert reg.histogram("farm.batch.occupancy").count == 2
        assert reg.counter("farm.changes.applied").value == 10
        dispatches = reg.counter("engine.device.dispatches").value
        assert dispatches == 6
        hits = reg.counter("engine.jit.cache_hits").value
        recompiles = reg.counter("engine.jit.recompiles").value
        assert hits + recompiles == dispatches
        rec.value(_counts(P, [
            "farm.rows.transcoded", "farm.rows.padding",
            "farm.pad_waste_ratio", "farm.changes.applied",
            "engine.device.dispatches"]))
        rec.value(reg.histogram("farm.batch.occupancy").count)
        rec.value(hits + recompiles)

    twin_pkgs(scenario, monkeypatch)


def test_farm_pad_waste_with_uneven_docs(monkeypatch):
    def scenario(P, rec):
        reg = P.registry()
        names = ["farm.rows.transcoded", "farm.rows.padding",
                 "farm.pad_waste_ratio", "farm.pages.occupancy"]
        reg.reset()
        with P.metrics.enabled_metrics():
            farm = P.farm(2, capacity=32)
            buf = _stream(P, 1, 4)[0]
            farm.apply_changes([[buf], []])
        assert reg.counter("farm.rows.transcoded").value == 4
        assert reg.counter("farm.rows.padding").value == 0
        assert reg.gauge("farm.pad_waste_ratio").value == pytest.approx(0.0)
        rec.value(_counts(P, names))
        reg.reset()
        with P.metrics.enabled_metrics():
            farm = P.farm(2, capacity=32)
            b4 = _stream(P, 1, 4)[0]
            b1 = _stream(P, 1, 1, actor="bbbbbbbb")[0]
            farm.apply_changes([[b4], [b1]])
        assert reg.counter("farm.rows.transcoded").value == 5
        assert reg.counter("farm.rows.padding").value == 3
        assert reg.gauge("farm.pad_waste_ratio").value == pytest.approx(3 / 8)
        assert reg.gauge("farm.pages.occupancy").value > 0
        rec.value(_counts(P, names))

    twin_pkgs(scenario, monkeypatch)


def _gate_deferral_scenario(P, rec):
    reg = P.registry()
    names = ["farm.gate.deferrals", "farm.prevalidation.aborts",
             "farm.quarantine.causes.packing"]
    reg.reset()
    with P.metrics.enabled_metrics():
        farm = P.farm(1, capacity=32)
        stream = _stream(P, 2, 2)
        farm.apply_changes([[stream[1]]])
        assert reg.counter("farm.gate.deferrals").value == 1
        big = P.columnar.encode_change({
            "actor": "bbbbbbbb", "seq": 1, "startOp": 1 << 24,
            "time": 0, "deps": [],
            "ops": [{"action": "set", "obj": "_root", "key": "k",
                     "datatype": "uint", "value": 1, "pred": []}],
        })
        with pytest.raises(ValueError) as exc_info:
            farm.apply_changes([[big]], isolation="batch")
        assert reg.counter("farm.prevalidation.aborts").value == 1
        rec.value([type(exc_info.value).__name__, str(exc_info.value)])
        rec.value(_counts(P, names))
        farm.apply_changes([[big]])
        assert reg.counter("farm.quarantine.causes.packing").value == 1
        assert reg.counter("farm.prevalidation.aborts").value == 1
        rec.value(_counts(P, names))


def test_gate_deferral_and_prevalidation_abort_metrics(monkeypatch):
    twin_pkgs(_gate_deferral_scenario, monkeypatch)


def test_gate_deferral_twin_after_one_registry_made_the_cause(monkeypatch):
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
    twin_pkgs(_gate_deferral_scenario, monkeypatch)


def test_sync_round_trip_metrics(monkeypatch):
    def scenario(P, rec):
        B, S = P.backend, P.sync
        b1, b2 = B.init(), B.init()
        b1, _ = B.apply_changes(b1, _stream(P, 2, 4, actor="aaaaaaaa"))
        b2, _ = B.apply_changes(b2, _stream(P, 2, 4, actor="cccccccc", seed=7))
        reg = P.registry()
        reg.reset()
        with P.metrics.enabled_metrics():
            s1, s2 = S.init_sync_state(), S.init_sync_state()
            for _ in range(10):
                s1, m1 = S.generate_sync_message(b1, s1)
                if m1 is not None:
                    b2, s2, _ = S.receive_sync_message(b2, s2, m1)
                s2, m2 = S.generate_sync_message(b2, s2)
                if m2 is not None:
                    b1, s1, _ = S.receive_sync_message(b1, s1, m2)
                rec.changes([m for m in (m1, m2) if m is not None])
                if m1 is None and m2 is None:
                    break
        assert B.get_heads(b1) == B.get_heads(b2)
        gen = reg.counter("sync.messages.generated").value
        assert gen >= 2
        assert reg.counter("sync.messages.received").value == gen
        assert reg.counter("sync.bytes.sent").value == \
            reg.counter("sync.bytes.received").value > 0
        assert reg.counter("sync.changes.sent").value == \
            reg.counter("sync.changes.received").value == 4
        assert reg.counter("sync.bloom.probes").value > 0
        rec.value(_counts(P, [
            "sync.messages.generated", "sync.messages.received",
            "sync.bytes.sent", "sync.bytes.received", "sync.changes.sent",
            "sync.changes.received", "sync.bloom.probes"]))

    twin_pkgs(scenario, monkeypatch)

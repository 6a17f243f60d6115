"""The SLO engine of the port (``automerge_tpu_torch.obs.slo``), twins of
the JAX package's tests/test_slo.py: objective validation, log2-bucketed
latency compliance, availability and ratio objectives, multi-window burn
rates on a ManualClock, and the export of verdicts into gauges, the
exposition page and snapshot records."""
import pytest

from automerge_tpu_torch.obs.export import render_exposition, snapshot_record
from automerge_tpu_torch.obs.metrics import MetricsRegistry
from automerge_tpu_torch.obs.slo import (
    DEFAULT_WINDOWS,
    Objective,
    SLOEngine,
    availability_objective,
    default_mesh_slos,
    default_serve_slos,
    latency_objective,
    ratio_objective,
    render_verdicts,
    verdicts_ok,
)
from automerge_tpu_torch.testing.chaos import ManualClock


def _registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.enable()
    return reg


# ---------------------------------------------------------------------- #
# objective declaration

def test_objective_validation():
    with pytest.raises(ValueError, match="unknown SLO kind"):
        Objective("x", "throughput", "m")
    with pytest.raises(ValueError, match="needs budget_ms"):
        Objective("x", "latency", "m")
    with pytest.raises(ValueError, match="target"):
        Objective("x", "ratio", "m", target=0.0)
    with pytest.raises(ValueError, match="target"):
        Objective("x", "ratio", "m", target=1.5)
    # the helpers build valid frozen objectives
    o = latency_objective("lat", "rq.ms", 250.0, target=0.95)
    assert (o.kind, o.budget_ms, o.target) == ("latency", 250.0, 0.95)
    o = availability_objective("av", "good", ("bad1", "bad2"))
    assert o.bad_metrics == ("bad1", "bad2")
    assert ratio_objective("r", "g", 0.5).kind == "ratio"


# ---------------------------------------------------------------------- #
# the three compliance kinds

def test_latency_compliance_is_bucketed_on_the_log2_grid():
    """9 fast observations + 1 slow one against a 250 ms budget: the fast
    bucket's upper bound sits under the budget, the slow one's above, so
    compliance is exactly 0.9 — pass at target 0.9, breach at 0.99."""
    reg = _registry()
    hist = reg.histogram("rq.ms", "test latencies")
    for _ in range(9):
        hist.observe(1.0)
    hist.observe(1000.0)
    clock = ManualClock()
    eng = SLOEngine(
        [latency_objective("lat", "rq.ms", 250.0, target=0.9)],
        clock=clock, registry=reg,
    )
    v = eng.evaluate()[0]
    assert v["compliance"] == pytest.approx(0.9)
    assert v["ok"]
    strict = SLOEngine(
        [latency_objective("lat", "rq.ms", 250.0, target=0.99)],
        clock=clock, registry=reg,
    )
    assert not strict.evaluate()[0]["ok"]


def test_availability_compliance_over_good_and_bad_counters():
    reg = _registry()
    reg.counter("ok.count", "").inc(999)
    reg.counter("bad.count", "").inc(1)
    eng = SLOEngine(
        [availability_objective("av", "ok.count", ("bad.count",),
                                target=0.999)],
        clock=ManualClock(), registry=reg,
    )
    v = eng.evaluate()[0]
    assert v["compliance"] == pytest.approx(0.999)
    assert v["ok"]


def test_ratio_gauge_is_read_direct():
    reg = _registry()
    reg.gauge("conv.ratio", "").set(0.95)
    eng = SLOEngine(
        [ratio_objective("conv", "conv.ratio", 0.99)],
        clock=ManualClock(), registry=reg,
    )
    v = eng.evaluate()[0]
    assert v["compliance"] == pytest.approx(0.95)
    assert not v["ok"]
    reg.gauge("conv.ratio").set(0.999)
    assert eng.evaluate()[0]["ok"]


def test_no_data_passes_vacuously():
    """An idle service has not missed its SLO: unregistered metrics (and
    empty histograms) yield compliance None and ok=True."""
    eng = SLOEngine(
        [latency_objective("lat", "never.recorded", 100.0),
         availability_objective("av", "no.good", ("no.bad",))],
        clock=ManualClock(), registry=_registry(),
    )
    verdicts = eng.evaluate()
    assert all(v["compliance"] is None for v in verdicts)
    assert all(v["burn_rate"] is None for v in verdicts)
    assert verdicts_ok(verdicts)


# ---------------------------------------------------------------------- #
# burn rates on the injected clock

def test_multi_window_burn_rates_on_manual_clock():
    """A clean period then an error burst: both windows see the burst's
    error fraction spend the budget 10x faster than sustainable, so the
    objective is 'burning'; a fully clean history burns at 0."""
    reg = _registry()
    good, bad = reg.counter("g", ""), reg.counter("b", "")
    clock = ManualClock()
    eng = SLOEngine(
        [availability_objective("av", "g", ("b",), target=0.9)],
        clock=clock, registry=reg, windows=(10.0, 1000.0),
    )
    good.inc(100)
    eng.sample()                       # t=0: all good so far
    clock.advance(100.0)
    bad.inc(50)                        # the burst: 50 errors, 0 successes
    v = eng.evaluate()[0]              # t=100
    assert v["compliance"] == pytest.approx(100 / 150)
    assert not v["ok"]
    # both windows' deltas are pure errors: burn = (1 - 0) / 0.1 = 10
    assert [w["window_s"] for w in v["windows"]] == [10.0, 1000.0]
    assert all(w["burn_rate"] == pytest.approx(10.0) for w in v["windows"])
    assert v["burn_rate"] == pytest.approx(10.0)
    assert v["burning"]


def test_clean_history_burns_at_zero():
    reg = _registry()
    good = reg.counter("g", "")
    clock = ManualClock()
    eng = SLOEngine(
        [availability_objective("av", "g", ("b",), target=0.9)],
        clock=clock, registry=reg, windows=DEFAULT_WINDOWS,
    )
    for _ in range(5):
        good.inc(10)
        eng.sample()
        clock.advance(30.0)
    v = eng.evaluate()[0]
    assert v["ok"] and not v["burning"]
    assert all(w["burn_rate"] == pytest.approx(0.0) for w in v["windows"])


def test_sample_history_is_bounded():
    from automerge_tpu_torch.obs import slo as slo_mod

    reg = _registry()
    reg.counter("g", "").inc()
    clock = ManualClock()
    eng = SLOEngine(
        [availability_objective("av", "g", ())],
        clock=clock, registry=reg,
    )
    for _ in range(slo_mod.MAX_SAMPLES + 50):
        eng.sample()
        clock.advance(1.0)
    assert len(eng._samples["av"]) == slo_mod.MAX_SAMPLES


# ---------------------------------------------------------------------- #
# export surfaces

def test_export_mirrors_verdicts_into_slo_gauges():
    reg = _registry()
    reg.gauge("conv.ratio", "").set(0.5)
    clock = ManualClock()
    eng = SLOEngine(
        [ratio_objective("conv", "conv.ratio", 0.99),           # breach
         availability_objective("av", "g", ("b",), target=0.9)],  # ok
        clock=clock, registry=reg,
    )
    eng.sample()                      # t=0 baseline: no traffic yet
    reg.counter("g", "").inc(99)
    reg.counter("b", "").inc(1)
    clock.advance(100.0)
    verdicts = eng.export()
    assert reg.find("slo.conv.compliance").value == pytest.approx(0.5)
    assert reg.find("slo.conv.ok").value == 0.0
    assert reg.find("slo.av.compliance").value == pytest.approx(0.99)
    assert reg.find("slo.av.ok").value == 1.0
    assert reg.find("slo.av.burn_rate").value == pytest.approx(0.1)
    assert reg.find("slo.breaches").value == 1.0
    assert not verdicts_ok(verdicts)


def test_render_verdicts_table():
    reg = _registry()
    reg.gauge("conv.ratio", "").set(0.5)
    eng = SLOEngine(
        [ratio_objective("conv", "conv.ratio", 0.99)],
        clock=ManualClock(), registry=reg,
    )
    table = render_verdicts(eng.evaluate())
    assert "conv" in table and "BREACH" in table
    assert "target=0.990" in table
    assert render_verdicts([]) == "(no SLOs declared)"


def test_exposition_page_carries_slo_comment_lines():
    reg = _registry()
    reg.counter("g", "").inc(100)
    eng = SLOEngine(
        [availability_objective("av", "g", (), target=0.999)],
        clock=ManualClock(), registry=reg,
    )
    verdicts = eng.export()
    page = render_exposition(registry=reg, slo=verdicts)
    slo_lines = [ln for ln in page.splitlines() if ln.startswith("# SLO")]
    # one comment line per objective window, plus the slo.* gauges as
    # ordinary samples
    assert len(slo_lines) == len(DEFAULT_WINDOWS)
    assert all("av" in ln and "ok" in ln for ln in slo_lines)
    assert any(ln.startswith("slo_av_ok") for ln in page.splitlines())


def test_snapshot_record_embeds_verdicts():
    reg = _registry()
    reg.gauge("conv.ratio", "").set(1.0)
    eng = SLOEngine(
        [ratio_objective("conv", "conv.ratio", 0.99)],
        clock=ManualClock(), registry=reg,
    )
    verdicts = eng.evaluate()
    record = snapshot_record(t=1.5, registry=reg, slo=verdicts)
    assert record["slo"] == verdicts
    assert snapshot_record(t=1.5, registry=reg).get("slo") is None


# ---------------------------------------------------------------------- #
# canned sets

def test_default_serve_slos_shape():
    slos = default_serve_slos()
    assert [o.name for o in slos] == [
        "serve_latency", "serve_availability", "serve_convergence",
    ]
    assert slos[0].metric == "serve.request.e2e_ms"
    # the load harness swaps in the metrics-only histogram
    swapped = default_serve_slos(latency_metric="serve.sync.latency_ms",
                                 budget_ms=1000.0)
    assert swapped[0].metric == "serve.sync.latency_ms"
    assert swapped[0].budget_ms == 1000.0


def test_default_mesh_slos_shape():
    slos = default_mesh_slos()
    assert [o.name for o in slos] == ["mesh_delivery", "mesh_workers"]
    assert all(o.kind == "availability" for o in slos)
    assert slos[0].bad_metrics == ("mesh.worker.lost_docs",)
    assert slos[1].bad_metrics == ("mesh.worker.crashes",)

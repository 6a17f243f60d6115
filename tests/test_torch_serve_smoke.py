"""Smoke gate for the port's serving front door, twins of the JAX
package's tests/test_serve_smoke.py: ``chip_smoke.run_serve`` (phase 16's
driver) on the CPU at 96 clients over 24 docs, 2 edits of 4 ops each
spread over 0.4 simulated s, in simulated time from one seed, so the
figures below hold on any host.
"""
import chip_smoke

OCCUPANCY_FLOOR = 8
CLIENTS, DOCS = 96, 24

_REPORT = None


def _smoke():
    global _REPORT
    if _REPORT is None:
        with chip_smoke.counting_fallbacks():
            farm, report = chip_smoke.run_serve("cpu", CLIENTS, DOCS, 0,
                                                spread=0.4)
            chip_smoke.check_serve(farm, report, CLIENTS, "serve smoke")
        _REPORT = report
    return _REPORT


def test_all_clients_converge():
    report = _smoke()
    assert report["converged"], report
    assert report["unconverged_clients"] == 0
    assert report["surviving_clients"] == CLIENTS


def test_batch_occupancy_above_floor():
    """Mean docs-with-changes per farm dispatch at the default flush
    policy stays at or above the floor."""
    report = _smoke()
    assert report["dispatches"] > 0
    assert report["occupancy_mean"] >= OCCUPANCY_FLOOR, report


def test_zero_unexplained_sheds():
    """No poison, no chaos: nothing may be shed."""
    report = _smoke()
    assert report["admission"]["rejected_quarantine"] == 0
    assert report["admission"]["rejected_backpressure"] == 0
    assert report["admission"]["shed_mid_window"] == 0
    assert report["frames_shed"] == 0
    assert report["quarantined_docs"] == 0


def test_latency_histogram_populated():
    report = _smoke()
    lat = report["latency_ms"]
    assert lat["samples"] > 0
    assert lat["p50"] is not None
    assert lat["p50"] <= lat["p95"] <= lat["p99"]
    assert report["host_s"] > 0 and report["ops_per_s"] > 0

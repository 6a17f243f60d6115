"""The trace's reduction and the harness's hooks: device time charged by
the range that launched it, and a loop with no hooks of its own run as
before."""
import json

import pytest
from conftest import TINY_STEPS

import run
from harness import check as output_check
from harness import trace

US = 1e-6


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", trace.WINDOW_MARK, 0, 1000),
    _x("user_annotation", "dense.merge", 100, 300),
    _x("user_annotation", "inner", 150, 50),
    _x("user_annotation", "dense.upload", 500, 100),
    # another thread's range holds every launch's time, and none of them
    _x("user_annotation", "other", 0, 1000, tid=2),
    _x("cpu_op", "aten::gather", 110, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=2),
    _x("cuda_driver", "cuLaunchKernel", 380, 5, corr=5),
    _x("cuda_runtime", "cudaMemcpyAsync", 520, 5, corr=3),
    _x("cuda_runtime", "cudaLaunchKernel", 700, 5, corr=4),
    _x("kernel", "A", 200, 100, tid=7, corr=1),
    _x("kernel", "B", 300, 50, tid=7, corr=2),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 560, 40, tid=8,
       corr=3),
    _x("kernel", "A", 720, 30, tid=7, corr=4),
    _x("gpu_memset", "D", 850, 10, tid=7),          # no launch in the trace
    _x("kernel", "C", 990, 20, tid=7, corr=5),      # half past the window
    _x("kernel", "E", 1200, 20, tid=7, corr=1),     # after the window
]


@pytest.fixture
def reduced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.reduce_trace(str(path))


def test_kernels_are_charged_to_the_range_that_launched_them(reduced):
    assert reduced["ops_by_range"] == pytest.approx(
        {"dense.merge": 110 * US, "inner": 50 * US, "dense.upload": 40 * US,
         trace.HARNESS: 40 * US})
    assert reduced["launches_by_range"] == {
        "dense.merge": 2, "inner": 1, "dense.upload": 1, trace.HARNESS: 2}


def test_ops_busy_and_gaps_read_as_before(reduced):
    assert reduced["window_s"] == pytest.approx(1000 * US)
    assert reduced["busy_s"] == pytest.approx(240 * US)
    assert reduced["ops"] == pytest.approx(
        {"A": 130 * US, "B": 50 * US, "Memcpy HtoD (Pinned -> Device)":
         40 * US, "D": 10 * US, "C": 10 * US})
    assert [g[0] for g in reduced["gaps"]] == [
        "other", "dense.merge", "other", "other", "other"]
    assert [g[1] for g in reduced["gaps"]] == pytest.approx(
        [210 * US, 200 * US, 130 * US, 120 * US, 100 * US])


def test_a_loop_without_hooks_runs_as_before(tiny_root, monkeypatch):
    """No ``check`` in the loop: ``harness/check.check`` judges the run
    and counts what was attempted; no ``readings()``: the readers get
    the keys they got before."""
    calls, seen = [], []
    original_check, original_read = output_check.check, run.read_metric

    def check(*args):
        calls.append(args)
        return original_check(*args)

    def read(name, readings, root=run.ROOT):
        seen.append(readings)
        return original_read(name, readings, root)

    monkeypatch.setattr(output_check, "check", check)
    monkeypatch.setattr(run, "read_metric", read)
    result, _, info = run.run_cell("counter-64a", 2**32 + 1, 0.0, True,
                                   device="cpu", root=tiny_root,
                                   steps=TINY_STEPS)
    assert len(calls) == 1 and result["correct"]
    assert result["attempted"] == info["changes"] == len(calls[0][4])
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {frozenset(r) for r in seen} == {
        frozenset({"rows", "sweeps", "epochs", "generate_s", "phases",
                   "trace"})}
    assert set(seen[0]["trace"]) >= {"window_s", "busy_s", "ops", "gaps",
                                     "bloom_bounds_ms", "bloom_launches"}

"""Runs of the command on an NVIDIA card. They skip without CUDA; run
them on the card with ``python -m pytest benchmark/tests -m card``."""
import json
import subprocess
import sys

import pytest
from conftest import ROOT


def _run(cell, trace, seconds=5):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**33 + 17), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["map-sync-128", "counter-64a",
                                  "map-ingest-1k", "dense-100k"])
def test_a_cell_runs_correct_on_the_card(card, cell):
    result = _run(cell, 0)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]


@pytest.mark.card
def test_a_traced_sync_run_reads_the_bloom_kernels(card):
    result = _run("map-sync-128", 1, seconds=10)
    assert result["correct"], result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name in ("bloom_build_roofline", "bloom_query_roofline"):
        assert 0 < result["metrics"][name]["value"] <= 100


@pytest.mark.card
def test_a_traced_dense_run_reads_the_merge_by_range(card):
    result = _run("dense-100k", 1, seconds=10)
    assert result["correct"], result["checks"]
    metrics = {k: m["value"] for k, m in result["metrics"].items()}
    for name in ("dense.merge_roofline", "dense.visibility_roofline"):
        assert 0 < metrics[name] <= 100
    assert metrics["dense.device_ops_per_merge"] > 1
    assert metrics["dense.upload_ms_per_round"] > 0

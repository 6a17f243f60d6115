"""Shared set-up of the benchmark's CPU tests: the harness on the path, a
tiny copy of the benchmark's tree, and the ``card`` marker for the tests
that need an NVIDIA card (they skip here, decided inside a fixture)."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: the cells' sizes cut to what a CPU test holds (the widths stay)
TINY = {
    "configs/ycsb-a-8r.json": {"docs": 32},
    "configs/ycsb-a-8r-128.json": {"docs": 8},
    "configs/counter-64a.json": {"docs": 16, "actors": 8,
                                 "changes_per_actor": 3,
                                 "incs_per_change": 8},
    "traffic/sync-epochs-16.json": {"steps": 12},
    "traffic/ingest-flush-64.json": {"dirty_docs": 8, "steps": 40},
    "configs/dense-100k.json": {"docs": 64, "ops_per_doc": 32,
                                "rows_per_doc": 48, "keys": 6, "actors": 4},
    "traffic/dense-fill-80.json": {"rows_per_round": 6, "sample_docs": 8,
                                   "visibility_every": 2, "epochs": 16},
}
CELLS = ("map-sync-128", "counter-64a", "map-ingest-1k")
#: window steps of a tiny run (the CPU tests end windows by steps)
TINY_STEPS = 4


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without CUDA")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")


def make_tiny_tree(dest):
    """A copy of BENCHMARK.json and benchmark/ at `dest`, with the sizes
    of `TINY`."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, change in TINY.items():
        path = os.path.join(dest, "benchmark", rel)
        with open(path) as fh:
            data = json.load(fh)
        data.update(change)
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2)
    return str(dest)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_tree(tmp_path_factory.mktemp("tiny"))

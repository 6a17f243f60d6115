"""A later change adds a cell, a configuration, a traffic mix with a loop
of its own and a per-layer metric with new files and new entries alone:
no file of the harness is edited."""
import hashlib
import json
import os

from conftest import make_tiny_tree

import run

NEW_METRIC = '''"""Host microseconds per committed op row in the pack phase."""


def read(r):
    if not r["rows"] or "pack" not in r["phases"]:
        return None
    return r["phases"]["pack"] * 1e6 / r["rows"]
'''

NEW_LOOP = '''"""A server that takes each replica's changes of a step in a call of
their own."""
from harness import cells


def farm_count(stream):
    return 1


def build(cfg, mix, stream, device):
    from automerge_tpu_torch import TorchDocFarm

    return [TorchDocFarm(stream.docs, capacity=cfg["capacity"],
                         device=device)], None


class Driver(cells.Driver):
    def run_step(self, step):
        for _, idxs in step:
            if self.in_window:
                self.made.extend(idxs)
            self._apply(0, idxs, delivered=True)


ControlDriver = Driver
'''


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for name in files:
            if "__pycache__" not in base:
                path = os.path.join(base, name)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)


def test_a_fourth_cell_needs_only_new_files_and_entries(tmp_path):
    root = make_tiny_tree(tmp_path)
    before = _digests(root)
    bench = os.path.join(root, "benchmark")
    _write(os.path.join(bench, "configs", "ycsb-a-8r-uniform.json"),
           json.dumps({"extends": "ycsb-a-8r", "name": "ycsb-a-8r-uniform",
                       "zipf_theta": 0.0, "reduced": []}))
    _write(os.path.join(bench, "traffic", "per-replica-4.json"),
           json.dumps({"loop": "per_replica", "load": True,
                       "changes_per_replica": 4, "steps": 30,
                       "warmup_steps": 1, "shape_seed": 3}))
    _write(os.path.join(bench, "loops", "per_replica.py"), NEW_LOOP)
    _write(os.path.join(bench, "metrics", "farm.pack_us_per_row.py"),
           NEW_METRIC)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    spec["configs"].append({
        "name": "ycsb-a-8r-uniform", "source": spec["configs"][1]["source"],
        "file": "benchmark/configs/ycsb-a-8r-uniform.json", "reduced": [],
        "why": "uniform document popularity"})
    spec["workloads"].append({
        "name": "map-per-replica-uniform", "config": "ycsb-a-8r-uniform",
        "traffic": "per-replica-4", "chips": 1,
        "why": "each replica's updates in a call of their own"})
    # a farm cell reports the farms' rate: it joins that metric's cells
    next(m for m in spec["end_to_end"] if m["name"] == "merged_ops_per_s")[
        "workloads"].append("map-per-replica-uniform")
    spec["per_layer"].append({
        "name": "farm.pack_us_per_row", "unit": "us/row", "better": "lower",
        "source": "program_span", "layer": "pack",
        "moves": "merged_ops_per_s",
        "workloads": ["map-per-replica-uniform"]})
    _write(spec_path, json.dumps(spec))

    traced, check, info = run.run_cell("map-per-replica-uniform", 11, 0.0,
                                       True, device="cpu", root=root,
                                       steps=3)
    assert traced["correct"], check.notes
    assert "farm.pack_us_per_row" in traced["metrics"]
    # one call per replica of each step: 8 replicas, 3 window steps
    assert info["apply_ms"]["n"] == 24
    plain, _, _ = run.run_cell("map-per-replica-uniform", 11, 0.0, False,
                               device="cpu", root=root, steps=3)
    assert set(plain["metrics"]) == {"setup_s", "merged_ops_per_s"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

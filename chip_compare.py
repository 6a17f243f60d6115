#!/usr/bin/env python3
"""Phase 3 of chip_smoke.py from two checkouts, in turns, on one card.

    python3 chip_compare.py PARENT_DIR CHANGE_DIR [--docs 256] [--turns ABBA]

Two commits are compared only inside one call on one card (times on the
host clock drift between calls). Each turn is its own process: it imports
``chip_smoke`` from the checkout named by the turn (A = PARENT_DIR, B =
CHANGE_DIR), runs the map/counter scenario (``run_scenario``) on the card
under a PhaseProfile, and prints one JSON line: merged ops/s during the
sync, the sync and edit seconds, the sweep latencies and the phase
totals; the last line summarizes the turns (``summarize``). Both turns take their shape per document and their decode-LRU
sizes from this checkout's ``chip_smoke`` (``MAP_*``,
``decode_cache_env``), so they measure the same work as its phase 3. The
default turns A B B A put the parent first and last, so host drift shows
as the spread between the two A turns. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

import chip_smoke

_TURN = r"""
import json, os, sys, time
root, docs, replicas, changes, ops = sys.argv[1], *map(int, sys.argv[2:6])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke
from automerge_tpu_torch.profiling import PhaseProfile
prof = PhaseProfile()
t0 = time.perf_counter()
farms, stats = chip_smoke.run_scenario("cuda", docs, replicas, changes, ops,
                                       0, prof=prof)
print(json.dumps({
    "docs": docs,
    "merged_ops_per_s": stats["merged_rows"] / stats["sync_s"],
    "sync_s": stats["sync_s"], "edit_s": stats["edit_s"],
    "scenario_s": time.perf_counter() - t0,
    "sweeps_ms": [round(dt * 1e3, 1) for dt, _ in stats["sweeps"]],
    "phases_s": {k: round(v, 3) for k, v in prof.totals.items()},
}))
"""


def summarize(lines) -> dict:
    """Per side (A, B): quartiles (q1, median, q3) of merged ops/s, edit
    seconds and scenario seconds over its turns; and, over consecutive
    turn pairs (one A and one B each), how many pairs B won on each metric
    (higher ops/s, lower seconds)."""
    metrics = {"merged_ops_per_s": 1, "edit_s": -1, "scenario_s": -1}
    out = {}
    for side in "AB":
        runs = [line for line in lines if line["turn"] == side]
        out[side] = {
            m: [float(q) for q in np.quantile([r[m] for r in runs],
                                              [0.25, 0.5, 0.75])]
            for m in metrics
        }
    pairs = [lines[i:i + 2] for i in range(0, len(lines) - 1, 2)]
    pairs = [{p["turn"]: p for p in pair} for pair in pairs]
    pairs = [p for p in pairs if set(p) == {"A", "B"}]
    out["pairs"] = len(pairs)
    out["b_wins"] = {
        m: sum(sign * (p["B"][m] - p["A"][m]) > 0 for p in pairs)
        for m, sign in metrics.items()
    }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--docs", type=int, default=256)
    parser.add_argument("--turns", default="ABBA")
    args = parser.parse_args(argv)
    trees = {"A": os.path.abspath(args.parent),
             "B": os.path.abspath(args.change)}
    shape = [str(args.docs), str(chip_smoke.MAP_REPLICAS),
             str(chip_smoke.MAP_CHANGES), str(chip_smoke.MAP_OPS)]
    env = {**os.environ, **chip_smoke.decode_cache_env(args.docs)}
    lines = []
    for turn in args.turns:
        out = subprocess.run(
            [sys.executable, "-c", _TURN, trees[turn], *shape],
            capture_output=True, text=True, check=True, env=env,
        )
        line = json.loads(out.stdout.strip().splitlines()[-1])
        line["turn"] = turn
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summarize(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

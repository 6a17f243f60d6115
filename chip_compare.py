#!/usr/bin/env python3
"""Phase 3 of chip_smoke.py from two checkouts, in turns, on one card.

    python3 chip_compare.py PARENT_DIR CHANGE_DIR [--docs 256] [--turns ABBA]
    python3 chip_compare.py PARENT_DIR CHANGE_DIR --kernels [--turns ABBA]

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
as the spread between the two A turns.

With ``--kernels`` each turn instead builds its checkout's kernels and
holds its two Bloom kernels bit-exact against its own plain versions and
times them with this checkout's ``chip_smoke`` timing
(``bloom_timings``: device ``ms`` from a CUDA-graph replay, ``call_ms``
from eager calls, the profiler's cross-check, a copy of the inputs as a
yardstick) on the same inputs for both
sides: the main path's launch shapes (build B 4,096 x E 64 x W 20 with
48-64 live entries per filter; query B 4,096 x C 64 x W 4 with 1-12
entries per filter) and the shapes of chip_smoke's phase 10, a fresh
peer joining two 10,000-change documents (``wide_bloom_inputs``: build
B 2 x E 16,384 x W 5,120, query B 2 x C 16,384 x W 4,096, 10,000 live
entries and candidates per filter). It then holds kernel 3 (the LEB128
segmented sum) bit-exact against its plain version and times it
(``leb_timings``) on a seeded stream of phase 8's size and varint length
mix (``synthetic_varint_stream``), its planes and ids made as the device
scan makes them (``segsum_inputs``): row ``leb_sorted`` on those ids as
they come (sorted, as the scan makes them), row ``leb_unsorted`` on the
same rows and ids shuffled together (``unsorted_ms``, held bit-exact
inside ``leb_timings``).
Needs a CUDA device.
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

_KERNEL_TURN = r"""
import importlib.util, json, os, sys
root, harness = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
os.chdir(root)
spec = importlib.util.spec_from_file_location("timing_harness", harness)
h = importlib.util.module_from_spec(spec)
spec.loader.exec_module(h)
import numpy as np
import torch
from automerge_tpu_torch import kernels
from automerge_tpu_torch.tpu import bloom_kernels as bk
kernels.build()
rng = np.random.default_rng(0)
def dev(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).cuda()
xyz = rng.integers(0, 2**32, (4096, 64, 3), dtype=np.uint32)
counts = rng.integers(48, 65, 4096).astype(np.int32)
entries = rng.integers(0, 2**32, (4096, 12, 3), dtype=np.uint32)
q_counts = rng.integers(1, 13, 4096).astype(np.int32)
cands = rng.integers(0, 2**32, (4096, 64, 3), dtype=np.uint32)
cands[:, :6] = entries[:, :6]
words, modulo = bk.bloom_build_plain(dev(entries), dev(q_counts), 4)
main = ((dev(xyz), dev(counts), 20),
        (words, modulo, dev(q_counts), dev(cands)))
floor_ms = h.launch_floor_ms()
out = {"floor_ms": floor_ms}
for label, (b_args, q_args) in (("main", main),
                                ("wide", h.wide_bloom_inputs("cuda"))):
    h.check_build(*b_args)
    h.check_query(*q_args)
    b_row, q_row = h.bloom_timings(bk, b_args, q_args, floor_ms)
    out["build_" + label], out["query_" + label] = b_row, q_row
from automerge_tpu_torch.tpu import leb_kernels as lk
data = torch.from_numpy(h.synthetic_varint_stream(h.PHASE8_VARINTS)).cuda()
planes, seg, nvar = h.segsum_inputs(data)
if not torch.equal(lk.leb128_segment_sum(planes, seg, nvar),
                   lk.leb128_segment_sum_plain(planes, seg, nvar)):
    raise RuntimeError("leb128_segment_sum disagrees with its plain version")
row = out["leb_sorted"] = h.leb_timings(lk, planes, seg, nvar, floor_ms)
out["leb_unsorted"] = {"ms": row["unsorted_ms"], "copy_ms": row["copy_ms"]}
print(json.dumps(out))
"""
_KERNEL_ROWS = ("build_main", "query_main", "build_wide", "query_wide",
                "leb_sorted", "leb_unsorted")


def summarize_kernels(lines) -> dict:
    """Per side (A, B) and kernel row: the median over its turns of the
    device ``ms``, of ``call_ms``, of ``copy_ms`` and, where the row has
    one, of ``cold_ms``; and the median ``floor_ms``."""
    out = {}
    for side in "AB":
        runs = [line for line in lines if line["turn"] == side]
        out[side] = {"floor_ms": float(np.median([r["floor_ms"]
                                                  for r in runs]))}
        for row in _KERNEL_ROWS:
            out[side][row] = {
                m: float(np.median([r[row][m] for r in runs]))
                for m in ("ms", "call_ms", "copy_ms", "cold_ms")
                if m in runs[0][row]
            }
    return out


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
    parser.add_argument("--kernels", action="store_true",
                        help="time the two checkouts' kernels instead of "
                        "running phase 3")
    args = parser.parse_args(argv)
    trees = {"A": os.path.abspath(args.parent),
             "B": os.path.abspath(args.change)}
    shape = [str(args.docs), str(chip_smoke.MAP_REPLICAS),
             str(chip_smoke.MAP_CHANGES), str(chip_smoke.MAP_OPS)]
    env = {**os.environ, **chip_smoke.decode_cache_env(args.docs)}
    harness = os.path.abspath(chip_smoke.__file__)
    lines = []
    for turn in args.turns:
        cmd = ([sys.executable, "-c", _KERNEL_TURN, trees[turn], harness]
               if args.kernels else
               [sys.executable, "-c", _TURN, trees[turn], *shape])
        out = subprocess.run(cmd, capture_output=True, text=True, env=env)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr, flush=True)
            raise RuntimeError(f"turn {turn} failed ({out.returncode})")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        line["turn"] = turn
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = summarize_kernels(lines) if args.kernels else summarize(lines)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The control of the output check: the plain reference put in the
program's place with one guarantee that the configurations state broken
(concurrent sets of a key no longer kept as a conflict, the value that
arrives last replacing the others; an ``inc`` replacing its counter's
value instead of adding to it), run through a cell's own traffic and
window at the cell's own size, and held to the same check. Every cell's
check must fail it. The benchmark's runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        --steps <steps of a run's window>

prints, per seed, one JSON line with the check's numbers. In a sync cell
the control delivers each epoch's changes straight to every other farm
(an exchange that never loses a change), so only the broken merge
separates it from the reference (the sync loop's ``ControlDriver``). A
loop whose system is no farm builds its own control (``build_control``)
and is held to its own check."""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402
from harness import plugins  # noqa: E402
from reference import RootMap  # noqa: E402


class ControlResult(list):
    """apply_changes' return value as the farm's: patches per document,
    and the documents quarantined (none)."""

    quarantined: dict = {}


class ControlFarm:
    """The reference with the broken guarantee, in a farm's interface
    (``apply_changes``, ``get_patch``); `ref_mod` is the reference module
    of the stream's schema."""

    def __init__(self, stream, ref_mod):
        self.stream = stream
        self.ref_mod = ref_mod
        self.by_bytes = {data: i for i, data in enumerate(
            stream.changes.data)}
        self.docs = [RootMap(lww=True) for _ in range(stream.docs)]

    def _patch(self, d, keys=None):
        doc = self.docs[d]
        whole = doc.whole()
        props = whole if keys is None else {
            k: v for k, v in whole.items() if k in keys}
        return {"maxOp": doc.max_op, "clock": dict(doc.clock),
                "deps": sorted(doc.heads), "pendingChanges": 0,
                "diffs": {"objectId": "_root", "type": "map",
                          "props": props}}

    def apply_changes(self, per_doc_buffers):
        ch = self.stream.changes
        out = ControlResult()
        for d, bufs in enumerate(per_doc_buffers):
            keys = set()
            for data in bufs:
                i = self.by_bytes[data]
                self.ref_mod.commit(self.docs[d], ch, i)
                keys.update(k for k, _ in self.ref_mod.ops(ch, i))
            out.append(self._patch(d, keys) if bufs else None)
        return out

    def get_patch(self, d):
        return self._patch(d)


def control_farms(root=ROOT):
    """A `run.run_cell` ``make_farms`` that builds the loop's farms as
    `ControlFarm`s, or as the loop's own ``build_control(cfg, mix,
    stream, ref_mod)`` builds them where it has one (a loop whose system
    is no farm)."""

    def make(cfg, mix, stream, device):
        loop = plugins.load(root, "loops", mix["loop"])
        ref_mod = plugins.load(root, "reference", cfg["schema"])
        own = getattr(loop, "build_control", None)
        if own is not None:
            return own(cfg, mix, stream, ref_mod)
        return [ControlFarm(stream, ref_mod)
                for _ in range(loop.farm_count(stream))], None

    return make


def control_driver(name, root=ROOT):
    """The ``ControlDriver`` of cell `name`'s loop."""
    _, _, _, mix = run.load_cell(name, root)
    return plugins.load(root, "loops", mix["loop"]).ControlDriver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        result, check, info = run.run_cell(
            args.workload, seed, 0.0, False, device="cpu",
            make_farms=control_farms(), driver_cls=control_driver(
                args.workload), steps=args.steps)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "attempted": result["attempted"],
                          "steps": info["steps"], "notes": check.notes[:3]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

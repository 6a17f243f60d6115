"""CLI entry point: ``python -m automerge_tpu_torch.obs``.

The port's counterpart of the JAX package's ``obs/__main__.py``. Runs a
small canned workload — a farm merge (N docs, R change rounds through
`TorchDocFarm.apply_changes`) followed by a batched sync round-trip
between two farms (`SyncFarm` ping-pong until quiescent) — with spans,
metrics and the program observatory enabled, then prints the span tree
(p50/p95/p99 latencies), the metrics table and the program table
(dispatches, shape-bucket compiles and dispatch time per device program,
``obs/prof.py``). The farms run on ``--device``, the card by default;
without one the run raises, as the farm does (there is no CPU fallback;
``--device cpu`` asks for the CPU). Alternatively reads a previously
dumped JSON-lines trace and renders it without running anything.

    python -m automerge_tpu_torch.obs                      # canned workload
    python -m automerge_tpu_torch.obs --docs 4 --rounds 2  # smaller/larger
    python -m automerge_tpu_torch.obs --device cpu         # on the CPU
    python -m automerge_tpu_torch.obs --dump trace.jsonl   # also write it
    python -m automerge_tpu_torch.obs --trace trace.jsonl  # render a dump
    python -m automerge_tpu_torch.obs --json               # machine-readable
    python -m automerge_tpu_torch.obs --flight dump.jsonl  # flight timeline
    python -m automerge_tpu_torch.obs --watch snaps.jsonl  # telemetry view
    python -m automerge_tpu_torch.obs --watch snaps.jsonl --follow
    python -m automerge_tpu_torch.obs --ledger ledger.jsonl  # trajectory
    python -m automerge_tpu_torch.obs --ledger ledger.jsonl --diff -2 -1

``--flight`` renders a flight-recorder dump (obs/flight.py) as a
causally-ordered timeline. ``--watch`` renders the newest line of a
telemetry snapshot file (obs/export.py: tenant table, per-request phase
shares, flight-recorder tail) — once by default (headless/CI friendly),
or refreshing top-style with ``--follow`` against a running server or
load harness.

The workload imports the device layer lazily, so ``--trace``/``--flight``
/``--watch``/``--ledger`` rendering imports neither the farm nor torch.
Exit code 0 on success.
"""
from __future__ import annotations

import argparse
import json
import random
import sys

from .export import program_table, request_breakdown, shard_table
from .flight import load_jsonl, render_timeline
from .metrics import enabled_metrics, get_metrics
from .prof import enabled_observatory, get_observatory
from .spans import Trace, use_trace

_SYNC_ROUND_LIMIT = 16


def _change_stream(actor: str, rounds: int, ops_per_round: int, seed: int = 0):
    """One actor's binary change stream: key-set ops through the real wire
    format (the bench's end-to-end workload shape, bench.py)."""
    from ..columnar import decode_change_columns, encode_change

    rng = random.Random(seed)
    buffers, last, max_op, deps = [], {}, 0, []
    for r in range(rounds):
        ops = []
        start_op = max_op + 1
        ctr = start_op
        for _ in range(ops_per_round):
            key = f"k{rng.randrange(16)}"
            ops.append({"action": "set", "obj": "_root", "key": key,
                        "datatype": "uint", "value": rng.randrange(10**6),
                        "pred": [last[key]] if key in last else []})
            last[key] = f"{ctr}@{actor}"
            ctr += 1
        max_op = ctr - 1
        buf = encode_change({"actor": actor, "seq": r + 1, "startOp": start_op,
                             "time": 0, "deps": deps, "ops": ops})
        deps = [decode_change_columns(buf)["hash"]]
        buffers.append(buf)
    return buffers


def _sync_round_trip(trace, farm_a, farm_b):
    """Ping-pongs the batched sync protocol between two farms until both
    sides go quiet (bounded rounds)."""
    from ..tpu.sync_farm import SyncFarm

    sync_a, sync_b = SyncFarm(farm_a), SyncFarm(farm_b)
    n = farm_a.num_docs
    states_a = [SyncFarm.init_state() for _ in range(n)]
    states_b = [SyncFarm.init_state() for _ in range(n)]

    def half_round(sender, states_s, receiver, states_r):
        with trace.span("sync.generate"):
            results = sender.generate_messages(
                [(d, states_s[d]) for d in range(n)]
            )
        outgoing = []
        for d, (state, msg) in enumerate(results):
            states_s[d] = state
            if msg is not None:
                outgoing.append((d, msg))
        if outgoing:
            with trace.span("sync.receive"):
                received = receiver.receive_messages(
                    [(d, states_r[d], msg) for d, msg in outgoing]
                )
            for (d, _), (state, _patch) in zip(outgoing, received):
                states_r[d] = state
        return len(outgoing)

    for _ in range(_SYNC_ROUND_LIMIT):
        sent = half_round(sync_a, states_a, sync_b, states_b)
        sent += half_round(sync_b, states_b, sync_a, states_a)
        if sent == 0:
            break


def run_workload(num_docs: int, rounds: int, ops_per_round: int,
                 device="cuda") -> Trace:
    """Farm merge + sync round-trip on `device` under spans, metrics and
    the program observatory. Returns the trace; metrics and program
    tallies accumulate into the process-wide registry and observatory."""
    from ..tpu.farm import TorchDocFarm

    trace = Trace()
    capacity = rounds * ops_per_round
    with use_trace(trace), enabled_metrics(), enabled_observatory():
        with trace.span("merge"):
            farm_a = TorchDocFarm(num_docs, capacity=capacity, device=device)
            farm_b = TorchDocFarm(num_docs, capacity=capacity, device=device)
            streams_a = [
                _change_stream("a" * 8 + f"{d:02x}" * 4, rounds,
                               ops_per_round, seed=d)
                for d in range(num_docs)
            ]
            streams_b = [
                _change_stream("b" * 8 + f"{d:02x}" * 4, rounds,
                               ops_per_round, seed=100 + d)
                for d in range(num_docs)
            ]
            for r in range(rounds):
                farm_a.apply_changes(
                    [[streams_a[d][r]] for d in range(num_docs)]
                )
                farm_b.apply_changes(
                    [[streams_b[d][r]] for d in range(num_docs)]
                )
        with trace.span("sync"):
            _sync_round_trip(trace, farm_a, farm_b)
    return trace


def render_programs(programs: dict) -> str:
    """The program table (``obs.export.program_table`` rows): compiles,
    dispatches and their milliseconds per program."""
    lines = [
        f"{'program':<28} {'compiles':>9} {'dispatches':>11} "
        f"{'compile_ms':>11} {'dispatch_ms':>12}"
    ]
    for name, row in programs.items():
        lines.append(
            f"{name:<28} {row.get('compiles', 0):>9} "
            f"{row.get('dispatches', 0):>11} "
            f"{row.get('compile_ms', 0.0):>11} "
            f"{row.get('dispatch_ms', 0.0):>12}"
        )
    return "\n".join(lines)


def _render_watch_frame(record: dict) -> str:
    """One --watch frame: header, per-request phase shares, the tenant
    table and the flight-recorder tail, from a snapshot record."""
    lines = [f"== amscope @ t={record.get('t', 0.0):.3f} =="]
    breakdown = record.get("breakdown") or request_breakdown(
        record.get("metrics", {})
    )
    lines.append("")
    lines.append("-- phase shares (per request) --")
    if breakdown.get("requests"):
        shares = breakdown.get("shares", {})
        mean = breakdown.get("mean_ms", {})
        for phase in ("queue_wait", "dispatch", "readback", "assembly", "ack"):
            share = shares.get(phase, 0.0)
            bar = "#" * int(round(share * 40))
            lines.append(
                f"{phase:12} {share * 100:6.1f}%  {mean.get(phase, 0.0):9.3f} ms  {bar}"
            )
        lines.append(f"requests: {breakdown['requests']}")
        if "p99_exemplar" in breakdown:
            ex = breakdown["p99_exemplar"]
            lines.append(
                f"p99 {ex.get('p99_ms')} ms -> trace {ex.get('trace_id')}"
            )
    else:
        lines.append("(no completed requests yet)")
    lines.append("")
    lines.append("-- tenants --")
    tenants = record.get("tenants", {})
    if tenants:
        header = (
            f"{'tenant':12}  {'requests':>8}  {'changes':>8}  {'bytes':>10}  "
            f"{'shed':>6}  {'backpr':>6}  {'p99ms':>9}"
        )
        lines.append(header)
        for name in sorted(tenants):
            s = tenants[name]
            lat = s.get("latency_ms", {})
            p99 = lat.get("p99")
            lines.append(
                f"{name:12}  {s.get('requests', 0):>8}  "
                f"{s.get('changes', 0):>8}  {s.get('bytes_in', 0):>10}  "
                f"{s.get('shed', 0):>6}  {s.get('backpressure', 0):>6}  "
                f"{'-' if p99 is None else format(p99, '.3g'):>9}"
            )
    else:
        lines.append("(no tenant traffic)")
    shards = shard_table(record.get("metrics", {}))
    if shards:
        lines.append("")
        lines.append("-- shards --")
        suffixes = sorted({k for row in shards.values() for k in row})
        lines.append("  ".join([f"{'shard':>5}"] + [f"{s:>18}" for s in suffixes]))
        for shard, row in shards.items():
            cells = []
            for s in suffixes:
                v = row.get(s)
                if isinstance(v, dict):  # histogram: count @ total ms
                    cells.append(f"{v['count']} @ {v['sum']:.1f}ms")
                else:
                    cells.append("-" if v is None else str(v))
            lines.append("  ".join([f"{shard:>5}"] + [f"{c:>18}" for c in cells]))
    programs = program_table(record.get("metrics", {}))
    if programs:
        lines.append("")
        lines.append("-- programs (amprof) --")
        lines.append(render_programs(programs))
    slo = record.get("slo")
    if slo:
        from .slo import render_verdicts

        lines.append("")
        lines.append("-- SLOs --")
        lines.append(render_verdicts(slo))
    lines.append("")
    lines.append("-- flight tail --")
    tail = record.get("flight_tail", [])
    lines.append(render_timeline(tail) if tail else "(no flight events)")
    return "\n".join(lines)


def _watch(path: str, follow: bool, interval: float) -> int:
    """Renders the newest snapshot line of `path`; with --follow, keeps
    re-reading and redrawing until interrupted (or the file vanishes)."""
    import time as _time

    last_rendered = None
    while True:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = [ln for ln in fh.read().splitlines() if ln.strip()]
        except OSError as exc:
            print(f"--watch: cannot read {path}: {exc}", file=sys.stderr)
            return 1
        if not lines:
            print(f"--watch: {path} has no snapshots yet", file=sys.stderr)
            if not follow:
                return 1
        else:
            record = json.loads(lines[-1])
            if lines[-1] != last_rendered:
                last_rendered = lines[-1]
                if follow:
                    print("\033[2J\033[H", end="")
                print(_render_watch_frame(record))
        if not follow:
            return 0
        try:
            _time.sleep(interval)
        except KeyboardInterrupt:
            return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m automerge_tpu_torch.obs",
        description="amtrace/amscope/amprof: span tree, metrics and "
                    "program table for a canned farm merge + sync "
                    "round-trip, a dumped trace, a flight-recorder "
                    "timeline, a live telemetry view, or a perf ledger",
    )
    parser.add_argument("--docs", type=int, default=4,
                        help="documents per farm (default 4)")
    parser.add_argument("--rounds", type=int, default=2,
                        help="change rounds per document (default 2)")
    parser.add_argument("--ops", type=int, default=8,
                        help="ops per change (default 8)")
    parser.add_argument("--device", default="cuda",
                        help="where the workload's farms run (default "
                             "cuda; raises without a card)")
    parser.add_argument("--trace", metavar="FILE",
                        help="render a JSON-lines trace dump instead of "
                             "running the workload")
    parser.add_argument("--flight", metavar="FILE",
                        help="render a flight-recorder JSONL dump as a "
                             "causally-ordered timeline (no workload)")
    parser.add_argument("--watch", metavar="FILE",
                        help="render the newest telemetry snapshot in FILE "
                             "(tenant table + phase shares + flight tail); "
                             "headless one-frame render unless --follow")
    parser.add_argument("--ledger", metavar="FILE",
                        help="render the perf-ledger trajectory in FILE "
                             "(bench-appended JSONL, obs/ledger.py); "
                             "combine with --diff to compare two records")
    parser.add_argument("--diff", nargs=2, type=int, metavar=("A", "B"),
                        help="with --ledger: diff records A and B by index "
                             "(negative indices count from the end)")
    parser.add_argument("--follow", action="store_true",
                        help="with --watch: keep refreshing top-style")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="with --watch --follow: refresh seconds")
    parser.add_argument("--dump", metavar="FILE",
                        help="also write the span tree as JSON lines")
    parser.add_argument("--json", action="store_true",
                        help="print one JSON object instead of tables")
    args = parser.parse_args(argv)

    if args.ledger:
        from .ledger import (diff_records, load_ledger, render_diff,
                             render_trajectory)

        records = load_ledger(args.ledger)
        if args.diff:
            a_i, b_i = args.diff
            try:
                a, b = records[a_i], records[b_i]
            except IndexError:
                print(
                    f"--ledger: diff indices {a_i},{b_i} out of range "
                    f"({len(records)} record(s))", file=sys.stderr,
                )
                return 1
            if args.json:
                print(json.dumps(diff_records(a, b), sort_keys=True))
            else:
                print(render_diff(a, b))
        elif args.json:
            print(json.dumps(records, sort_keys=True))
        else:
            print(render_trajectory(records))
        return 0

    if args.flight:
        with open(args.flight, "r", encoding="utf-8") as fh:
            events = load_jsonl(fh.read())
        if args.json:
            print(json.dumps({"events": events}, sort_keys=True))
        else:
            print(render_timeline(events))
        return 0

    if args.watch:
        return _watch(args.watch, args.follow, args.interval)

    if args.trace:
        with open(args.trace, "r", encoding="utf-8") as fh:
            trace = Trace.from_jsonl(fh.read())
        metrics = programs = None
    else:
        get_metrics().reset()
        get_observatory().reset()
        trace = run_workload(args.docs, args.rounds, args.ops, args.device)
        metrics = get_metrics()
        programs = get_observatory().table()

    if args.dump:
        with open(args.dump, "w", encoding="utf-8") as fh:
            fh.write(trace.to_jsonl())

    if args.json:
        out = {"spans": [c.as_dict() for c in trace.root.children.values()]}
        if metrics is not None:
            out["metrics"] = metrics.as_dict()
            out["programs"] = programs
        print(json.dumps(out, sort_keys=True))
        return 0

    print("== spans ==")
    print(trace.tree_table())
    if metrics is not None:
        print()
        print("== metrics ==")
        print(metrics.table(skip_zero=True))
        print()
        print("== programs ==")
        print(render_programs(program_table(metrics.as_dict())))
    return 0


if __name__ == "__main__":
    sys.exit(main())

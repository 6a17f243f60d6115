"""amprof perf ledger — append-only JSONL of normalized bench records.

The port's own copy of the JAX package's ``obs/ledger.py`` (stdlib only).
A record holds a config hash, a phase table, ops/s, per-program
compile/dispatch stats and (mesh) per-shard pipe bytes. The ledger is the
regression memory one-shot numbers lack — ``python -m
automerge_tpu_torch.obs --ledger ledger.jsonl`` renders the trajectory,
``--diff A B`` diffs two records by index (negative indices count from the
end, so ``--diff -2 -1`` compares the last two runs).

Records are machine-local (wall times differ across hosts); the
regression GATES in bench.py are therefore machine-independent counts
(compiles per program, pipe bytes per round), and the ledger keeps the
wall-clock context those counts were measured in.
"""
# amlint: host-only
from __future__ import annotations

import hashlib
import json
from pathlib import Path


def normalize(value):
    """Recursively converts numpy scalars/arrays and other non-JSON
    leaves into plain Python ints/floats/lists (np.int64 stringifies
    under ``json.dumps(default=str)``; the ledger must stay diffable)."""
    if isinstance(value, dict):
        return {str(k): normalize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [normalize(v) for v in value]
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float, str)):
        return value
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return normalize(item())
        except (TypeError, ValueError):
            pass
    tolist = getattr(value, "tolist", None)
    if callable(tolist):
        return normalize(tolist())
    return str(value)


def config_hash(config: dict) -> str:
    """Short stable hash of a bench configuration (records with equal
    hashes are comparable runs)."""
    canon = json.dumps(normalize(config), sort_keys=True,
                       separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


def append_record(path, record: dict) -> dict:
    """Normalizes ``record``, stamps ``config_hash`` from its ``config``
    field, and appends one JSONL line. Returns the normalized record."""
    rec = normalize(record)
    if "config" in rec and "config_hash" not in rec:
        rec["config_hash"] = config_hash(rec["config"])
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a", encoding="utf-8") as fh:
        fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec


def load_ledger(path) -> list:
    """All records in the ledger, oldest first. Malformed lines are
    skipped (a crashed bench must not brick the trajectory view)."""
    records = []
    ledger = Path(path)
    if not ledger.exists():
        return records
    for line in ledger.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return records


def _program_totals(record: dict) -> tuple:
    programs = record.get("programs") or {}
    compiles = sum(int(p.get("compiles", 0)) for p in programs.values())
    dispatches = sum(int(p.get("dispatches", 0)) for p in programs.values())
    return compiles, dispatches


def _pipe_total(record: dict) -> int:
    pipe = record.get("pipe") or {}
    total = 0
    for shard in pipe.values():
        total += int(shard.get("bytes_out", 0)) + int(shard.get("bytes_in", 0))
    return total


def render_trajectory(records: list) -> str:
    """One row per record: index, kind, config hash, ops/s, compile and
    dispatch totals, pipe bytes."""
    if not records:
        return "ledger is empty"
    header = (f"{'#':>4}  {'kind':<12} {'config':<12} {'ops/s':>12} "
              f"{'compiles':>9} {'dispatches':>11} {'pipe_bytes':>11}")
    lines = [header, "-" * len(header)]
    for i, rec in enumerate(records):
        compiles, dispatches = _program_totals(rec)
        ops = rec.get("ops_per_sec")
        ops_s = f"{ops:,.0f}" if isinstance(ops, (int, float)) else "-"
        lines.append(
            f"{i:>4}  {str(rec.get('kind', '?')):<12} "
            f"{str(rec.get('config_hash', '?')):<12} {ops_s:>12} "
            f"{compiles:>9} {dispatches:>11} {_pipe_total(rec):>11}")
    return "\n".join(lines)


def diff_records(a: dict, b: dict) -> dict:
    """Structured diff of two ledger records (b relative to a): ops/s
    delta, per-program compile/dispatch deltas, per-shard pipe deltas."""
    out: dict = {
        "kind": (a.get("kind"), b.get("kind")),
        "config_hash": (a.get("config_hash"), b.get("config_hash")),
        "comparable": a.get("config_hash") == b.get("config_hash"),
    }
    ops_a, ops_b = a.get("ops_per_sec"), b.get("ops_per_sec")
    if isinstance(ops_a, (int, float)) and isinstance(ops_b, (int, float)):
        out["ops_per_sec"] = {
            "a": ops_a, "b": ops_b, "delta": ops_b - ops_a,
            "ratio": (ops_b / ops_a) if ops_a else None,
        }
    programs: dict = {}
    prog_a = a.get("programs") or {}
    prog_b = b.get("programs") or {}
    for name in sorted(set(prog_a) | set(prog_b)):
        pa, pb = prog_a.get(name, {}), prog_b.get(name, {})
        delta = {
            "compiles": int(pb.get("compiles", 0)) - int(pa.get("compiles", 0)),
            "dispatches": (int(pb.get("dispatches", 0))
                           - int(pa.get("dispatches", 0))),
        }
        if delta["compiles"] or delta["dispatches"]:
            programs[name] = delta
    out["programs"] = programs
    pipes: dict = {}
    pipe_a = a.get("pipe") or {}
    pipe_b = b.get("pipe") or {}
    for shard in sorted(set(pipe_a) | set(pipe_b), key=str):
        sa, sb = pipe_a.get(shard, {}), pipe_b.get(shard, {})
        delta = {
            key: int(sb.get(key, 0)) - int(sa.get(key, 0))
            for key in ("bytes_out", "bytes_in", "frames_out", "frames_in")
        }
        if any(delta.values()):
            pipes[shard] = delta
    out["pipe"] = pipes
    return out


def render_diff(a: dict, b: dict) -> str:
    diff = diff_records(a, b)
    lines = [
        f"diff {diff['kind'][0]}/{diff['config_hash'][0]} -> "
        f"{diff['kind'][1]}/{diff['config_hash'][1]}"
        + ("" if diff["comparable"] else "  [configs differ]"),
    ]
    ops = diff.get("ops_per_sec")
    if ops:
        ratio = ops["ratio"]
        lines.append(
            f"  ops/s: {ops['a']:,.0f} -> {ops['b']:,.0f} "
            f"({'x%.3f' % ratio if ratio is not None else 'n/a'})")
    if diff["programs"]:
        lines.append("  programs:")
        for name, delta in diff["programs"].items():
            lines.append(f"    {name}: compiles {delta['compiles']:+d}, "
                         f"dispatches {delta['dispatches']:+d}")
    else:
        lines.append("  programs: no change")
    if diff["pipe"]:
        lines.append("  pipe:")
        for shard, delta in diff["pipe"].items():
            lines.append(
                f"    shard {shard}: bytes_out {delta['bytes_out']:+d}, "
                f"bytes_in {delta['bytes_in']:+d}, "
                f"frames {delta['frames_out'] + delta['frames_in']:+d}")
    return "\n".join(lines)

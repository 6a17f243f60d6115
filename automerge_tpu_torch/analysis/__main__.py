"""CLI entry point: ``python -m automerge_tpu_torch.analysis [paths...]``.

Exit codes (pinned, tested): 0 = no unsuppressed findings, 1 = findings,
2 = bad usage (unknown rule id in ``--select`` or a suppression
directive, unreadable path, bad ``--changed`` ref). Usage errors print
one line to stderr — never a traceback.

``--changed <git-ref>`` is the incremental mode: only files changed
since ``ref`` (plus untracked files), *widened* to every scanned module
that transitively imports a changed one — reachability rules anchored in
an importer can produce findings in the changed file. When the import
graph says a changed module is reachable from a rule-scoped module (the
pipe-protocol endpoints ``workers``/``meshfarm``, or anything under
``serve/``), the whole-program contracts may shift and the scan falls
back to the full file set; the chosen mode is announced on stderr.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from . import (JAX_ONLY, RULES, CallGraph, UsageError, default_target,
               format_report, run_analysis)
from .core import FileContext, collect_files
from .graph import module_name
from .protorules import PROTOCOL_STEMS
from .workerrules import WORKER_STEMS


def _parse_select(spec: str) -> set[str]:
    ids = {part.strip() for part in spec.split(",") if part.strip()}
    if not ids:
        raise UsageError("--select: no rule ids given")
    unknown = sorted(ids - set(RULES))
    if unknown:
        raise UsageError(
            f"--select: unknown rule id(s) {', '.join(unknown)} "
            f"(see --list-rules)"
        )
    return ids


def _changed_files(ref: str) -> list[Path]:
    """Files changed since ``ref`` plus untracked files, as absolute
    paths. Any git failure is a usage error (bad ref, not a repo)."""
    def run(*argv: str) -> list[str]:
        proc = subprocess.run(
            ["git", *argv], capture_output=True, text=True
        )
        if proc.returncode != 0:
            detail = (proc.stderr or proc.stdout).strip().splitlines()
            raise UsageError(
                f"--changed {ref}: git {argv[0]} failed: "
                f"{detail[0] if detail else 'unknown error'}"
            )
        return [line for line in proc.stdout.splitlines() if line.strip()]

    top = Path(run("rev-parse", "--show-toplevel")[0])
    names = run("diff", "--name-only", ref, "--")
    names += run("ls-files", "--others", "--exclude-standard")
    out = []
    for name in names:
        p = top / name
        if p.suffix == ".py" and p.exists():
            out.append(p.resolve())
    return sorted(set(out))


def _rule_scoped(modname: str) -> bool:
    """Modules that anchor whole-program contracts: the pipe-protocol
    endpoints and the serve event-loop roots."""
    parts = set(modname.split("."))
    return bool(parts & (PROTOCOL_STEMS | WORKER_STEMS)) or "serve" in parts


def _resolve_changed(ref: str, paths: list[str]) -> tuple[list[str], str]:
    """The file list ``--changed ref`` should lint, plus a one-line mode
    note for stderr. Empty list = nothing to lint."""
    changed = set(_changed_files(ref))
    pairs = collect_files([Path(p) for p in paths])
    in_scan = {path: display for path, display in pairs}
    changed_in_scan = sorted(p for p in changed if p in in_scan)
    if not changed_in_scan:
        return [], "no changed python files in the scan set"

    ctxs = []
    for path, display in pairs:
        try:
            ctxs.append(FileContext(path, display))
        except Exception:
            # unparseable files still get their AM000 from run_analysis
            # if they end up in the scan list
            continue
    graph = CallGraph(ctxs)
    changed_mods = {module_name(p) for p in changed_in_scan}
    importers = graph.importers_closure(changed_mods)
    scoped = sorted(m for m in (importers | changed_mods) if _rule_scoped(m))
    if scoped:
        return [display for _path, display in pairs], (
            f"full scan: changed module(s) sit in the import graph of "
            f"rule-scoped module(s) ({', '.join(scoped[:3])})"
        )
    keep = [
        display for path, display in pairs
        if path in changed or module_name(path) in importers
    ]
    return keep, (
        f"incremental: {len(keep)} of {len(pairs)} file(s) "
        f"(changed + transitive importers)"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m automerge_tpu_torch.analysis",
        description="amlint: packing-invariant, device-program and "
                    "host/device boundary checks for automerge_tpu_torch",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to analyze (default: the installed "
             "automerge_tpu_torch package)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--select", metavar="IDS",
        help="comma-separated rule ids to report (others run but are "
             "filtered); unknown ids exit 2",
    )
    parser.add_argument(
        "--changed", metavar="REF",
        help="incremental mode: lint files changed since REF (plus "
             "untracked files and their transitive importers); falls "
             "back to a full scan when a rule-scoped module imports a "
             "changed one",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as a JSON object on stdout",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="include suppressed findings in the report (they do not "
             "affect the exit code)",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress the report; exit code only",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, (family, summary) in sorted(RULES.items()):
            print(f"{rule_id}  [{family:8s}] {summary}")
            if rule_id in JAX_ONLY:
                print(f"       (never fires here: {JAX_ONLY[rule_id]})")
        return 0

    try:
        selected = _parse_select(args.select) if args.select else None
        paths = args.paths or [str(default_target())]
        if args.changed is not None:
            paths, note = _resolve_changed(args.changed, paths)
            print(f"amlint: --changed {args.changed}: {note}",
                  file=sys.stderr)
            if not paths:
                if args.as_json:
                    print(json.dumps(
                        {"findings": [], "active": 0, "suppressed": 0}
                    ))
                elif not args.quiet:
                    print("0 finding(s)")
                return 0
        findings = run_analysis(
            paths, include_suppressed=args.show_suppressed
        )
    except UsageError as exc:
        print(f"amlint: error: {exc}", file=sys.stderr)
        return 2

    if selected is not None:
        findings = [f for f in findings if f.rule_id in selected]
    active = [f for f in findings if not f.suppressed]
    if args.as_json:
        print(json.dumps({
            "findings": [
                {
                    "rule": f.rule_id,
                    "path": f.path,
                    "line": f.line,
                    "col": f.col,
                    "message": f.message,
                    "suppressed": f.suppressed,
                }
                for f in findings
            ],
            "active": len(active),
            "suppressed": len(findings) - len(active),
        }, indent=2))
    elif not args.quiet:
        print(format_report(findings))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())

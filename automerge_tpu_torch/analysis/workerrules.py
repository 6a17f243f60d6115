"""AM502 + AM305 — mesh worker hygiene: no controller imports, no
process-global registry access, no exposition-layer telemetry in
worker-executed modules.

A mesh worker (parallel/workers.py) is spawned — not forked — so the
child re-imports its module tree under a pristine interpreter. Two bug
classes break that isolation and both have bitten multi-process serving
stacks:

1. **Controller imports.** A worker module that imports the controller
   layer (``parallel/meshfarm.py`` or anything under ``serve/``) drags
   the whole fan-in/routing machinery — and, transitively, its inline
   thread pool and env mutation — into every spawned child. Beyond the
   startup cost, it invites the worker to call controller entry points
   that assume they own the routing arrays, turning a one-directional
   pipe protocol into shared-state spaghetti.
2. **Process-global registry access.** ``get_metrics()``/``get_flight()``
   and friends hand back *per-process* singletons. Code written for the
   controller that reaches for them from a worker silently records into
   the child's registry and the numbers never surface — the classic
   "metrics vanish under the process backend" failure. Worker code must
   either receive its sinks explicitly or, where it deliberately uses
   the worker-process singleton as the shipping buffer (the one blessed
   pattern: record locally, ship ``diff_frames`` deltas over the pipe),
   carry a justified suppression saying so.

Flagged in scope:

- AM502: ``import``/``from ... import`` whose module path contains a
  controller-only segment (``meshfarm`` or ``serve``), or that imports
  such a module by name from a package;
- AM502: importing or calling a process-global registry accessor
  (``get_metrics``, ``get_flight``, ``get_amscope``, ``get_trace``,
  ``get_profile``).
- AM305: reaching the telemetry exposition/fan-in layer — importing
  ``obs.export`` (or any of ``render_exposition`` /
  ``serve_exposition`` / ``snapshot_record`` / ``SnapshotWriter`` by
  name), calling one of those, or importing/calling ``get_flight``.
  A worker's telemetry leaves its process exactly three ways, all
  shipping-buffer shaped: metric ``diff_frames`` deltas on the pipe,
  ``FlightRecorder.ship()`` event tails on the pipe, and the bounded
  black-box file for crash forensics. Exposing a worker's own registry
  on an exposition page (or snapshotting it to JSONL) publishes numbers
  the controller never sees — the split-brain telemetry bug. The one
  blessed pattern (the worker's own singleton AS the shipping buffer)
  carries a justified ``# amlint: disable=AM502,AM305`` suppression.

Scope (both rules): modules whose filename stem is in ``WORKER_STEMS``,
plus any file carrying a ``# amlint: mesh-worker`` marker (the fixture
hook, and the opt-in for future worker-executed modules living
elsewhere).

Both rules are *transitively* enforced: beyond the direct per-statement
walk, the module-import closure (graph.import_closure, bounded depth)
is checked — a worker module that imports an innocent helper which in
turn imports ``meshfarm``/``serve`` (AM502) or the ``obs.export``
exposition layer (AM305) drags the same machinery into every spawned
child, two hops removed. The finding anchors on the *first-hop* import
statement in the worker module (that line owns the fix) and prints the
module chain (``[reachable via workers -> helper -> meshfarm]``).
Direct edges (chain length 2) are owned by the direct walk and never
double-flagged.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import FileContext, Finding, dotted_name
from .graph import format_chain

#: modules whose code executes inside spawned mesh worker processes
WORKER_STEMS = frozenset({"workers"})

_MARKER_RE = re.compile(r"#\s*amlint:\s*mesh-worker\b")

#: module-path segments that mark a controller-only import
CONTROLLER_SEGMENTS = frozenset({"meshfarm", "serve"})

#: process-global registry accessors (obs + profiling singletons)
GLOBAL_ACCESSORS = frozenset({
    "get_metrics", "get_flight", "get_amscope", "get_trace", "get_profile",
    "get_observatory",
})

#: exposition/fan-in layer names a worker must never touch (AM305):
#: publishing a worker's own registry bypasses the shipping buffer
EXPOSITION_NAMES = frozenset({
    "render_exposition", "serve_exposition", "snapshot_record",
    "SnapshotWriter",
})


def _in_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in WORKER_STEMS
        or _MARKER_RE.search(ctx.source) is not None
    )


def _controller_import(node: ast.AST) -> bool:
    if isinstance(node, ast.Import):
        return any(
            CONTROLLER_SEGMENTS & set(alias.name.split("."))
            for alias in node.names
        )
    if isinstance(node, ast.ImportFrom):
        if CONTROLLER_SEGMENTS & set((node.module or "").split(".")):
            return True
        # `from . import meshfarm` / `from ..serve import batcher` style
        return any(alias.name in CONTROLLER_SEGMENTS for alias in node.names)
    return False


def _imported_accessors(node: ast.AST) -> set[str]:
    if isinstance(node, ast.ImportFrom):
        return GLOBAL_ACCESSORS & {alias.name for alias in node.names}
    return set()


def _exposition_import(node: ast.AST) -> set[str]:
    """Exposition-layer names this import drags into a worker module:
    the ``obs.export`` module itself, or any ``EXPOSITION_NAMES`` member
    imported by name."""
    if isinstance(node, ast.Import):
        return {
            alias.name for alias in node.names
            if "export" in alias.name.split(".")
        }
    if isinstance(node, ast.ImportFrom):
        if "export" in (node.module or "").split("."):
            return {node.module or "export"}
        return EXPOSITION_NAMES & {alias.name for alias in node.names} | {
            alias.name for alias in node.names if alias.name == "export"
        }
    return set()


def _check_transitive(ctx: FileContext, graph,
                      findings: list[Finding]) -> None:
    """Controller/exposition modules reached through the import closure.
    Chain length 2 is a direct import — the per-statement walk owns it."""
    if graph is None:
        return
    mod = graph.module_for(ctx)
    if mod is None:
        return
    for target, (chain, anchor) in sorted(graph.import_closure(mod.name).items()):
        if len(chain) <= 2:
            continue
        short = tuple(name.rsplit(".", 1)[-1] for name in chain)
        parts = set(target.split("."))
        if CONTROLLER_SEGMENTS & parts:
            findings.append(ctx.finding(
                "AM502", anchor,
                f"worker-executed module transitively imports the mesh "
                f"controller layer ({target}): this import drags the "
                "routing/fan-in machinery into every spawned child — break "
                "the chain at this line or move the helper out of the "
                "controller's import graph" + format_chain(short),
            ))
        elif "export" in parts:
            findings.append(ctx.finding(
                "AM305", anchor,
                f"worker-executed module transitively imports the telemetry "
                f"exposition layer ({target}): a worker must not publish "
                "its own registry — telemetry ships over the pipe or the "
                "black-box file only; break the chain at this line"
                + format_chain(short),
            ))


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        if not _in_scope(ctx):
            continue
        _check_transitive(ctx, graph, findings)
        for node in ast.walk(ctx.tree):
            if _controller_import(node):
                findings.append(ctx.finding(
                    "AM502", node,
                    "worker-executed module imports the mesh controller "
                    "layer (meshfarm/serve): workers speak the pipe "
                    "protocol only — the controller owns routing, fan-in "
                    "and respawn policy",
                ))
                continue
            imported = _imported_accessors(node)
            if imported:
                findings.append(ctx.finding(
                    "AM502", node,
                    f"worker-executed module imports process-global "
                    f"registry accessor(s) {sorted(imported)}: a worker's "
                    f"singletons are invisible to the controller — inject "
                    f"sinks explicitly, or justify the record-locally/"
                    f"ship-deltas pattern with a suppression",
                ))
                if "get_flight" in imported:
                    findings.append(ctx.finding(
                        "AM305", node,
                        "worker-executed module imports get_flight: worker "
                        "flight events leave the process only as shipped "
                        "tails (FlightRecorder.ship() over the pipe) or "
                        "the black-box file — justify the shipping-buffer "
                        "pattern with a suppression",
                    ))
                continue
            exposition = _exposition_import(node)
            if exposition:
                findings.append(ctx.finding(
                    "AM305", node,
                    f"worker-executed module imports the telemetry "
                    f"exposition layer ({sorted(exposition)}): exposing a "
                    f"worker's own registry publishes numbers the "
                    f"controller never sees — telemetry ships over the "
                    f"pipe (metric deltas + flight tails) or the "
                    f"black-box file only",
                ))
                continue
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                leaf = name.rsplit(".", 1)[-1] if name else None
                if leaf in GLOBAL_ACCESSORS:
                    findings.append(ctx.finding(
                        "AM502", node,
                        f"worker-executed module calls process-global "
                        f"registry accessor {leaf}(): records land in the "
                        f"worker's own singleton and never surface — "
                        f"inject sinks explicitly, or justify the "
                        f"record-locally/ship-deltas pattern with a "
                        f"suppression",
                    ))
                if leaf == "get_flight":
                    findings.append(ctx.finding(
                        "AM305", node,
                        "worker-executed module calls get_flight(): worker "
                        "flight events leave the process only as shipped "
                        "tails or the black-box file — justify the "
                        "shipping-buffer pattern with a suppression",
                    ))
                elif leaf in EXPOSITION_NAMES:
                    findings.append(ctx.finding(
                        "AM305", node,
                        f"worker-executed module calls exposition-layer "
                        f"{leaf}(): a worker must not publish its own "
                        f"registry — telemetry ships over the pipe or the "
                        f"black-box file only",
                    ))
    return findings

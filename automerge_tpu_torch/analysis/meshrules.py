"""AM501 — mesh data-plane hygiene: no dense per-doc Python statement
loops in mesh routing / merge-result paths.

The mesh controller sits on EVERY delivery's path: it routes a global
per-doc buffer list into per-shard sub-deliveries and merges per-shard
results back into one global result. A farm is thousands of documents of
which a delivery touches a handful, so a ``for d in range(num_docs)``
statement loop that subscripts per-doc state row by row turns an O(active)
fan-out into an O(farm) Python scan per call — the controller-side twin of
the per-row walks AM105 banned from the farm's hot phases.

The blessed shapes (what meshfarm.py itself uses):

- build a sparse active list with a comprehension
  (``active = [d for d, bufs in enumerate(per_doc) if bufs]``) and run
  statement loops over THAT;
- express whole-batch transforms as comprehensions (a comprehension
  builds its output in one pass with no per-iteration statement
  overhead, and is the documented idiom for the merge step);
- vectorize routing math with numpy (``np.add.at``, boolean masks).

Flagged: a ``for`` STATEMENT over ``range(...)`` whose body subscripts by
the loop variable — the dense per-doc scan shape. Comprehensions and
loops over sparse lists are exempt by construction.

Scope: modules whose filename stem is in ``MESH_STEMS`` (the parallel/
controller layer), plus any file carrying a ``# amlint: mesh-routing``
marker (the fixture hook, and the opt-in for future controller modules
living elsewhere).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import FileContext, Finding

#: the mesh controller modules (parallel/): routing + result-merge paths
MESH_STEMS = frozenset({"mesh", "meshfarm"})

_MARKER_RE = re.compile(r"#\s*amlint:\s*mesh-routing")


def _in_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in MESH_STEMS
        or _MARKER_RE.search(ctx.source) is not None
    )


def _is_range_loop(node: ast.For) -> bool:
    return (
        isinstance(node.iter, ast.Call)
        and isinstance(node.iter.func, ast.Name)
        and node.iter.func.id == "range"
    )


def _subscripts_by(body, var: str) -> bool:
    for stmt in body:
        for sub in ast.walk(stmt):
            if (
                isinstance(sub, ast.Subscript)
                and isinstance(sub.slice, ast.Name)
                and sub.slice.id == var
            ):
                return True
    return False


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        if not _in_scope(ctx):
            continue
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.For)
                and _is_range_loop(node)
                and isinstance(node.target, ast.Name)
                and _subscripts_by(node.body, node.target.id)
            ):
                findings.append(ctx.finding(
                    "AM501", node,
                    "dense per-doc `for ... in range(...)` statement loop "
                    "subscripting by the loop index in a mesh routing/"
                    "merge-result path: build a sparse active list with a "
                    "comprehension (`[d for d, bufs in enumerate(...) if "
                    "bufs]`) or vectorize with numpy so per-doc Python "
                    "touches only active docs",
                ))
    return findings

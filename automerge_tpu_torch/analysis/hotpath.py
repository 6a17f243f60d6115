"""AM105/AM106/AM107 — hot-phase hygiene: no per-row Python in the farm's
profiled hot phases, no per-byte Python in the decode hot path, no
per-change/per-op Python in the gate/transcode hot paths.

BENCH_r05 showed the merge farm spending >85% of wall time in host-side
Python that re-walks state row by row (``visibility`` + ``patch_assembly``
+ ``decode``). The fix was structural — column masks, batched
searchsorted, precomputed sort-key columns — and this rule keeps the
anti-patterns from creeping back into the modules that implement the
profiled phases:

- ``xs.sort(key=lambda ...)`` / ``sorted(xs, key=lambda ...)``: a Python
  callback per element where a precomputed, vectorisable sort-key column
  (e.g. transcode.lamport_keys) does the same work in one argsort;
- ``int(...)`` / ``bool(...)`` coercion of subscripted values inside a
  ``for``/comprehension over ``range(...)``: the classic row-at-a-time
  scan over a dense array, where a boolean mask or column gather should
  run first so per-row Python only touches rows that survive the filter.

Scope: modules whose filename stem is in ``HOT_PHASE_STEMS`` (the farm's
assembly layers), plus any file carrying a ``# amlint: hot-path`` marker.
Deliberately-cold call sites inside a hot module (per-call table builds,
debug paths) carry justified ``# amlint: disable=AM105`` suppressions.

AM106 bans the shape the vectorized decode (tpu/decode.py) replaced: a
``while``/``for`` loop that steps one byte at a time through a buffer —
a subscript of a buffer-named value (``buf``/``buffer``/``data``/...)
together with a ``+= 1`` cursor increment in the same loop body. LEB128
boundary detection is one continuation-bit mask + prefix scan; run
expansion is a record-level walk plus ``np.repeat`` — per-BYTE Python
must not creep back into decode modules. Scope: filename stems in
``DECODE_STEMS`` plus hot-path-marked files; the scalar parity oracle
(codecs.py) keeps its byte loops under justified suppressions — it IS
the reference the vector passes are tested against.

AM107 bans the shape the columnar causal gate replaced (BENCH_r07): a
``for`` STATEMENT in a hot-phase module that walks deliveries
change-by-change or ops op-by-op — a loop target named ``change``/``op``,
or iteration over a pending/applied/decoded collection, or over a
change's ``["ops"]`` list. Gate verdicts come from dep-index columns
(transcode.gate_verdicts) and op rows from cached column blocks; per-
change Python belongs only on the scalar oracle chain, whose loops carry
justified suppressions (it owns the canonical result/error for re-routed
anomalies). Comprehensions are deliberately exempt: sparse bookkeeping
builds (plan lists, per-doc dict updates) are not the quadratic shape
this rule hunts.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .core import FileContext, Finding, dotted_name

#: modules implementing the profiled hot phases (gate+transcode, pack,
#: visibility, patch_assembly) plus the mesh controller layer that fans
#: deliveries across shard farms (parallel/)
HOT_PHASE_STEMS = frozenset({"farm", "transcode", "mesh", "meshfarm"})

#: modules implementing the decode hot path (AM106): the scalar codec
#: layer and the vectorized column decode
DECODE_STEMS = frozenset({"codecs", "decode"})

#: names a per-byte decode loop subscripts (the cursor walks one of these)
_BUF_NAMES = frozenset({"buf", "buffer", "data", "raw", "chunk", "payload",
                        "stream"})

_COERCIONS = {"int", "bool"}


def _in_scope(ctx: FileContext) -> bool:
    return Path(ctx.path).stem in HOT_PHASE_STEMS or ctx.hot_path_marker


def _in_decode_scope(ctx: FileContext) -> bool:
    return Path(ctx.path).stem in DECODE_STEMS or ctx.hot_path_marker


def _is_key_lambda_sort(node: ast.Call) -> str | None:
    """'sort'/'sorted' when the call passes key=lambda, else None."""
    name = None
    if isinstance(node.func, ast.Attribute) and node.func.attr == "sort":
        name = ".sort"
    else:
        fname = dotted_name(node.func)
        if fname == "sorted":
            name = "sorted"
    if name is None:
        return None
    for kw in node.keywords:
        if kw.arg == "key" and isinstance(kw.value, ast.Lambda):
            return name
    return None


def _is_range_loop(iter_node: ast.expr) -> bool:
    return (
        isinstance(iter_node, ast.Call)
        and isinstance(iter_node.func, ast.Name)
        and iter_node.func.id == "range"
    )


def _coercion_of_subscript(node: ast.Call) -> bool:
    if not (
        isinstance(node.func, ast.Name)
        and node.func.id in _COERCIONS
        and len(node.args) == 1
    ):
        return False
    return any(isinstance(sub, ast.Subscript) for sub in ast.walk(node.args[0]))


def _range_loop_bodies(tree: ast.Module):
    """Yields (report_node, body_nodes) for every range()-driven loop:
    ``for i in range(...)`` statements and range()-driven comprehensions."""
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_range_loop(node.iter):
            yield node, node.body
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            if any(_is_range_loop(gen.iter) for gen in node.generators):
                if isinstance(node, ast.DictComp):
                    yield node, [node.key, node.value]
                else:
                    yield node, [node.elt]


def _is_buffer_subscript(node: ast.Subscript) -> bool:
    base = node.value
    if isinstance(base, ast.Name):
        return base.id in _BUF_NAMES
    if isinstance(base, ast.Attribute):
        return base.attr in _BUF_NAMES
    return False


def _is_cursor_step(node: ast.AugAssign) -> bool:
    return (
        isinstance(node.op, ast.Add)
        and isinstance(node.value, ast.Constant)
        and node.value.value == 1
    )


#: loop targets that name a per-change / per-op walk
_CHANGE_TARGETS = frozenset({"change", "op"})

#: iterables holding the delivery's change stream
_CHANGE_ITERS = frozenset({"pending", "applied", "decoded", "applied_ops"})


def _is_change_loop(node: ast.For) -> bool:
    """``for`` statements that walk changes or ops one at a time: the
    target is named ``change``/``op`` (possibly inside a tuple unpack),
    the iterable is a pending/applied/decoded collection, or the
    iterable is someone's ``["ops"]`` list."""
    target = node.target
    names = []
    if isinstance(target, ast.Name):
        names = [target.id]
    elif isinstance(target, ast.Tuple):
        names = [e.id for e in target.elts if isinstance(e, ast.Name)]
    if any(n in _CHANGE_TARGETS for n in names):
        return True
    it = node.iter
    if isinstance(it, ast.Name) and it.id in _CHANGE_ITERS:
        return True
    if isinstance(it, ast.Subscript):
        sl = it.slice
        if isinstance(sl, ast.Constant) and sl.value == "ops":
            return True
    return False


def _check_change_loops(ctx: FileContext, findings: list) -> None:
    """AM107: per-change/per-op ``for`` statements in gate/transcode hot
    paths — the work belongs in batched column programs."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.For) and _is_change_loop(node):
            findings.append(ctx.finding(
                "AM107", node,
                "per-change/per-op Python loop in a gate/transcode hot "
                "path: compute gate verdicts from dep-index columns "
                "(transcode.gate_verdicts) and take op rows from cached "
                "column blocks — scalar-oracle loops carry justified "
                "suppressions",
            ))


def _check_byte_loops(ctx: FileContext, findings: list) -> None:
    """AM106: a while/for loop whose body both subscripts a buffer-named
    value and advances a cursor by one — the per-byte scalar decode shape
    the vectorized column passes replaced."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.While, ast.For)):
            continue
        has_subscript = False
        has_step = False
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Subscript) and _is_buffer_subscript(sub):
                    has_subscript = True
                elif isinstance(sub, ast.AugAssign) and _is_cursor_step(sub):
                    has_step = True
        if has_subscript and has_step:
            findings.append(ctx.finding(
                "AM106", node,
                "per-byte decode loop in a decode hot-path module: the "
                "loop walks a buffer one byte at a time — decode the "
                "column with a masked vector pass (continuation-bit mask "
                "+ prefix scan, record-level run expansion; see "
                "tpu/decode.py)",
            ))


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        if _in_decode_scope(ctx):
            _check_byte_loops(ctx, findings)
        if not _in_scope(ctx):
            continue
        _check_change_loops(ctx, findings)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                spelling = _is_key_lambda_sort(node)
                if spelling is not None:
                    findings.append(ctx.finding(
                        "AM105", node,
                        f"`{spelling}(key=lambda ...)` in a hot-phase "
                        "module: a Python callback runs per element — "
                        "precompute a vectorisable sort-key column (e.g. "
                        "transcode.lamport_keys) and argsort it",
                    ))
        for loop, body in _range_loop_bodies(ctx.tree):
            for stmt in body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and _coercion_of_subscript(sub):
                        findings.append(ctx.finding(
                            "AM105", sub,
                            "per-row `int()`/`bool()` coercion inside a "
                            "range()-indexed loop in a hot-phase module: "
                            "filter with boolean column masks first so "
                            "per-row Python only touches surviving rows",
                        ))
    return findings

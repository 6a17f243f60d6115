"""AM1xx — packing-invariant rules.

The engine packs three fields into one int64 merge key::

    slot << _OP_BITS | counter << ACTOR_BITS | actor_intern_index

Every limit in the tpu layer derives from that layout: actor tables cap at
2^ACTOR_BITS, op counters at 2^(_OP_BITS - ACTOR_BITS), slot/element tables
at 2^(63 - _OP_BITS) (the sign bit must never flip under the sorted-table
invariant). These rules extract the constants from the analyzed files and
verify every definition, literal shift/mask, interner cap and diagnostic
message agrees with one canonical layout.
"""
from __future__ import annotations

import ast

from .core import (
    FileContext,
    Finding,
    dotted_name,
    module_constants,
    static_str_parts,
)

# Canonical constant-name groups. Different modules name the same logical
# quantity differently (engine._MKEY_OP_BITS vs rga._OP_BITS); AM101 treats
# each group as one constant and flags cross-file disagreement.
_GROUPS = {
    "ACTOR_BITS": {"ACTOR_BITS"},
    "ACTOR_MASK": {"ACTOR_MASK"},
    "OP_BITS": {"_MKEY_OP_BITS", "_OP_BITS", "OP_BITS"},
    "OP_MASK": {"_OP_MASK", "OP_MASK"},
    "MAX_COUNTER": {"MAX_COUNTER", "_MAX_COUNTER"},
    "MAX_SLOTS": {"_MAX_SLOTS", "MAX_SLOTS"},
    "MAX_ELEMS": {"MAX_ELEMS", "_MAX_ELEMS"},
}
_NAME_TO_GROUP = {n: g for g, names in _GROUPS.items() for n in names}

# The repo's canonical layout, used as the fallback when the analyzed file
# set does not itself define the widths (e.g. a lone file that imports
# ACTOR_BITS). AM101 verifies the real definitions against relations, not
# against these numbers, so the fallback cannot mask a layout change.
_DEFAULT_LAYOUT = {"ACTOR_BITS": 20, "OP_BITS": 44}

_MERGE_KEY_PHRASE = "merge-key packing range"
_RANK_KERNEL_PHRASE = "rank kernel"


def _file_groups(ctx: FileContext) -> dict[str, tuple[int, int]]:
    """{group: (value, lineno)} for the canonical constants this file
    defines at module level."""
    out: dict[str, tuple[int, int]] = {}
    for name, (value, line) in module_constants(ctx.tree).items():
        group = _NAME_TO_GROUP.get(name)
        if group is not None:
            out[group] = (value, line)
    return out


def _canonical_layout(per_file: dict[FileContext, dict]) -> dict[str, int]:
    layout = dict(_DEFAULT_LAYOUT)
    for groups in per_file.values():
        for group, (value, _line) in groups.items():
            layout.setdefault(group, value)
    return layout


def _imports_canonical_name(ctx: FileContext) -> bool:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name in _NAME_TO_GROUP:
                    return True
    return False


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    per_file = {ctx: _file_groups(ctx) for ctx in ctxs}
    layout = _canonical_layout(per_file)
    findings: list[Finding] = []
    findings += _check_layout_consistency(per_file, layout)
    for ctx in ctxs:
        in_scope = (
            "tpu" in ctx.path.parts
            or ctx.path.name == "columnar.py"
            or per_file[ctx]
            or _imports_canonical_name(ctx)
        )
        if in_scope:
            findings += _check_magic_literals(ctx, layout)
        findings += _check_interner_caps(ctx)
        findings += _check_diagnostics(ctx)
    return findings


# ---------------------------------------------------------------------- #
# AM101 — layout relations

def _check_layout_consistency(per_file, layout) -> list[Finding]:
    findings: list[Finding] = []

    # cross-file agreement within each group
    by_group: dict[str, dict[int, list[tuple[FileContext, int]]]] = {}
    for ctx, groups in per_file.items():
        for group, (value, line) in groups.items():
            by_group.setdefault(group, {}).setdefault(value, []).append((ctx, line))
    for group, values in by_group.items():
        if len(values) > 1:
            rendering = ", ".join(str(v) for v in sorted(values))
            for sites in values.values():
                for ctx, line in sites:
                    findings.append(ctx.finding(
                        "AM101",
                        _at(line),
                        f"canonical constant {group} disagrees across files "
                        f"(values: {rendering}); one layout must govern every "
                        "packing site",
                    ))

    actor_bits = layout.get("ACTOR_BITS")
    op_bits = layout.get("OP_BITS")

    def relation(ctx, line, msg):
        findings.append(ctx.finding("AM101", _at(line), msg))

    for ctx, groups in per_file.items():
        if "ACTOR_MASK" in groups and actor_bits is not None:
            value, line = groups["ACTOR_MASK"]
            if value != (1 << actor_bits) - 1:
                relation(ctx, line,
                         f"ACTOR_MASK = {value:#x} does not match "
                         f"(1 << ACTOR_BITS) - 1 for ACTOR_BITS={actor_bits}")
        if "OP_MASK" in groups and op_bits is not None:
            value, line = groups["OP_MASK"]
            if value != (1 << op_bits) - 1:
                relation(ctx, line,
                         f"op-id mask = {value:#x} does not match "
                         f"(1 << OP_BITS) - 1 for OP_BITS={op_bits}")
        if "MAX_COUNTER" in groups and actor_bits is not None and op_bits is not None:
            value, line = groups["MAX_COUNTER"]
            if value != 1 << (op_bits - actor_bits):
                relation(ctx, line,
                         f"MAX_COUNTER = {value} does not equal "
                         f"1 << (OP_BITS - ACTOR_BITS) = "
                         f"{1 << (op_bits - actor_bits)}: counters would "
                         "overflow into the slot field of the merge key")
        for cap_group in ("MAX_SLOTS", "MAX_ELEMS"):
            if cap_group in groups and op_bits is not None:
                value, line = groups[cap_group]
                if value > 1 << (63 - op_bits):
                    relation(ctx, line,
                             f"{cap_group} = {value} exceeds 1 << (63 - "
                             f"OP_BITS) = {1 << (63 - op_bits)}: the packed "
                             "int64 sort key would overflow the sign bit")
        if op_bits is not None and op_bits > 63 and "OP_BITS" in groups:
            value, line = groups["OP_BITS"]
            relation(ctx, line, f"OP_BITS = {value} exceeds the 63 value bits "
                                "of an int64 sort key")
        if (
            actor_bits is not None and op_bits is not None
            and actor_bits >= op_bits and ("ACTOR_BITS" in groups or "OP_BITS" in groups)
        ):
            _, line = groups.get("ACTOR_BITS", groups.get("OP_BITS"))
            relation(ctx, line,
                     f"ACTOR_BITS={actor_bits} leaves no counter bits below "
                     f"OP_BITS={op_bits}")
    return findings


class _at:
    """Minimal location shim so FileContext.finding works from a lineno."""

    def __init__(self, lineno: int, col_offset: int = 0):
        self.lineno = lineno
        self.col_offset = col_offset


# ---------------------------------------------------------------------- #
# AM102 — magic shift/mask literals

def _check_magic_literals(ctx: FileContext, layout) -> list[Finding]:
    widths = {}
    for group in ("ACTOR_BITS", "OP_BITS"):
        if group in layout:
            widths[layout[group]] = group
    masks = {(1 << w) - 1: g for w, g in widths.items()}
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.BinOp):
            continue
        if isinstance(node.op, (ast.LShift, ast.RShift)):
            rhs = node.right
            # `1 << 20`-style cap definitions are constants, not packing
            # operations on a value; only flag shifts of a computed operand
            if (
                isinstance(rhs, ast.Constant)
                and isinstance(rhs.value, int)
                and rhs.value in widths
                and not isinstance(node.left, ast.Constant)
            ):
                findings.append(ctx.finding(
                    "AM102", rhs,
                    f"literal shift by {rhs.value} duplicates the canonical "
                    f"{widths[rhs.value]} constant; use the named constant so "
                    "the layout has a single source of truth",
                ))
        elif isinstance(node.op, ast.BitAnd):
            for side in (node.left, node.right):
                if (
                    isinstance(side, ast.Constant)
                    and isinstance(side.value, int)
                    and side.value in masks
                ):
                    group = masks[side.value]
                    findings.append(ctx.finding(
                        "AM102", side,
                        f"literal mask {side.value:#x} duplicates "
                        f"(1 << {group}) - 1; use the named mask constant",
                    ))
    return findings


# ---------------------------------------------------------------------- #
# AM103 — interner caps

def _check_interner_caps(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None or not name.split(".")[-1].endswith("Interner"):
            continue
        has_cap = any(
            kw.arg == "max_size" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            )
            for kw in node.keywords
        ) or len(node.args) >= 1  # first positional arg is max_size
        if not has_cap:
            findings.append(ctx.finding(
                "AM103", node,
                "interner constructed without max_size: an overflowing table "
                "silently corrupts the merge-key packing (slot/actor indexes "
                "ride fixed-width bit fields); pass max_size= or suppress "
                "with a justification if the table is never packed",
            ))
    return findings


# ---------------------------------------------------------------------- #
# AM104 — diagnostic/range message consistency

def _enclosing_test(node: ast.AST):
    """The test expression of the nearest enclosing if/while, stopping at a
    function boundary."""
    cur = getattr(node, "_amlint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.If, ast.While)):
            return cur.test
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            return None
        cur = getattr(cur, "_amlint_parent", None)
    return None


def _names_in(expr: ast.AST) -> set[str]:
    out = set()
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _check_diagnostics(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)):
            continue
        test = _enclosing_test(node)
        if test is None:
            continue
        guard_names = _names_in(test)
        message = static_str_parts(node.exc)
        if guard_names & _GROUPS["MAX_COUNTER"]:
            if _MERGE_KEY_PHRASE not in message:
                findings.append(ctx.finding(
                    "AM104", node,
                    "diagnostic for a MAX_COUNTER guard must say "
                    f"'{_MERGE_KEY_PHRASE}': the counter cap protects the "
                    "merge-key packing for ALL ops, not a specific kernel",
                ))
        elif guard_names & _GROUPS["MAX_ELEMS"]:
            if _RANK_KERNEL_PHRASE not in message:
                findings.append(ctx.finding(
                    "AM104", node,
                    "diagnostic for a MAX_ELEMS guard must name the "
                    f"'{_RANK_KERNEL_PHRASE}': the element cap protects the "
                    "RGA sibling-sort key packing",
                ))
        elif guard_names & _GROUPS["MAX_SLOTS"]:
            if "slot" not in message.lower():
                findings.append(ctx.finding(
                    "AM104", node,
                    "diagnostic for a MAX_SLOTS guard must mention the slot "
                    "table so debuggers land on the interner, not a kernel",
                ))
    return findings

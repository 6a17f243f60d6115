"""AM601 — durability-plane write discipline: all durable bytes go
through the atomic/checksummed writer.

The store tier's whole crash-consistency argument rests on two write
primitives and nothing else:

1. ``store.atomic.atomic_write`` — tmp + fsync + ``os.replace`` for
   files replaced as a unit (manifests, cold chunks, sidecars, black
   boxes). The rename is the commit point; a crash leaves old or new,
   never a torn mix.
2. the WAL's checksummed append handle — every appended frame carries
   ``length + sha256``, so recovery can prove exactly where a torn write
   starts and truncate there.

A bare ``open(path, "w"/"wb"/"a"/...)`` or ``os.write`` anywhere else on
the durability plane is a write the recovery scan cannot reason about: no
checksum to verify, no rename to anchor the commit point, and a crash
mid-write silently persists a half-state the next open will trust. That
is precisely the corruption class the crash-point sweep
(tests/test_store.py) exists to rule out, so the rule closes the hole
statically.

Flagged in scope: ``open()`` calls whose mode is write-capable (contains
``w``, ``a``, ``x`` or ``+``) or not statically known, and raw descriptor
writes (``os.write``/``os.pwrite``/``os.writev``). Reads are free.

Scope: modules under a ``store`` package directory, plus any file
carrying an ``# amlint: durability-plane`` marker (the fixture hook, and
the opt-in for durable artifacts written outside the store tree). The
two blessed primitives above are themselves in scope and carry justified
``# amlint: disable=AM601`` suppressions — the escape hatch is the
documented pattern for "this raw handle IS the checksummed writer".
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import FileContext, Finding, dotted_name

_MARKER_RE = re.compile(r"#\s*amlint:\s*durability-plane\b")

#: raw descriptor writes that bypass both blessed primitives
RAW_WRITERS = frozenset({"os.write", "os.pwrite", "os.writev"})

_WRITE_MODE = re.compile(r"[wax+]")


def _in_scope(ctx: FileContext) -> bool:
    return (
        "store" in Path(ctx.path).parts
        or _MARKER_RE.search(ctx.source) is not None
    )


def _open_mode(node: ast.Call):
    """The mode argument of an ``open()`` call: its literal value, None
    when omitted (read mode), or Ellipsis when not statically known."""
    mode = node.args[1] if len(node.args) > 1 else None
    if mode is None:
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
                break
    if mode is None:
        return None
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return ...


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        if not _in_scope(ctx):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name == "open":
                mode = _open_mode(node)
                if mode is None:
                    continue
                if mode is ... or _WRITE_MODE.search(mode):
                    shown = "<dynamic>" if mode is ... else repr(mode)
                    findings.append(ctx.finding(
                        "AM601", node,
                        f"bare open(..., {shown}) in a durability-plane "
                        f"module: recovery cannot reason about this write "
                        f"(no checksum, no rename commit point) — go "
                        f"through store.atomic.atomic_write or the WAL's "
                        f"checksummed appender, or justify the raw handle "
                        f"with a suppression",
                    ))
            elif name in RAW_WRITERS:
                findings.append(ctx.finding(
                    "AM601", node,
                    f"raw descriptor write {name}() in a durability-plane "
                    f"module bypasses the atomic/checksummed writer — a "
                    f"crash mid-write persists an unverifiable half-state",
                ))
    return findings

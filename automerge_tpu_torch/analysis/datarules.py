"""AM504 — shm data-plane modules keep bulk payloads out of pickle.

The zero-copy mesh transport (parallel/shm.py) exists because the
per-delivery column batches are flat bytes on both ends: the send ring
carries them as ``struct``-framed counts + lengths + raw concatenation,
the result ring carries struct-framed outcome tuples next to the patch
blob, and the pipe is left with control frames only. That win is easy to
quietly lose: one convenient ``pickle.dumps(batch)`` on a send path and
the transport is back to paying the serialization tax it was built to
remove — while every dashboard still says "shm".

So in shm-transport scope a ``pickle.dumps``/``pickle.dump`` call is a
finding: bulk column payloads (numpy arrays, column-batch dicts, patch
columns) go through the shm codecs (``encode_columns``/``encode_result``)
or stay out of the data plane entirely. The ONE blessed exception is the
pickle-ORACLE path — ``mesh_transport="pickle"`` keeps the whole batch
in the pipe frame as the byte-for-byte parity baseline and the fallback
for hosts without POSIX shared memory — and that site carries a
justified ``# amlint: disable=AM504`` suppression, exactly like the
durability plane's blessed raw handle (AM601).

``pickle.loads`` is deliberately NOT flagged: the patch blob inside a
result frame is opaque pickled bytes by design (produced by
``tpu.farm.result_to_wire`` outside this scope, materialized lazily by
the controller straight from the mapped segment), so receive-side
unpickling is the contract, not a leak. The rule guards the SEND paths,
where a pickle call means payload bytes are being re-serialized.

Scope: modules whose filename stem is in ``SHM_DATA_PLANE_STEMS``, plus
any file carrying an ``# amlint: mesh-data-plane`` marker (how
workers.py/meshfarm.py opt in, and the fixture hook).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import FileContext, Finding, dotted_name

_MARKER_RE = re.compile(r"#\s*amlint:\s*mesh-data-plane\b")

#: module stems always in scope (the shm transport itself)
SHM_DATA_PLANE_STEMS = frozenset({"shm"})

#: the serializers that re-grow the pickle tax on a send path
_PICKLE_SENDERS = frozenset({"pickle.dumps", "pickle.dump"})


def _in_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in SHM_DATA_PLANE_STEMS
        or _MARKER_RE.search(ctx.source) is not None
    )


def _pickle_aliases(tree: ast.AST) -> frozenset:
    """Names that resolve to pickle's send-side serializers in this file:
    the dotted forms plus anything bound by ``from pickle import dumps``
    (aliased or not)."""
    names = set(_PICKLE_SENDERS)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "pickle":
            for alias in node.names:
                if alias.name in ("dumps", "dump"):
                    names.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "pickle" and alias.asname:
                    names.add(f"{alias.asname}.dumps")
                    names.add(f"{alias.asname}.dump")
    return frozenset(names)


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        if not _in_scope(ctx):
            continue
        senders = _pickle_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in senders:
                findings.append(ctx.finding(
                    "AM504", node,
                    f"{name}() in an shm data-plane module: bulk column "
                    f"payloads ride the shared-memory rings struct-framed "
                    f"(shm.encode_columns/encode_result), never pickle — "
                    f"one re-serialized send path silently refunds the "
                    f"zero-copy win; if this IS the pickle parity-oracle "
                    f"transport, justify it with a suppression",
                ))
    return findings

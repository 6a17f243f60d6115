"""AM3xx — host/device boundary rules.

The package keeps a strict layering: the columnar codecs, the sequential
OpSet engine, the frontend and the sync wire protocol are pure host Python
(they must import cleanly without torch and never pull device programs),
while everything under ``tpu/`` is the device layer. The farm's profiling
phases likewise encode the boundary: a phase named for device work must not
hide a host synchronisation inside it, or the phase table lies about where
time goes and the card's queue silently drains.

- AM301: a host-only module (marked ``# amlint: host-only`` or on the
  built-in list) imports ``torch``, ``automerge_tpu_torch.tpu`` / ``.tpu``
  (or ``jax``, which the port never imports).
- AM302: inside ``with prof.phase("device...")`` blocks, lexical calls that
  force a device->host transfer (``np.*``, ``int()``/``float()``/
  ``bool()``, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize``, ``print``) are flagged.
"""
from __future__ import annotations

import ast

from .core import PACKAGE, FileContext, Finding, dotted_name
from .tracer import _np_aliases

# Modules at the automerge_tpu_torch package root that form the host-only
# layer.
# ``# amlint: host-only`` in a module marks it explicitly (and is how the
# fixture tests exercise the rule); the list keeps the rule self-contained
# for the repo even if a marker goes missing.
_HOST_ONLY_BASENAMES = {
    "columnar.py", "opset.py", "codecs.py", "common.py", "sync.py",
    "uuid.py", "backend.py", "native.py", "profiling.py",
}
_HOST_ONLY_DIRS = {"frontend"}


def _is_host_only(ctx: FileContext) -> bool:
    if ctx.host_only_marker:
        return True
    parts = ctx.path.parts
    if PACKAGE not in parts:
        return False
    if any(d in parts for d in _HOST_ONLY_DIRS):
        return True
    idx = len(parts) - 1 - parts[::-1].index(PACKAGE)
    at_package_root = idx == len(parts) - 2
    return at_package_root and ctx.path.name in _HOST_ONLY_BASENAMES


def _forbidden_import(module: str | None, level: int) -> str | None:
    """Why an import target crosses the boundary, or None if it is fine."""
    if module is None:
        return None  # `from . import sibling` — checked per alias below
    head = module.split(".")[0]
    if head in ("torch", "jax"):
        return f"imports {head} (device runtime) into the host-only layer"
    if module == f"{PACKAGE}.tpu" or module.startswith(f"{PACKAGE}.tpu.") \
            or (level > 0 and head == "tpu"):
        return "imports the device layer (tpu/)"
    return None


def _check_imports(ctx: FileContext) -> list[Finding]:
    if not _is_host_only(ctx):
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                reason = _forbidden_import(alias.name, 0)
                if reason:
                    findings.append(ctx.finding(
                        "AM301", node,
                        f"host-only module {reason}: the host layer must "
                        "import cleanly without device dependencies",
                    ))
        elif isinstance(node, ast.ImportFrom):
            reason = _forbidden_import(node.module, node.level)
            if reason is None and node.module is None and node.level > 0:
                # `from . import tpu` pulls the device package by name
                if any(alias.name == "tpu" for alias in node.names):
                    reason = "imports the device layer (tpu/)"
            if reason:
                findings.append(ctx.finding(
                    "AM301", node,
                    f"host-only module {reason}: the host layer must "
                    "import cleanly without device dependencies",
                ))
    return findings


# ---------------------------------------------------------------------- #
# AM302 — device-phase hygiene

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_BUILTINS = {"int", "float", "bool", "print"}
#: dotted calls that wait for the card
_SYNC_CALLS = {"torch.cuda.synchronize"}


def _device_phase_name(stmt: ast.With) -> str | None:
    for item in stmt.items:
        call = item.context_expr
        if (
            isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "phase"
            and call.args
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
            and "device" in call.args[0].value
        ):
            return call.args[0].value
    return None


def _check_device_phases(ctx: FileContext) -> list[Finding]:
    np_aliases = _np_aliases(ctx.tree) | {"np"}
    findings: list[Finding] = []
    for stmt in ast.walk(ctx.tree):
        if not isinstance(stmt, ast.With):
            continue
        phase = _device_phase_name(stmt)
        if phase is None:
            continue
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            hidden = None
            if fname in _SYNC_CALLS:
                hidden = f"`{fname}()` waits for the card"
            elif fname and fname.split(".")[0] in np_aliases:
                hidden = f"`{fname}` copies device results to the host"
            elif fname in _SYNC_BUILTINS and node.args and not all(
                isinstance(a, ast.Constant) for a in node.args
            ):
                hidden = f"`{fname}()` blocks on a device value"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
            ):
                hidden = f"`.{node.func.attr}()` blocks on a device value"
            if hidden:
                findings.append(ctx.finding(
                    "AM302", node,
                    f"hidden host sync in device phase '{phase}': {hidden}; "
                    "move it to a host phase so the profile stays honest",
                ))
    return findings


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        findings += _check_imports(ctx)
        findings += _check_device_phases(ctx)
    return findings

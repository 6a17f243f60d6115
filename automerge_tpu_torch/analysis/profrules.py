"""AM306 — kernel launches register through the observatory.

The observatory (obs/prof.py) can only attribute dispatches, latencies and
shape buckets to a CUDA kernel if its launch sits inside the kernel's
wrapper program: a function registered with
``@profiled_program("kernel.<name>")`` (tpu/jitprof.py). The launch itself
is a plain C symbol of a library that ``kernels.load(...)`` builds and
loads (``lib.<name>_launch(...)``); calling it from anywhere else launches
the kernel where the profiling plane cannot see it, and the launch shows
up in no program's tally. (The JAX package's AM306 flags a bare
``jax.jit``, which torch does not have: the kernel launch is the port's
unregistered device entry.)

Flagged: a call ``<receiver>.<name>_launch(...)`` in a module that loads
kernel libraries (imports ``load`` from a ``kernels`` module or calls
``kernels.load``), unless the call sits lexically inside a function
decorated ``@profiled_program("kernel.…")``.

Exempt: lines carrying a justified ``# amlint: unprofiled-jit`` marker
(core.py treats the marker as a line suppression for this rule, same
trailing/standalone placement as ``disable=``).
"""
from __future__ import annotations

import ast

from .core import FileContext, Finding, dotted_name

#: the observatory wrapper's name and the program-name prefix of kernels
_WRAPPER = "profiled_program"
_KERNEL_PREFIX = "kernel."


def _loads_kernels(tree: ast.Module) -> bool:
    """Whether the module reaches ``kernels.load``: a from-import of
    ``load`` out of a ``kernels`` module, or an attribute call
    ``kernels.load(...)``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[-1] == "kernels":
            if any(alias.name == "load" for alias in node.names):
                return True
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.endswith("kernels.load"):
                return True
    return False


def _kernel_program(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call) or not dec.args:
            continue
        leaf = (dotted_name(dec.func) or "").rsplit(".", 1)[-1]
        arg = dec.args[0]
        if leaf == _WRAPPER and isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) and \
                arg.value.startswith(_KERNEL_PREFIX):
            return True
    return False


def _inside_kernel_program(node: ast.AST) -> bool:
    cur = getattr(node, "_amlint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                _kernel_program(cur):
            return True
        cur = getattr(cur, "_amlint_parent", None)
    return False


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for ctx in ctxs:
        if not _loads_kernels(ctx.tree):
            continue
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.endswith("_launch")):
                continue
            if _inside_kernel_program(node):
                continue
            findings.append(ctx.finding(
                "AM306", node,
                f"kernel launch `{node.func.attr}` outside a kernel.* "
                "profiled_program wrapper bypasses the observatory — "
                "launch it inside the kernel's @profiled_program(\"kernel."
                "…\") wrapper (or justify with `# amlint: unprofiled-jit`)",
            ))
    return findings

"""AM303 — no metric/span recording in traced code: JAX only.

In the JAX package a counter ``inc()`` or a ``with trace.span(...)``
inside code that jax traces runs ONCE at trace time and is baked out of
the compiled program, so the rule keeps recording in the host wrappers
around a dispatch. PyTorch runs every device program's Python on every
call: a metric recorded inside one counts every call, as it does in any
host function. The rule keeps its ID in the catalog (``core.JAX_ONLY``
gives the reason, and ``--list-rules`` marks it) and never fires here.
"""
from __future__ import annotations

from .core import FileContext, Finding


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    return []

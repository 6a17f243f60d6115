"""amlint — repo-native static analysis for automerge_tpu_torch.

The port's copy of the JAX package's analyzer (``automerge_tpu/analysis``),
keyed on this package and reading PyTorch where the JAX one reads JAX. The
port's correctness hangs on invariants the type system cannot see: the
merge-key bit layout (``slot << 44 | ctr << 20 | actor``), the interner
packing caps, the hidden syncs a device program must not take, and the
host/device module split. This package enforces them over the AST
(tests/test_torch_analysis.py holds the port to zero unsuppressed
findings). It imports nothing of the JAX package.

Library API::

    from automerge_tpu_torch.analysis import run_analysis
    findings = run_analysis(["automerge_tpu_torch"])  # unsuppressed only
    everything = run_analysis(paths, include_suppressed=True)

CLI::

    python -m automerge_tpu_torch.analysis [paths...]   # exit 1 on findings
    python -m automerge_tpu_torch.analysis --list-rules
    python -m automerge_tpu_torch.analysis --select AM403,AM701
    python -m automerge_tpu_torch.analysis --changed HEAD~1   # incremental
    python -m automerge_tpu_torch.analysis --json

Exit codes are pinned: 0 = clean, 1 = unsuppressed findings, 2 = usage
error (unknown rule id in ``--select`` or an ``# amlint: disable=``
directive, unreadable path, bad ``--changed`` ref) — usage errors print
one line to stderr, never a traceback.

Every scan builds a whole-program :class:`graph.CallGraph` over the file
set and hands it to every rule family, so the reachability rules (AM2xx
device-program taint, AM403 blocking-in-serve, AM502/AM305 worker import
hygiene) are *transitive*: they follow calls and imports across files —
from-imports, module aliases, inferable method receivers — with bounded
depth, and print the discovery chain (``[reachable via a -> b -> c]``) in
every diagnostic.

Rule IDs and families are the JAX package's (see core.RULES):

- **AM1xx packing/hotpath**, **AM304/AM305**, **AM401/AM402/AM404**,
  **AM5xx mesh**, **AM6xx durability**: the same meaning as in the JAX
  package, over this package's modules (the README's metric catalog is
  the one the JAX package reads: the port records under the same names).
- **Torch meaning**: a device program is a ``@profiled_program`` function
  (the kernel wrappers ``kernel.*`` among them), where the JAX package
  reads traced code. AM201/AM202: Python control flow on a tensor, and
  host calls (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``int/float/bool``, ``np.*``) on one — each a hidden sync on the card;
  AM203: ``torch.tensor/as_tensor/zeros/ones/full/empty/arange`` or the
  numpy forms without a dtype in a module that imports torch; AM301: a
  host-only module imports ``torch`` or ``automerge_tpu_torch.tpu``;
  AM302/AM403: the sync and blocking sets add ``torch.cuda.synchronize``,
  ``.cpu()``, ``.numpy()`` and ``.item()``; AM306: a ``kernels.load``
  library's ``*_launch`` symbol called outside a ``kernel.*`` wrapper
  program; AM701: ``profiled_program`` and ``_dispatch`` sites fed an
  unbucketed dynamic length (the observatory counts a new shape bucket as
  a compile).
- **JAX only** (``core.JAX_ONLY``): AM204 and AM303 keep their IDs and
  never fire: eager PyTorch reruns Python on every call, so nothing runs
  once at trace time and goes stale.

Suppression: ``# amlint: disable=AM102`` trailing a line or standing alone
on the line above; ``# amlint: disable-file=AM203`` for a whole file.

This package is stdlib-only by design: importing it (and running the CLI)
must never load torch or jax, so the gate runs on any host.
"""
from __future__ import annotations

import tokenize
from pathlib import Path

from . import (boundary, catalog, datarules, durability, hotpath, meshrules,
               obsrules, packing, profrules, protorules, shaperules, taxonomy,
               tracer, workerrules)
from .core import JAX_ONLY, RULES, FileContext, Finding, UsageError, \
    collect_files
from .graph import CallGraph

__all__ = [
    "JAX_ONLY",
    "RULES",
    "Finding",
    "UsageError",
    "CallGraph",
    "run_analysis",
    "format_report",
    "default_target",
]

#: every rule family, in report order — each exposes check(ctxs, graph)
FAMILIES = (packing, tracer, boundary, obsrules, catalog, taxonomy,
            hotpath, meshrules, workerrules, profrules, durability,
            shaperules, protorules, datarules)


def default_target() -> Path:
    """The automerge_tpu_torch package directory (the CLI's default scan
    root)."""
    return Path(__file__).resolve().parent.parent


def run_analysis(paths, include_suppressed: bool = False) -> list[Finding]:
    """Runs every rule family over the given files/directories.

    Returns findings sorted by (path, line, rule). Suppressed findings are
    dropped unless ``include_suppressed`` is set (they then carry
    ``suppressed=True``). Unparseable files yield an AM000 finding instead
    of raising. A suppression directive naming an unknown rule id raises
    :class:`UsageError` — a typo'd ``disable=`` silently un-suppresses,
    which is worse than failing loudly."""
    ctxs: list[FileContext] = []
    findings: list[Finding] = []
    for p in paths:
        if not Path(p).exists():
            raise UsageError(f"no such file or directory: {p}")
    for path, display in collect_files([Path(p) for p in paths]):
        try:
            ctxs.append(FileContext(path, display))
        except (SyntaxError, UnicodeDecodeError, tokenize.TokenError) as exc:
            findings.append(Finding("AM000", display, getattr(exc, "lineno", 1) or 1,
                                    0, f"could not parse: {exc}"))
        except OSError as exc:
            raise UsageError(f"cannot read {display}: {exc}") from exc
    for ctx in ctxs:
        for line, rid in ctx.unknown_suppressions:
            raise UsageError(
                f"{ctx.display}:{line}: unknown rule id {rid!r} in "
                f"suppression directive (see --list-rules)"
            )
    graph = CallGraph(ctxs)
    for family in FAMILIES:
        findings.extend(family.check(ctxs, graph))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id, f.col))
    if not include_suppressed:
        findings = [f for f in findings if not f.suppressed]
    return findings


def format_report(findings: list[Finding]) -> str:
    lines = [f.format() for f in findings]
    active = sum(1 for f in findings if not f.suppressed)
    suppressed = len(findings) - active
    tail = f"{active} finding(s)"
    if suppressed:
        tail += f", {suppressed} suppressed"
    lines.append(tail)
    return "\n".join(lines)

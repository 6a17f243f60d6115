"""Per-phase timing shim over the amtrace span layer (SURVEY.md §5.1).

Historically this module held the whole profiling layer: a flat per-phase
wall-clock accumulator behind a *module-global* ambient slot. The real
implementation now lives in ``automerge_tpu/obs/spans.py`` — nested span
trees, latency histograms, and ambient propagation via ``contextvars`` (so
concurrent farms in different threads/tasks no longer cross-pollute each
other's profiles). This module keeps the original surface working:

    prof = PhaseProfile()
    with prof.phase("decode"):
        ...
    prof.as_dict()   # {"decode": {"total_s": ..., "calls": ...}, ...}
    prof.table()     # flat breakdown, largest phase first

``PhaseProfile`` IS a ``Trace`` — phases recorded through it are spans
(nesting under the ambient span), and the flat ``totals``/``counts``/
``as_dict``/``table`` views aggregate the tree **by path** ("outer/inner"
keys; top-level phases keep their bare names, so the bench's phase table
is unchanged). Aggregating by *name* — the original shim behaviour —
silently merged same-named spans that lived under different parents,
losing their individual call counts in the table renderer; the path keys
keep every distinct span visible. ``get_profile()``/``use_profile()`` are
the span layer's ambient accessors, so a profile installed here is the
same object the farm's ``obs`` spans record into; `enabled=False` keeps
the historical one-attribute-test disabled cost.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations

from .obs.spans import Trace, get_trace, use_trace


class PhaseProfile(Trace):
    """Flat-view compatibility wrapper over a span tree."""

    __slots__ = ()

    @property
    def totals(self) -> dict[str, float]:
        return {path: t for path, (t, _) in self.totals_by_path().items()}

    @property
    def counts(self) -> dict[str, int]:
        return {path: c for path, (_, c) in self.totals_by_path().items()}

    def as_dict(self) -> dict:
        return {
            path: {"total_s": t, "calls": c}
            for path, (t, c) in sorted(self.totals_by_path().items())
        }

    def table(self) -> str:
        """Human-readable breakdown, largest phase first. Rows are keyed
        by span PATH, so two same-named phases under different parents
        render as two rows with their own times and call counts instead of
        one silently merged row."""
        flat = self.totals_by_path()
        if not flat:
            return "(no phases recorded)"
        width = max(len(n) for n in flat)
        # total time = top-level spans only (nested spans are already
        # inside their parents' wall time; summing every path would
        # double-count and deflate every percentage)
        total = sum(t for path, (t, _) in flat.items() if "/" not in path)
        lines = []
        for name in sorted(flat, key=lambda n: flat[n][0], reverse=True):
            t, calls = flat[name]
            pct = 100 * t / total if total else 0.0
            lines.append(
                f"{name.ljust(width)}  {t * 1e3:10.2f} ms  "
                f"{pct:5.1f}%  x{calls}"
            )
        return "\n".join(lines)


# the ambient accessors ARE the span layer's: one mechanism, two spellings
get_profile = get_trace
use_profile = use_trace

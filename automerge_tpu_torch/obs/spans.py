"""amtrace spans: nested wall-clock span trees with latency histograms.

The original `PhaseProfile` (automerge_tpu/profiling.py, now a shim over
this module) accumulated flat per-name totals behind a *module-global*
ambient slot — unusable once two farms run in different threads or asyncio
tasks. This module replaces it with:

- **Span trees**: `Trace.span(name)` opens a nested span; each distinct
  (parent, name) node accumulates wall time, call count and a fixed-bucket
  latency histogram from which p50/p95/p99 are read. Trees render as an
  indented table (`Trace.tree_table()`) and export/import as JSON lines
  (`Trace.to_jsonl()` / `Trace.from_jsonl()`) so a bench run on one host
  can be inspected on another.
- **Ambient propagation via `contextvars`**: `use_trace(trace)` installs
  the trace for the current *context* (thread / asyncio task), so
  concurrent farms never cross-pollute each other's profiles
  (tests/test_obs.py::test_two_interleaved_contexts_do_not_cross_pollute).
- **Near-zero disabled cost**: `Trace(enabled=False).span(...)` performs a
  single attribute test and never touches the clock or allocates a node
  (asserted by tests/test_obs.py::test_disabled_span_is_attribute_test_only).

Histogram buckets are log2-spaced: bucket i covers
[1µs·2^i, 1µs·2^(i+1)), 28 buckets spanning 1µs to ~134s; out-of-range
durations clamp to the first/last bucket. Quantiles report the upper bound
of the bucket where the cumulative count crosses the quantile — a
deterministic over-estimate, the standard fixed-bucket convention.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations

import contextlib
import contextvars
import json
import math
import time
from typing import Iterator

#: log2-spaced histogram: bucket i covers [FLOOR * 2**i, FLOOR * 2**(i+1))
BUCKET_FLOOR_S = 1e-6
NUM_BUCKETS = 28


def bucket_index(seconds: float) -> int:
    """Histogram bucket for a duration; clamps below-floor and overflow."""
    if seconds < BUCKET_FLOOR_S:
        return 0
    i = int(math.log2(seconds / BUCKET_FLOOR_S))
    # float log2 can land one bucket low at exact powers of two
    if seconds >= BUCKET_FLOOR_S * (1 << (i + 1)):
        i += 1
    return min(i, NUM_BUCKETS - 1)


def bucket_bounds(index: int) -> tuple[float, float]:
    """[lo, hi) duration bounds of one histogram bucket, in seconds."""
    return BUCKET_FLOOR_S * (1 << index), BUCKET_FLOOR_S * (1 << (index + 1))


class SpanNode:
    """One node of a span tree: aggregate stats for a (parent, name) pair."""

    __slots__ = ("name", "total_s", "calls", "buckets", "children")

    def __init__(self, name: str):
        self.name = name
        self.total_s = 0.0
        self.calls = 0
        self.buckets: dict[int, int] = {}  # sparse: bucket index -> count
        self.children: dict[str, SpanNode] = {}

    def child(self, name: str) -> "SpanNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = SpanNode(name)
        return node

    def record(self, elapsed_s: float) -> None:
        self.total_s += elapsed_s
        self.calls += 1
        b = bucket_index(elapsed_s)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def percentile(self, q: float) -> float | None:
        """Upper bound of the bucket holding the q-quantile (q in [0, 1]),
        or None when the node has no recorded calls."""
        if self.calls == 0:
            return None
        threshold = q * self.calls
        cum = 0
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            if cum >= threshold:
                return bucket_bounds(b)[1]
        return bucket_bounds(max(self.buckets))[1]

    def as_dict(self) -> dict:
        out = {
            "name": self.name,
            "total_s": self.total_s,
            "calls": self.calls,
            "buckets": {str(b): c for b, c in sorted(self.buckets.items())},
        }
        if self.children:
            out["children"] = [
                c.as_dict() for c in self.children.values()
            ]
        return out


class Trace:
    """A span tree plus the enabled flag. See module docstring."""

    __slots__ = ("enabled", "root")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.root = SpanNode("")

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[SpanNode | None]:
        if not self.enabled:
            yield None
            return
        state = _STATE.get()
        parent = state[1] if state[0] is self else self.root
        node = parent.child(name)
        token = _STATE.set((self, node))
        start = time.perf_counter()
        try:
            yield node
        finally:
            node.record(time.perf_counter() - start)
            _STATE.reset(token)

    # the historical PhaseProfile spelling; same ambient/nesting semantics
    phase = span

    def reset(self) -> None:
        self.root = SpanNode("")

    # ------------------------------------------------------------------ #
    # aggregation (PhaseProfile compatibility surface)

    def totals_by_name(self) -> dict[str, tuple[float, int]]:
        """{name: (total_s, calls)} summed over every node of that name,
        anywhere in the tree — the flat view the old PhaseProfile kept.
        Distinct-path spans that share a name are MERGED here; renderers
        that must not lose per-path counts use ``totals_by_path``."""
        out: dict[str, tuple[float, int]] = {}
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            t, c = out.get(node.name, (0.0, 0))
            out[node.name] = (t + node.total_s, c + node.calls)
            stack.extend(node.children.values())
        return out

    def totals_by_path(self) -> dict[str, tuple[float, int]]:
        """{"outer/inner": (total_s, calls)} — one entry per distinct tree
        path (root children are bare names). Unlike ``totals_by_name``,
        same-named spans under different parents keep their own totals and
        call counts, so a flat renderer cannot silently merge them."""
        out: dict[str, tuple[float, int]] = {}

        def walk(node: SpanNode, prefix: str) -> None:
            for child in node.children.values():
                path = f"{prefix}/{child.name}" if prefix else child.name
                out[path] = (child.total_s, child.calls)
                walk(child, path)

        walk(self.root, "")
        return out

    # ------------------------------------------------------------------ #
    # rendering

    def tree_table(self) -> str:
        """Indented span tree with totals, call counts and p50/p95/p99."""
        rows: list[tuple[str, SpanNode]] = []

        def walk(node: SpanNode, depth: int) -> None:
            rows.append(("  " * depth + node.name, node))
            for child in sorted(
                node.children.values(), key=lambda n: n.total_s, reverse=True
            ):
                walk(child, depth + 1)

        for top in sorted(
            self.root.children.values(), key=lambda n: n.total_s, reverse=True
        ):
            walk(top, 0)
        if not rows:
            return "(no spans recorded)"

        width = max(len(label) for label, _ in rows)
        header = (
            f"{'span'.ljust(width)}  {'total':>12}  {'calls':>7}  "
            f"{'p50':>9}  {'p95':>9}  {'p99':>9}"
        )
        lines = [header]
        for label, node in rows:
            lines.append(
                f"{label.ljust(width)}  {_fmt_s(node.total_s):>12}  "
                f"{node.calls:>7}  {_fmt_s(node.percentile(0.50)):>9}  "
                f"{_fmt_s(node.percentile(0.95)):>9}  "
                f"{_fmt_s(node.percentile(0.99)):>9}"
            )
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    # JSON-lines export / import

    def to_jsonl(self) -> str:
        """One JSON object per span node, carrying its path from the root —
        a flat, stream-appendable trace dump."""
        lines: list[str] = []

        def walk(node: SpanNode, path: list[str]) -> None:
            lines.append(json.dumps({
                "path": path,
                "total_s": node.total_s,
                "calls": node.calls,
                "buckets": {str(b): c for b, c in sorted(node.buckets.items())},
            }, sort_keys=True))
            for child in node.children.values():
                walk(child, path + [child.name])

        for top in self.root.children.values():
            walk(top, [top.name])
        return "\n".join(lines) + ("\n" if lines else "")

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        """Rebuilds a trace from `to_jsonl` output (order-insensitive;
        repeated paths accumulate, so concatenated dumps merge)."""
        trace = cls()
        trace.absorb_jsonl(text)
        return trace

    def absorb_jsonl(self, text: str) -> "Trace":
        """Merges a `to_jsonl` dump into THIS trace in place (same
        accumulate-on-repeated-path semantics as ``from_jsonl``). This is
        how a mesh worker's phase totals land in the controller's ambient
        profile: the worker runs its shard dispatch under its own trace,
        ships ``to_jsonl()`` back with the result frame, and the
        controller absorbs it — so ``--watch`` still attributes
        device_dispatch/transcode time per shard even when the shard
        lives in another process."""
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            node = self.root
            for name in entry["path"]:
                node = node.child(name)
            node.total_s += entry["total_s"]
            node.calls += entry["calls"]
            for b, c in entry.get("buckets", {}).items():
                b = int(b)
                node.buckets[b] = node.buckets.get(b, 0) + c
        return self


def _fmt_s(seconds: float | None) -> str:
    if seconds is None:
        return "-"
    if seconds >= 1.0:
        return f"{seconds:.2f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds * 1e6:.0f} us"


# ---------------------------------------------------------------------- #
# ambient trace: per-context (thread / asyncio task), never a module global

_NULL = Trace(enabled=False)
#: (active trace, current span node) for the running context
_STATE: contextvars.ContextVar[tuple[Trace, SpanNode]] = contextvars.ContextVar(
    "amtrace_state", default=(_NULL, _NULL.root)
)


def get_trace() -> Trace:
    """The ambient trace (a disabled no-op unless one is installed)."""
    return _STATE.get()[0]


@contextlib.contextmanager
def use_trace(trace: Trace) -> Iterator[Trace]:
    """Installs `trace` as the ambient trace for the dynamic extent, in the
    current context only."""
    token = _STATE.set((trace, trace.root))
    try:
        yield trace
    finally:
        _STATE.reset(token)

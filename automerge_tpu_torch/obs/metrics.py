"""amtrace metrics: counters, gauges and histograms in one process-wide
registry.

Spans (obs/spans.py) answer "where did the time go"; metrics answer "what
did the pipeline do": batch occupancy and pad waste in the farm, jit cache
hits vs recompiles in the engine, message/byte/Bloom-probe counts in the
sync layer. Instruments are fetched by name from the registry — two
modules asking for ``counter("sync.messages.generated")`` share one
instrument, so the sequential protocol (sync.py) and the batched farm
(tpu/sync_farm.py) accumulate into the same totals.

Recording is host-side only (amlint AM303 forbids instrument calls inside
jit/vmap/Pallas-reachable code) and near-zero-cost when disabled: every
``inc``/``set``/``observe`` starts with a single attribute test and does
no further work (asserted by tests/test_obs.py). The process-wide registry
starts *disabled*; bench.py and the obs CLI enable it around their
workloads, so library users pay nothing unless they opt in.

Histograms reuse the span layer's log2 bucket grid, which doubles as a
general positive-float grid (e.g. occupancy ratios in (0, 1] land in the
sub-1.0 buckets); quantiles report bucket upper bounds.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations

import contextlib
from typing import Iterator

from .spans import bucket_bounds, bucket_index


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "help", "enabled", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.enabled = False
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if not self.enabled:
            return
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-observed value (e.g. the current pad-waste ratio)."""

    __slots__ = ("name", "help", "enabled", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.enabled = False
        self.value = 0.0

    def set(self, v: float) -> None:
        if not self.enabled:
            return
        self.value = v

    def reset(self) -> None:
        self.value = 0.0

    def snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket distribution of positive floats (log2 grid shared with
    the span layer).

    Each bucket may carry one **exemplar** — an opaque id (an amscope
    trace/dispatch id) of a recent observation that landed in it — so a
    percentile spike is one ``exemplar_for(q)`` lookup away from the
    request trace that produced it."""

    __slots__ = ("name", "help", "enabled", "buckets", "count", "sum",
                 "exemplars")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.enabled = False
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.exemplars: dict[int, object] = {}

    def observe(self, v: float, exemplar=None) -> None:
        if not self.enabled:
            return
        b = bucket_index(v)
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.sum += v
        if exemplar is not None:
            self.exemplars[b] = exemplar

    def percentile_bucket(self, q: float) -> int | None:
        """Bucket index holding the q-quantile, or None when empty."""
        if self.count == 0:
            return None
        threshold = q * self.count
        cum = 0
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            if cum >= threshold:
                return b
        return max(self.buckets)

    def percentile(self, q: float) -> float | None:
        b = self.percentile_bucket(q)
        return None if b is None else bucket_bounds(b)[1]

    def exemplar_for(self, q: float):
        """The exemplar recorded in the q-quantile's bucket (e.g. the
        trace id behind the p99), or None when that bucket has none."""
        b = self.percentile_bucket(q)
        return None if b is None else self.exemplars.get(b)

    def reset(self) -> None:
        self.buckets = {}
        self.count = 0
        self.sum = 0.0
        self.exemplars = {}

    def snapshot(self):
        out = {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }
        if self.exemplars:
            out["exemplars"] = {
                str(b): e for b, e in sorted(self.exemplars.items())
            }
        return out


class MetricsRegistry:
    """Name -> instrument table with a single enable switch.

    ``enabled`` is mirrored onto every instrument at creation and on
    enable()/disable(), so the per-record hot path tests one attribute on
    the instrument itself and never chases the registry."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._instruments: dict[str, object] = {}

    # ------------------------------------------------------------------ #

    def _get(self, cls, name: str, help: str):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help)
            inst.enabled = self.enabled
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def find(self, name: str):
        """Read-only lookup: the registered instrument, or None. Unlike
        the typed getters this never registers — readers (the SLO engine,
        exposition renderers) must not invent instruments."""
        return self._instruments.get(name)

    # ------------------------------------------------------------------ #

    def enable(self) -> None:
        self.enabled = True
        for inst in self._instruments.values():
            inst.enabled = True

    def disable(self) -> None:
        self.enabled = False
        for inst in self._instruments.values():
            inst.enabled = False

    def reset(self) -> None:
        """Zeroes every instrument (registrations and help text survive).

        Reset semantics are uniform: every instrument class owns its own
        ``reset()`` and the registry only delegates, so a Counter's zero, a
        Gauge's zero, and a Histogram's empty-percentile state (count 0,
        ``percentile`` -> None, exemplars cleared) can never drift apart —
        the reset-consistency bug class where a derived gauge survived a
        reset its source counters did not (pinned by
        tests/test_obs.py::test_reset_is_uniform_across_instrument_types)."""
        for inst in self._instruments.values():
            inst.reset()

    # ------------------------------------------------------------------ #
    # frames: the cross-process shipping format. A mesh worker records
    # into ITS OWN process-wide registry, periodically takes frame(),
    # diffs against the last-shipped frame, and sends the delta with the
    # result; the controller merge_frame()s it into the controller
    # registry. Counters/histograms accumulate (deltas), gauges are
    # last-writer-wins — the same semantics a scrape-and-sum pipeline
    # would apply.

    def frame(self) -> dict:
        """{name: (kind, help, payload)} snapshot of raw instrument state
        (picklable, no instrument objects). Counter/gauge payload is the
        value; histogram payload is (buckets, count, sum, exemplars) —
        exemplars ride along so a worker-stamped trace id survives the
        trip back to the controller registry."""
        out = {}
        for name, inst in self._instruments.items():
            if isinstance(inst, Histogram):
                out[name] = (
                    "histogram", inst.help,
                    (dict(inst.buckets), inst.count, inst.sum,
                     dict(inst.exemplars)),
                )
            elif isinstance(inst, Gauge):
                out[name] = ("gauge", inst.help, inst.value)
            else:
                out[name] = ("counter", inst.help, inst.value)
        return out

    def merge_frame(self, frame: dict) -> None:
        """Accumulates a (delta) frame into this registry: counters are
        inc'd, histogram buckets/count/sum are added (bucket exemplars:
        last writer wins, like gauges), gauges are set. Instruments are
        registered on first sight with the frame's help text. No-op while
        the registry is disabled (instruments drop the records anyway;
        skipping keeps disabled-path cost flat)."""
        if not self.enabled:
            return
        for name, (kind, help, payload) in sorted(frame.items()):
            if kind == "histogram":
                h = self.histogram(name, help)
                buckets, count, sum_, exemplars = payload
                for b, c in buckets.items():
                    h.buckets[b] = h.buckets.get(b, 0) + c
                h.count += count
                h.sum += sum_
                for b, e in exemplars.items():
                    if e is not None:
                        h.exemplars[b] = e
            elif kind == "gauge":
                self.gauge(name, help).set(payload)
            else:
                self.counter(name, help).inc(payload)


    # ------------------------------------------------------------------ #

    def as_dict(self) -> dict:
        return {
            name: self._instruments[name].snapshot()
            for name in sorted(self._instruments)
        }

    def table(self, skip_zero: bool = False) -> str:
        """Human-readable metrics table, sorted by name."""
        rows = []
        for name in sorted(self._instruments):
            snap = self._instruments[name].snapshot()
            if snap["type"] == "histogram":
                if skip_zero and snap["count"] == 0:
                    continue
                detail = (
                    f"count={snap['count']} sum={snap['sum']:.4g} "
                    f"p50={_fmt(snap['p50'])} p95={_fmt(snap['p95'])} "
                    f"p99={_fmt(snap['p99'])}"
                )
            else:
                if skip_zero and not snap["value"]:
                    continue
                detail = _fmt(snap["value"])
            rows.append((name, snap["type"], detail))
        if not rows:
            return "(no metrics recorded)"
        width = max(len(name) for name, _, _ in rows)
        return "\n".join(
            f"{name.ljust(width)}  {type_:9s}  {detail}"
            for name, type_, detail in rows
        )


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def diff_frames(current: dict, previous: dict) -> dict:
    """The delta frame that, ``merge_frame``'d after `previous`, yields
    `current`: counter values subtract, histogram buckets/count/sum
    subtract (unchanged buckets drop), gauges pass through as-is.
    Entries with nothing new are omitted — a quiet worker ships an empty
    dict."""
    out = {}
    for name, (kind, help, payload) in current.items():
        prev = previous.get(name)
        if kind == "counter":
            base = prev[2] if prev else 0
            if payload != base:
                out[name] = (kind, help, payload - base)
        elif kind == "gauge":
            if prev is None or payload != prev[2]:
                out[name] = (kind, help, payload)
        else:
            buckets, count, sum_, exemplars = payload
            pb, pc, ps, pe = prev[2] if prev else ({}, 0, 0.0, {})
            if count != pc:
                delta = {
                    b: c - pb.get(b, 0)
                    for b, c in buckets.items()
                    if c != pb.get(b, 0)
                }
                # ship only exemplars that changed (or are new) since the
                # last frame: the steady-state delta stays small
                ex_delta = {
                    b: e for b, e in exemplars.items() if e != pe.get(b)
                }
                out[name] = (
                    kind, help, (delta, count - pc, sum_ - ps, ex_delta)
                )
    return out


# ---------------------------------------------------------------------- #
# the process-wide registry (disabled until a workload opts in)

_GLOBAL = MetricsRegistry(enabled=False)


def get_metrics() -> MetricsRegistry:
    """The process-wide registry every instrumented module records into."""
    return _GLOBAL


@contextlib.contextmanager
def enabled_metrics(
    registry: MetricsRegistry | None = None,
) -> Iterator[MetricsRegistry]:
    """Enables a registry (the process-wide one by default) for the dynamic
    extent, restoring the previous enabled state on exit."""
    reg = registry if registry is not None else _GLOBAL
    was_enabled = reg.enabled
    reg.enable()
    try:
        yield reg
    finally:
        if not was_enabled:
            reg.disable()

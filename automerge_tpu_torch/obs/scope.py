"""amscope request-flow tracing: per-request causal attribution for the
serving stack.

amtrace's metrics are process-wide aggregates and its spans are local
wall-clock trees — neither can answer "where did THIS client's change
spend its 40 ms", because one request's journey crosses the session
multiplexer, a batching window shared with strangers, one batched farm
dispatch serving N requests at once, and the ack fan-out. This module
adds the request dimension on top, with no wire-format changes:

- **RequestScope** — a host-side trace context (trace id, tenant, doc,
  client) attached to each frame at ``AmServer.receive`` and carried
  through admission, ``DynamicBatcher`` window membership and commit.
  Lifecycle marks (``received`` -> ``flush`` -> ``committed`` ->
  ``sent``) are stamped with the *injected* clock, so simulated-time
  harnesses price the batching window exactly as a client feels it.
- **DispatchSpan** — ONE batched farm dispatch linking the N request
  traces it served, carrying the per-phase host durations (decode,
  gate+transcode, pack, device_dispatch, visibility readback, patch
  assembly) captured from the farm's phase profile around the dispatch.
  Every member request shares the span's phase breakdown — that is the
  honest attribution for batched execution.
- **Exemplars** — the request/phase histograms record each observation's
  trace id into its bucket (obs/metrics.py), so a p99 spike is one
  ``exemplar_for(0.99)`` lookup from the request trace behind it.
- **Per-tenant accounting** — requests, changes, bytes, sheds,
  backpressure rejections and a latency histogram per tenant, rendered
  as a table (the ``--watch`` CLI's top panel).

Disabled cost: ``attach`` tests one attribute and returns None; every
propagation point is then an ``is None`` test (asserted by
tests/test_torch_scope.py). The whole layer sits behind the same
disabled-by-default opt-in discipline as the metrics registry.

This is the port's own copy of the JAX package's ``obs/scope.py``, over the
port's own metrics registry, flight recorder and tracer: nothing it
registers touches the JAX package's process-wide state.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import contextlib
import contextvars
from collections import deque
from typing import Iterator

from .metrics import Histogram, get_metrics

_METRICS = get_metrics()

# request-lifecycle histograms (ms, injected-clock units). Exemplars carry
# the request trace id, so the p99 bucket names a concrete trace.
_M_E2E = _METRICS.histogram(
    "serve.request.e2e_ms",
    "receive -> ack-send per request (injected clock); exemplars carry "
    "trace ids",
)
_M_QUEUE_WAIT = _METRICS.histogram(
    "serve.request.queue_wait_ms",
    "receive -> batching-window flush per request (the window's price)",
)
_M_DISPATCH = _METRICS.histogram(
    "serve.request.dispatch_ms",
    "window flush -> commit per request (the batched farm dispatch)",
)
_M_ACK = _METRICS.histogram(
    "serve.request.ack_ms",
    "commit -> ack-send per request (the pump fan-out)",
)

# per-dispatch phase histograms (ms, host clock): the shared breakdown of
# one batched dispatch, attributed to every member request. Exemplars
# carry dispatch span ids.
PHASE_HISTOGRAMS: dict[str, Histogram] = {
    "decode": _METRICS.histogram(
        "serve.phase.decode_ms", "chunk decode share of serve dispatches"
    ),
    "gate_verdicts": _METRICS.histogram(
        "serve.phase.gate_verdicts_ms",
        "columnar causal-gate verdict share of serve dispatches",
    ),
    "transcode_columns": _METRICS.histogram(
        "serve.phase.transcode_columns_ms",
        "cached-column transcode share of serve dispatches",
    ),
    "gate+transcode": _METRICS.histogram(
        "serve.phase.gate_transcode_ms",
        "scalar-oracle gate + row transcode share of serve dispatches",
    ),
    "pack": _METRICS.histogram(
        "serve.phase.pack_ms", "batch packing share of serve dispatches"
    ),
    "device_dispatch": _METRICS.histogram(
        "serve.phase.device_dispatch_ms",
        "device merge program share of serve dispatches",
    ),
    "visibility": _METRICS.histogram(
        "serve.phase.readback_ms",
        "visibility readback share of serve dispatches",
    ),
    "patch_assembly": _METRICS.histogram(
        "serve.phase.assembly_ms",
        "patch assembly share of serve dispatches",
    ),
    "generate": _METRICS.histogram(
        "serve.phase.generate_ms",
        "batched sync generate share of serve pump sweeps",
    ),
}


class RequestScope:
    """One frame's journey through the front door. Slots only — the hot
    path allocates exactly one of these per admitted frame."""

    __slots__ = ("trace_id", "tenant", "doc", "client_id", "bytes_in",
                 "marks", "phases", "dispatch_id", "changes", "outcome")

    def __init__(self, trace_id, tenant, doc, client_id, bytes_in=0):
        self.trace_id = trace_id
        self.tenant = tenant
        self.doc = doc
        self.client_id = client_id
        self.bytes_in = bytes_in
        self.marks: dict[str, float] = {}
        self.phases: dict[str, float] | None = None  # shared dispatch phases (s)
        self.dispatch_id = None
        self.changes = 0
        self.outcome = None

    def mark(self, name: str, t: float) -> None:
        self.marks[name] = t

    def breakdown(self) -> dict[str, float]:
        """Per-request phase durations in ms: lifecycle segments from the
        injected-clock marks plus the owning dispatch's shared host
        phases. Only segments whose marks exist appear."""
        m = self.marks
        out: dict[str, float] = {}
        if "received" in m and "flush" in m:
            out["queue_wait_ms"] = (m["flush"] - m["received"]) * 1000.0
        if "flush" in m and "committed" in m:
            out["dispatch_ms"] = (m["committed"] - m["flush"]) * 1000.0
        if "committed" in m and "sent" in m:
            out["ack_ms"] = (m["sent"] - m["committed"]) * 1000.0
        if "received" in m and "sent" in m:
            out["e2e_ms"] = (m["sent"] - m["received"]) * 1000.0
        if self.phases:
            for phase, seconds in self.phases.items():
                out[f"phase.{phase}_ms"] = seconds * 1000.0
        return out

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "doc": self.doc,
            "client": repr(self.client_id),
            "bytes_in": self.bytes_in,
            "changes": self.changes,
            "outcome": self.outcome,
            "dispatch_id": self.dispatch_id,
            "marks": dict(self.marks),
            "breakdown": self.breakdown(),
        }


class DispatchSpan:
    """One batched farm dispatch and the request traces it served."""

    __slots__ = ("dispatch_id", "trace_ids", "t_start", "t_end", "phases",
                 "docs", "changes")

    def __init__(self, dispatch_id, trace_ids, t_start):
        self.dispatch_id = dispatch_id
        self.trace_ids = list(trace_ids)
        self.t_start = t_start
        self.t_end = None
        self.phases: dict[str, float] = {}
        self.docs = 0
        self.changes = 0

    def as_dict(self) -> dict:
        return {
            "dispatch_id": self.dispatch_id,
            "trace_ids": list(self.trace_ids),
            "t_start": self.t_start,
            "t_end": self.t_end,
            "docs": self.docs,
            "changes": self.changes,
            "phases_s": dict(self.phases),
        }


class TenantStats:
    """Per-tenant accounting row (the --watch table's columns)."""

    __slots__ = ("tenant", "requests", "changes", "bytes_in", "shed",
                 "backpressure", "rejected", "latency")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.requests = 0
        self.changes = 0
        self.bytes_in = 0
        self.shed = 0
        self.backpressure = 0
        self.rejected = 0
        self.latency = Histogram(f"tenant:{tenant}")
        self.latency.enabled = True  # standalone, lives and dies with amscope

    def as_dict(self) -> dict:
        return {
            "requests": self.requests,
            "changes": self.changes,
            "bytes_in": self.bytes_in,
            "shed": self.shed,
            "backpressure": self.backpressure,
            "rejected": self.rejected,
            "latency_ms": {
                "p50": self.latency.percentile(0.50),
                "p95": self.latency.percentile(0.95),
                "p99": self.latency.percentile(0.99),
                "samples": self.latency.count,
            },
        }


class Amscope:
    """The request-flow tracer: scope factory, dispatch-span registry and
    per-tenant accounting table. Disabled by default — ``attach`` is one
    attribute test when off; every downstream propagation point carries a
    scope of None and costs an identity test."""

    def __init__(self, recent: int = 512, recent_dispatches: int = 128):
        self.enabled = False
        self.recent: deque = deque(maxlen=recent)
        self.dispatches: deque = deque(maxlen=recent_dispatches)
        self.tenants: dict[str, TenantStats] = {}
        self._seq = 0

    # -------------------------------------------------------------- #
    # lifecycle

    def attach(self, tenant, doc, client_id, t, nbytes: int = 0
               ) -> RequestScope | None:
        """Creates the trace context for one received frame (or None when
        disabled). Counts the request and its bytes against the tenant."""
        if not self.enabled:
            return None
        self._seq += 1
        scope = RequestScope(
            f"t{self._seq:08x}", tenant, doc, client_id, nbytes
        )
        scope.mark("received", t)
        stats = self._tenant(tenant)
        stats.requests += 1
        stats.bytes_in += nbytes
        return scope

    def drop(self, scope: RequestScope, reason: str) -> None:
        """Terminal for a frame the front door refused or discarded:
        ``shed`` (quarantine admission / mid-window exclusion),
        ``backpressure`` (tenant budget), ``rejected`` (corrupt/invalid).
        Counted per tenant; no latency sample (nothing completed)."""
        scope.outcome = reason
        stats = self._tenant(scope.tenant)
        if reason == "backpressure":
            stats.backpressure += 1
        elif reason == "rejected":
            stats.rejected += 1
        else:
            stats.shed += 1
        self.recent.append(scope)

    def finish(self, scope: RequestScope, outcome: str = "ok") -> None:
        """Terminal for a frame that ran its course. Observes whichever
        lifecycle segments its marks cover (an envelope-only frame has no
        commit and contributes no dispatch sample) with the trace id as
        the bucket exemplar, and prices the tenant's latency."""
        scope.outcome = outcome
        bd = scope.breakdown()
        tid = scope.trace_id
        if "queue_wait_ms" in bd:
            _M_QUEUE_WAIT.observe(max(bd["queue_wait_ms"], 1e-6), exemplar=tid)
        if "dispatch_ms" in bd:
            _M_DISPATCH.observe(max(bd["dispatch_ms"], 1e-6), exemplar=tid)
        if "ack_ms" in bd:
            _M_ACK.observe(max(bd["ack_ms"], 1e-6), exemplar=tid)
        if "e2e_ms" in bd:
            e2e = max(bd["e2e_ms"], 1e-6)
            _M_E2E.observe(e2e, exemplar=tid)
            stats = self._tenant(scope.tenant)
            stats.changes += scope.changes
            stats.latency.observe(e2e)
        self.recent.append(scope)

    # -------------------------------------------------------------- #
    # dispatch spans (one batched farm dispatch <- N request traces)

    def begin_dispatch(self, trace_ids, t) -> DispatchSpan:
        self._seq += 1
        return DispatchSpan(f"d{self._seq:08x}", trace_ids, t)

    def end_dispatch(self, span: DispatchSpan, t, phases: dict[str, float],
                     docs: int, changes: int) -> None:
        """Closes a dispatch span: stores the farm's per-phase host
        durations and observes them on the serve.phase.* histograms with
        the span id as exemplar."""
        span.t_end = t
        span.phases = dict(phases)
        span.docs = docs
        span.changes = changes
        for phase, seconds in phases.items():
            hist = PHASE_HISTOGRAMS.get(phase)
            if hist is not None:
                hist.observe(max(seconds * 1000.0, 1e-6),
                             exemplar=span.dispatch_id)
        self.dispatches.append(span)

    def observe_phase(self, phase: str, seconds: float, exemplar=None) -> None:
        """Records a standalone phase sample (the server's batched
        generate sweep, which runs outside any dispatch span)."""
        hist = PHASE_HISTOGRAMS.get(phase)
        if hist is not None:
            hist.observe(max(seconds * 1000.0, 1e-6), exemplar=exemplar)

    # -------------------------------------------------------------- #
    # tenant accounting

    def _tenant(self, tenant: str) -> TenantStats:
        stats = self.tenants.get(tenant)
        if stats is None:
            stats = self.tenants[tenant] = TenantStats(tenant)
        return stats

    def tenant_stats(self) -> dict:
        return {
            name: self.tenants[name].as_dict()
            for name in sorted(self.tenants)
        }

    def tenant_table(self) -> str:
        """The per-tenant accounting table: ops (changes), bytes, sheds,
        backpressure, rejects and latency percentiles."""
        if not self.tenants:
            return "(no tenant traffic recorded)"
        header = (
            f"{'tenant':12}  {'requests':>8}  {'changes':>8}  {'bytes':>10}  "
            f"{'shed':>6}  {'backpr':>6}  {'reject':>6}  "
            f"{'p50ms':>8}  {'p95ms':>8}  {'p99ms':>8}"
        )
        lines = [header]
        for name in sorted(self.tenants):
            s = self.tenants[name]
            lines.append(
                f"{name:12}  {s.requests:>8}  {s.changes:>8}  "
                f"{s.bytes_in:>10}  {s.shed:>6}  {s.backpressure:>6}  "
                f"{s.rejected:>6}  {_fmt(s.latency.percentile(0.50)):>8}  "
                f"{_fmt(s.latency.percentile(0.95)):>8}  "
                f"{_fmt(s.latency.percentile(0.99)):>8}"
            )
        return "\n".join(lines)

    # -------------------------------------------------------------- #

    def find(self, trace_id) -> RequestScope | None:
        """Looks a recent trace up by id (the exemplar -> trace jump)."""
        for scope in self.recent:
            if scope.trace_id == trace_id:
                return scope
        return None

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drops recent scopes/spans and the tenant table (the enabled
        flag and the id sequence survive)."""
        self.recent.clear()
        self.dispatches.clear()
        self.tenants = {}


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.3g}"


# ---------------------------------------------------------------------- #
# ambient dispatch context: lets the farm's dispatch/readback latency
# histograms carry the owning serve dispatch's span id as their exemplar
# without threading it through every call signature

_CURRENT_DISPATCH: contextvars.ContextVar = contextvars.ContextVar(
    "amscope_dispatch", default=None
)


def current_exemplar():
    """The ambient dispatch span id (None outside a serve dispatch). The
    ambient value is either a full ``DispatchSpan`` (controller side) or a
    bare span-id string restored from the fan-out payload inside a mesh
    worker (``exemplar_context``) — both stamp the same id."""
    span = _CURRENT_DISPATCH.get()
    if span is None:
        return None
    return span if isinstance(span, str) else span.dispatch_id


@contextlib.contextmanager
def dispatch_context(span: DispatchSpan) -> Iterator[DispatchSpan]:
    token = _CURRENT_DISPATCH.set(span)
    try:
        yield span
    finally:
        _CURRENT_DISPATCH.reset(token)


@contextlib.contextmanager
def exemplar_context(dispatch_id: str | None) -> Iterator[str | None]:
    """Worker-side trace propagation: restores a controller span id (as
    shipped in the apply fan-out payload) as the ambient exemplar, so the
    worker farm's ``farm.dispatch.latency_ms``/``farm.readback.latency_ms``
    observations stamp the controller's dispatch id without importing any
    controller state. ``None`` is a clean no-op ambient."""
    token = _CURRENT_DISPATCH.set(dispatch_id)
    try:
        yield dispatch_id
    finally:
        _CURRENT_DISPATCH.reset(token)


# ---------------------------------------------------------------------- #
# the process-wide tracer (disabled until a workload opts in)

_GLOBAL = Amscope()


def get_amscope() -> Amscope:
    """The process-wide request-flow tracer."""
    return _GLOBAL


@contextlib.contextmanager
def enabled_amscope(tracer: Amscope | None = None) -> Iterator[Amscope]:
    """Enables a tracer (the process-wide one by default) for the dynamic
    extent, restoring the previous enabled state on exit."""
    t = tracer if tracer is not None else _GLOBAL
    was_enabled = t.enabled
    t.enabled = True
    try:
        yield t
    finally:
        t.enabled = was_enabled

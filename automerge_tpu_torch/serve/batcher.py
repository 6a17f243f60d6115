"""Dynamic batching scheduler: many client sync frames, one farm dispatch.

The farm's device merge pays off only when fed dense batches — a
request-per-dispatch front door would leave the card idle nearly all the
time. ``DynamicBatcher`` is the continuous-batching layer between the
session multiplexer (serve/server.py) and the farm: payload frames from
many clients accumulate per document until the flush policy fires (≤T
seconds elapse in the window, or N documents are dirty), then ONE batched
inner receive (``SyncFarm.receive_messages``, which routes every staged
channel's changes through a single ``TorchDocFarm.apply_changes(
isolation="doc")``) commits them all, and the patches and owed sync
replies fan back out per session.

The envelope/apply split rides ``SyncSession.begin``/``commit``: at flush,
every staged frame's envelope is processed first (acks, dedup, epoch
handling), the surviving payloads are validated and dispatched as one
batch, and only successfully applied payloads are committed — so a
rejected payload is never acked and the client's retransmission retries
cleanly, exactly as in the unbatched path.

Admission control happens at ``submit`` time, before anything is queued:

- **quarantine-aware shedding** — a document in the farm's quarantine set
  is rejected with ``AdmissionRejectedError``; queueing its
  traffic would only grow a batch the farm will shed anyway. A doc that
  quarantines *mid-window* (poisoned by an earlier flush) is excluded
  from the flush it was queued into: its entries are dropped unacked, so
  the client retries after ``release_quarantine``.
- **per-tenant backpressure** — each tenant has a bounded pending-entry
  budget; past it, ``submit`` raises ``BackpressureError`` without
  enqueueing. The budget is returned when the window drains, so
  backpressure releases after a flush.

The batcher is farm-implementation-agnostic: it reads only
``farm.quarantine`` and the optional ``shard_of`` a sharded farm exposes
(``parallel.MeshFarm`` exposes it, with either backend). Over a process
mesh the per-submit quarantine check stays cheap: the controller answers
``farm.quarantine`` from its local mirror, with no worker round trip, and
a worker crash mid-flush quarantines the crashed shard's in-flight docs
under ``WorkerCrashError`` like any mid-window poisoning.

Everything is driven by the injected clock (``clock()`` in simulated or
real seconds) — no wall-clock reads, no sleeps, no blocking calls (amlint
AM402/AM403): the event loop or harness decides when ``flush`` runs.
"""
# amlint: error-taxonomy
from __future__ import annotations

from dataclasses import dataclass, field

from ..errors import (
    AdmissionRejectedError,
    BackpressureError,
    SyncFrameError,
    SyncProtocolError,
)
from ..obs.flight import get_flight
from ..obs.metrics import get_metrics
from ..obs.scope import dispatch_context, get_amscope
from ..sync import decode_sync_message
from ..sync_v2 import MESSAGE_TYPE_SYNC_V2, decode_sync_message_v2

_AMSCOPE = get_amscope()
_FLIGHT = get_flight()

_METRICS = get_metrics()
_M_ADMITTED = _METRICS.counter(
    "serve.admission.accepted", "frames admitted into the batching window"
)
_M_ADM_QUARANTINE = _METRICS.counter(
    "serve.admission.rejected_quarantine",
    "frames rejected at admission because the target doc is farm-quarantined",
)
_M_ADM_BACKPRESSURE = _METRICS.counter(
    "serve.admission.rejected_backpressure",
    "frames rejected at admission because the tenant's pending budget is full",
)
_M_QUEUE_DEPTH = _METRICS.gauge(
    "serve.queue.depth", "entries currently waiting in the batching window"
)
_M_DISPATCHES = _METRICS.counter(
    "serve.batch.dispatches", "flushes that issued a batched farm dispatch"
)
_M_OCCUPANCY = _METRICS.histogram(
    "serve.batch.occupancy",
    "documents carrying changes per batched farm dispatch",
)
_M_CHANGES = _METRICS.counter(
    "serve.batch.changes", "changes routed through batched dispatches"
)
_M_WINDOWS = _METRICS.counter(
    "serve.flush.windows", "non-empty batching windows flushed"
)
_M_SHED_QUARANTINED = _METRICS.counter(
    "serve.flush.shed_quarantined",
    "queued entries dropped at flush because their doc quarantined mid-window",
)
_M_REJECTED = _METRICS.counter(
    "serve.flush.frames_rejected",
    "queued frames rejected at flush (corrupt envelope or invalid payload; "
    "not acked, so the client retransmits)",
)
_M_DEFERRED = _METRICS.counter(
    "serve.flush.deferred",
    "entries pushed to the next window (their channel already staged a "
    "payload in this flush)",
)

# per-shard flush accounting when the farm is a MeshFarm (it exposes
# shard_of); registered lazily per shard id, full-literal-prefix names so
# the README catalog's <s> placeholder row matches
_SHARD_FLUSH_DOCS: dict[int, object] = {}


def _shard_flush_docs(s: int):
    c = _SHARD_FLUSH_DOCS.get(s)
    if c is None:
        c = _METRICS.counter(
            f"serve.flush.shard.{s}.docs",
            f"flushed change-carrying docs routed to mesh shard {s}",
        )
        _SHARD_FLUSH_DOCS[s] = c
    return c


@dataclass
class BatcherConfig:
    """Flush-policy knobs. Times are in the injected clock's units
    (seconds under the default monotonic clock and under ``ManualClock``).

    - ``flush_interval`` (T): a window flushes at most this long after its
      first entry arrived.
    - ``max_docs`` (N): a window flushes as soon as this many distinct
      documents are dirty, however young it is.
    - ``max_pending_per_tenant``: admission budget — entries a tenant may
      have waiting in the window before ``submit`` raises
      ``BackpressureError``.
    """

    flush_interval: float = 0.05
    max_docs: int = 64
    max_pending_per_tenant: int = 256


@dataclass
class FlushReport:
    """What one flush did: the fan-out inputs plus density accounting."""

    committed: list = field(default_factory=list)   # (channel, patch) pairs
    touched_docs: set = field(default_factory=set)  # docs whose heads may have moved
    changes_by_doc: dict = field(default_factory=dict)  # doc -> change buffers dispatched
    docs_dispatched: int = 0       # distinct docs carrying changes in the dispatch
    changes_applied: int = 0       # change buffers routed through the dispatch
    envelope_only: int = 0         # frames consumed by begin() (acks/dups/shed)
    shed_quarantined: int = 0      # entries dropped: doc quarantined mid-window
    rejected: int = 0              # frames rejected (corrupt/invalid; unacked)
    deferred: int = 0              # entries pushed to the next window
    quarantined_docs: set = field(default_factory=set)  # newly quarantined by this flush
    outcomes: object = None        # FarmApplyResult of the dispatch, or None

    @property
    def dispatched(self) -> bool:
        return self.docs_dispatched > 0


class DynamicBatcher:
    """Accumulates (channel, frame) entries and flushes them as one
    batched farm dispatch. See the module docstring for the policy; the
    owner (``AmServer`` or a harness) calls ``submit`` on arrival and
    ``flush`` whenever ``due()`` says the window fired."""

    def __init__(self, sync_farm, *, clock, config: BatcherConfig | None = None):
        self.sync = sync_farm
        self.farm = sync_farm.farm
        self.clock = clock
        self.config = config or BatcherConfig()
        self._entries: list = []          # (channel, frame_bytes), arrival order
        self._pending_by_tenant: dict[str, int] = {}
        self._dirty_docs: set[int] = set()
        self._window_start: float | None = None

    # -------------------------------------------------------------- #
    # admission

    def submit(self, channel, frame: bytes, scope=None) -> None:
        """Admits one frame into the current window, or rejects it without
        queueing: ``AdmissionRejectedError`` when the channel's doc is
        farm-quarantined (shed; nothing the batch could do would commit),
        ``BackpressureError`` when the tenant's pending budget is full.
        Rejected frames are simply not acked — the session layer's
        retransmission is the retry loop. ``scope`` is the frame's amscope
        trace context (None when request tracing is off); it rides the
        window entry so the flush can price the queue wait and link the
        request into the dispatch span."""
        if channel.doc in self.farm.quarantine:
            _M_ADM_QUARANTINE.inc()
            raise AdmissionRejectedError(
                f"document {channel.doc} is quarantined; traffic shed at "
                "admission (release_quarantine to restore)"
            )
        tenant = channel.tenant
        if (
            self._pending_by_tenant.get(tenant, 0)
            >= self.config.max_pending_per_tenant
        ):
            _M_ADM_BACKPRESSURE.inc()
            raise BackpressureError(
                f"tenant {tenant!r} has "
                f"{self._pending_by_tenant[tenant]} entries pending (budget "
                f"{self.config.max_pending_per_tenant}); back off and retry "
                "after the window drains"
            )
        if self._window_start is None:
            self._window_start = self.clock()
        self._entries.append((channel, frame, scope))
        self._pending_by_tenant[tenant] = (
            self._pending_by_tenant.get(tenant, 0) + 1
        )
        self._dirty_docs.add(channel.doc)
        _M_ADMITTED.inc()
        _M_QUEUE_DEPTH.set(len(self._entries))

    @property
    def pending(self) -> int:
        return len(self._entries)

    def pending_for(self, tenant: str) -> int:
        return self._pending_by_tenant.get(tenant, 0)

    def due(self, now: float | None = None) -> bool:
        """True when the window should flush: N distinct docs are dirty,
        or T has elapsed since the window opened. An empty window is never
        due — empty ticks dispatch nothing."""
        if not self._entries:
            return False
        if len(self._dirty_docs) >= self.config.max_docs:
            return True
        now = self.clock() if now is None else now
        return now - self._window_start >= self.config.flush_interval

    def next_deadline(self) -> float | None:
        """When the open window will become due by timer (None when the
        window is empty) — harnesses jump simulated time here."""
        if self._window_start is None:
            return None
        return self._window_start + self.config.flush_interval

    # -------------------------------------------------------------- #
    # the dispatch point

    def flush(self) -> FlushReport:
        """Drains the window: envelope-processes every queued frame,
        validates the payloads, dispatches all surviving channels' changes
        as ONE batched inner receive, commits and fans out. Entries whose
        doc quarantined mid-window are shed unacked; a channel with more
        than one queued payload keeps its extras for the next window
        (stop-and-wait means they are retransmissions or pipelined frames
        that must see the committed state first)."""
        report = FlushReport()
        if not self._entries:
            return report
        flush_reason = (
            "count" if len(self._dirty_docs) >= self.config.max_docs
            else "timer"
        )
        entries, self._entries = self._entries, []
        self._dirty_docs = set()
        self._window_start = None
        _M_WINDOWS.inc()
        now = self.clock()

        quarantined_before = set(self.farm.quarantine)
        staged = []      # (channel, pre, msg, scope) pending batched receive
        staged_docs = set()
        deferred = []
        for channel, frame, scope in entries:
            if channel.doc in quarantined_before:
                # quarantined mid-window: excluded from the flush it was
                # queued into; dropped unacked so the client retries later
                report.shed_quarantined += 1
                _M_SHED_QUARANTINED.inc()
                self._consume(channel)
                if scope is not None:
                    _AMSCOPE.drop(scope, "shed")
                continue
            try:
                pre = channel.session.begin(frame)
            except SyncFrameError:
                report.rejected += 1
                _M_REJECTED.inc()
                self._consume(channel)
                if scope is not None:
                    _AMSCOPE.drop(scope, "rejected")
                continue
            if pre is None:
                report.envelope_only += 1
                self._consume(channel)
                if scope is not None:
                    _AMSCOPE.finish(scope, outcome="envelope")
                continue
            if channel.doc in staged_docs:
                # one payload per DOC per dispatch: a second channel of
                # the same doc would force receive_messages off the
                # batched path (per-channel applies, one device dispatch
                # each — exactly the sparsity this layer exists to kill).
                # The frame waits one window (begin's envelope effects
                # are idempotent for an uncommitted payload; its seq is
                # still unacked, so re-processing it is the normal path).
                deferred.append((channel, frame, scope))
                continue
            payload = pre["payload"]
            is_v2 = bool(payload) and payload[0] == MESSAGE_TYPE_SYNC_V2
            try:
                msg = (
                    decode_sync_message_v2(payload) if is_v2
                    else decode_sync_message(payload)
                )
            except (SyncProtocolError, ValueError, TypeError, IndexError):
                if is_v2 and getattr(channel.session, "v2_local", False):
                    # the v2 fallback contract (sync_session): a poisoned
                    # v2 frame is ACKED with state unchanged — withholding
                    # the ack would retransmit the same frame until
                    # quarantine — and the session latches its downgrade
                    # to v1. Route this rare path through the unbatched
                    # receive, which carries exactly those semantics.
                    patch = channel.session.handle(frame)
                    report.committed.append((channel, patch))
                    report.touched_docs.add(channel.doc)
                    self._consume(channel)
                    if scope is not None:
                        _AMSCOPE.finish(scope, outcome="fallback")
                    continue
                # invalid inner payload: not committed, therefore not
                # acked — the peer's intact retransmission retries
                report.rejected += 1
                _M_REJECTED.inc()
                self._consume(channel)
                if scope is not None:
                    _AMSCOPE.drop(scope, "rejected")
                continue
            staged.append((channel, pre, msg, scope))
            staged_docs.add(channel.doc)
            self._consume(channel)

        if deferred:
            # re-open the window with the deferred entries (their tenant
            # budget is still held — they were admitted, not dropped)
            report.deferred = len(deferred)
            _M_DEFERRED.inc(len(deferred))
            self._entries = deferred
            self._dirty_docs = {c.doc for c, _, _ in deferred}
            self._window_start = now

        if _FLIGHT.enabled:
            _FLIGHT.record(
                "batcher.flush", t=now, reason=flush_reason,
                entries=len(entries), staged=len(staged),
                docs=len(staged_docs), deferred=report.deferred,
                shed=report.shed_quarantined, rejected=report.rejected,
            )

        if staged:
            triples = [
                (channel.doc, channel.session.state, pre["payload"])
                for channel, pre, _, _ in staged
            ]
            # ONE batched inner receive: every channel's changes route
            # through a single farm.apply_changes(isolation="doc"). When
            # request tracing is on, ONE DispatchSpan links every staged
            # request trace and captures the farm's per-phase breakdown
            # (the honest attribution for batched execution); the ambient
            # dispatch context lets the farm's latency histograms stamp
            # this span's id as their bucket exemplar.
            span = None
            if _AMSCOPE.enabled:
                span = _AMSCOPE.begin_dispatch(
                    [s.trace_id for _, _, _, s in staged if s is not None],
                    now,
                )
                for _, _, _, scope in staged:
                    if scope is not None:
                        scope.mark("flush", now)
                        scope.dispatch_id = span.dispatch_id
                from ..profiling import PhaseProfile, use_profile

                prof = PhaseProfile()
                with dispatch_context(span), use_profile(prof):
                    results = self.sync.receive_messages(triples)
            else:
                results = self.sync.receive_messages(triples)
            committed_at = self.clock()
            report.outcomes = self.sync.last_apply
            change_docs = {
                channel.doc
                for (channel, _, msg, _) in staged
                if msg["changes"]
            }
            report.changes_by_doc = {
                channel.doc: list(msg["changes"])
                for (channel, _, msg, _) in staged
                if msg["changes"]
            }
            report.docs_dispatched = len(change_docs)
            report.changes_applied = sum(
                len(msg["changes"]) for _, _, msg, _ in staged
            )
            if change_docs:
                _M_DISPATCHES.inc()
                _M_OCCUPANCY.observe(len(change_docs))
                _M_CHANGES.inc(report.changes_applied)
                shard_of = getattr(self.farm, "shard_of", None)
                if shard_of is not None and _METRICS.enabled:
                    # mesh-backed serving: label the flush's doc fan-out
                    # by owning shard (the sub-dispatch concurrency lives
                    # inside MeshFarm.apply_changes)
                    for doc in change_docs:
                        _shard_flush_docs(shard_of(doc)).inc()
            if span is not None:
                phases = {
                    path: entry["total_s"]
                    for path, entry in prof.as_dict().items()
                    if "/" not in path  # farm phases open at the root
                }
                _AMSCOPE.end_dispatch(
                    span, committed_at, phases=phases,
                    docs=len(change_docs), changes=report.changes_applied,
                )
            for (channel, pre, msg, scope), (state, patch) in zip(
                staged, results
            ):
                patch = channel.session.commit(pre, state, patch)
                report.committed.append((channel, patch))
                report.touched_docs.add(channel.doc)
                if scope is not None:
                    scope.mark("committed", committed_at)
                    scope.changes = len(msg["changes"])
                    scope.phases = span.phases if span is not None else None
                    # the ack rides the next outbound frame; the server's
                    # pump marks "sent" and finishes the scope
                    channel.pending_scopes.append(scope)

        report.quarantined_docs = (
            set(self.farm.quarantine) - quarantined_before
        )
        _M_QUEUE_DEPTH.set(len(self._entries))
        return report

    def _consume(self, channel) -> None:
        tenant = channel.tenant
        left = self._pending_by_tenant.get(tenant, 0) - 1
        if left > 0:
            self._pending_by_tenant[tenant] = left
        else:
            self._pending_by_tenant.pop(tenant, None)

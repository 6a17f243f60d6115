"""Session multiplexer: one supervised sync channel per client, one farm.

``AmServer`` is the front door a fleet of editors connects to. Each client
channel owns a ``SyncSession`` created through the batched farm's
``SyncFarm.make_session`` (or ``restore_session`` for resume-after-
restart), so every reliability property of the supervised protocol —
seq/ack framing, retransmission with backoff, duplicate idempotency,
epoch-based peer-restart detection, the convergence watchdog — holds per
channel with zero new wire format. Incoming payload frames do NOT apply
individually: they run through the ``DynamicBatcher``, which turns a
window of frames from many clients into one batched farm dispatch and
fans the patches and owed replies back out.

The core is sans-io and clock-injected: ``receive`` ingests a frame,
``tick`` flushes the batcher when its window is due, ``pump`` drains
every frame the sessions owe (acks, replies, retransmissions). A test, a
chaos harness or the load generator calls those three methods against a
``ManualClock`` and the whole service runs in simulated time (amlint
AM402/AM403 keep wall clocks and blocking calls out of this module). The
``serve_forever`` adapter binds the same core to asyncio streams with
length-prefixed frames for real transports.

Connect/resume/restart ride the existing epoch machinery:

- ``connect`` creates a fresh server-side session (new epoch). A client
  that restarts and reconnects keeps talking to the *same* server
  session, whose peer-restart detection sees the client's new epoch and
  re-handshakes cleanly.
- ``resume`` rebuilds a channel from a ``save_session`` blob after a
  *server* restart; clients observe the same epoch and continue without
  a restart exchange.
"""
from __future__ import annotations

import random
from dataclasses import replace as _dc_replace

from ..errors import (
    AdmissionRejectedError,
    AutomergeError,
    BackpressureError,
)
from ..obs.metrics import get_metrics
from ..obs.scope import get_amscope
from ..sync_session import SessionConfig, _default_clock
from ..tpu.sync_farm import SyncFarm
from .batcher import BatcherConfig, DynamicBatcher, FlushReport

_METRICS = get_metrics()
_AMSCOPE = get_amscope()
_M_CONNECTS = _METRICS.counter(
    "serve.sessions.connected", "client channels opened (connect)"
)
_M_RESUMES = _METRICS.counter(
    "serve.sessions.resumed", "client channels rebuilt from persisted state"
)
_M_DISCONNECTS = _METRICS.counter(
    "serve.sessions.disconnected", "client channels closed"
)
_M_ACTIVE = _METRICS.gauge(
    "serve.sessions.active", "client channels currently connected"
)
_M_FRAMES_IN = _METRICS.counter(
    "serve.frames.received", "frames ingested from client transports"
)
_M_FRAMES_OUT = _METRICS.counter(
    "serve.frames.sent", "frames produced for client transports"
)


class ClientChannel:
    """One client's server-side state: its supervised session, target doc,
    tenant (the admission-control dimension), outbound frame queue and the
    committed request scopes awaiting their ack-send mark."""

    __slots__ = ("client_id", "tenant", "doc", "session", "outbox",
                 "pending_scopes")

    def __init__(self, client_id, tenant, doc, session):
        self.client_id = client_id
        self.tenant = tenant
        self.doc = doc
        self.session = session
        self.outbox: list[bytes] = []
        # amscope: scopes committed by a flush whose ack has not left yet
        # (the ack rides the channel's next outbound frame); empty and
        # untouched when request tracing is off
        self.pending_scopes: list = []


class AmServer:
    """The serving core. Drive it with three calls (all clock-injected):

    - ``receive(client_id, frame)`` — ingest one frame from a client's
      transport. Admission control runs here; rejections raise
      (``AdmissionRejectedError``/``BackpressureError``) and the frame is
      dropped unacked, which is the backpressure signal — the client's
      session retransmits after its backoff.
    - ``tick()`` — flush the batcher if its window is due; returns the
      ``FlushReport`` (or None). Call it from the event loop's timer.
    - ``pump()`` — collect every (client_id, frame) the sessions owe:
      acks and replies for channels the last flush touched, plus
      retransmissions whose deadlines passed. Send them, then call again
      until it returns nothing.
    """

    def __init__(self, farm, *, clock=None, rng=None,
                 config: BatcherConfig | None = None,
                 session_config: SessionConfig | None = None):
        self.farm = farm
        self.sync = SyncFarm(farm)
        self.clock = clock if clock is not None else _default_clock
        self.rng = rng if rng is not None else random.Random()
        self.session_config = session_config or SessionConfig()
        self.batcher = DynamicBatcher(self.sync, clock=self.clock,
                                      config=config)
        self.channels: dict[object, ClientChannel] = {}
        self._doc_channels: dict[int, set] = {}   # doc -> client ids
        # channels that may owe frames: polled by pump() until they go
        # quiet (poll() returns None with nothing in flight)
        self._active: set = set()

    # -------------------------------------------------------------- #
    # connect / resume / restart

    def connect(self, client_id, doc: int, tenant: str = "default",
                v2: bool | None = None) -> ClientChannel:
        """Opens (or returns) the channel for ``client_id``. Reconnects
        keep the existing server-side session: a restarted client arrives
        with a new epoch and the session's peer-restart detection
        re-handshakes; a merely-reconnected client continues mid-stream.

        ``v2`` overrides the server's default ``session_config.enable_v2``
        for this channel (the per-client opt-in a ``HELLO ... v2`` token
        carries); None inherits the server default. Enabling it only
        *advertises* — the session still speaks byte-for-byte v1 to a
        peer that never negotiates."""
        channel = self.channels.get(client_id)
        if channel is not None:
            self._active.add(client_id)
            return channel
        config = self.session_config
        if v2 is not None and v2 != config.enable_v2:
            config = _dc_replace(config, enable_v2=v2)
        session = self.sync.make_session(
            doc, clock=self.clock,
            rng=random.Random(self.rng.getrandbits(64)),
            config=config,
        )
        return self._install(client_id, tenant, doc, session, _M_CONNECTS)

    def resume(self, client_id, doc: int, blob: bytes,
               tenant: str = "default") -> ClientChannel:
        """Rebuilds a channel from a ``save_session`` blob (server
        restart): same epoch and seq/ack watermarks, so the client
        continues without a restart exchange."""
        self.channels.pop(client_id, None)
        session = self.sync.restore_session(
            doc, blob, clock=self.clock,
            rng=random.Random(self.rng.getrandbits(64)),
            config=self.session_config,
        )
        return self._install(client_id, tenant, doc, session, _M_RESUMES)

    def _install(self, client_id, tenant, doc, session, counter
                 ) -> ClientChannel:
        channel = ClientChannel(client_id, tenant, doc, session)
        self.channels[client_id] = channel
        self._doc_channels.setdefault(doc, set()).add(client_id)
        self._active.add(client_id)
        counter.inc()
        _M_ACTIVE.set(len(self.channels))
        return channel

    def save_session(self, client_id) -> bytes:
        """Durable snapshot of one channel (feed to ``resume``)."""
        return self.channels[client_id].session.save()

    def disconnect(self, client_id) -> None:
        channel = self.channels.pop(client_id, None)
        if channel is None:
            return
        self._doc_channels.get(channel.doc, set()).discard(client_id)
        self._active.discard(client_id)
        _M_DISCONNECTS.inc()
        _M_ACTIVE.set(len(self.channels))

    # -------------------------------------------------------------- #
    # the three-call event loop

    def receive(self, client_id, frame: bytes) -> None:
        """Ingests one frame. Raises ``KeyError`` for unknown clients and
        the admission errors (``AdmissionRejectedError`` /
        ``BackpressureError``) when the batcher refuses the frame — the
        caller drops it and the client's retransmission is the retry.

        Request tracing attaches here: when amscope is enabled, the frame
        gets a trace context (trace id, tenant, doc, client, bytes) that
        rides the batching window into the batched dispatch; admission
        rejections are counted against the tenant before re-raising."""
        channel = self.channels[client_id]
        _M_FRAMES_IN.inc()
        scope = (
            _AMSCOPE.attach(channel.tenant, channel.doc, client_id,
                            t=self.clock(), nbytes=len(frame))
            if _AMSCOPE.enabled else None
        )
        try:
            self.batcher.submit(channel, frame, scope)
        except AdmissionRejectedError:
            if scope is not None:
                _AMSCOPE.drop(scope, "shed")
            raise
        except BackpressureError:
            if scope is not None:
                _AMSCOPE.drop(scope, "backpressure")
            raise
        self._active.add(client_id)

    def wake(self, client_id) -> None:
        """Marks a channel as possibly owing frames so the next ``pump``
        polls it (harness hook: e.g. forcing a generate on an unconverged
        pair after a quiet period)."""
        if client_id in self.channels:
            self._active.add(client_id)

    def tick(self) -> FlushReport | None:
        """Flushes the batcher when its window is due. After a flush,
        every channel of every touched doc is woken so ``pump`` generates
        the fan-out (acks to the committers, fresh sync messages carrying
        the new changes to the doc's other clients)."""
        if not self.batcher.due():
            return None
        report = self.batcher.flush()
        for doc in report.touched_docs:
            self._active.update(self._doc_channels.get(doc, ()))
        for channel, _patch in report.committed:
            self._active.add(channel.client_id)
        return report

    def pump(self) -> list[tuple[object, bytes]]:
        """One sweep over the channels that may owe frames. Returns
        (client_id, frame) pairs for the transport; channels that produce
        nothing and have nothing in flight go quiet until a frame, a
        flush or a reconnect wakes them. Channels with an unacked payload
        stay awake so their retransmission deadlines are observed.

        Generation is batched: channels whose envelope layer says "the
        channel is clear, generate" are collected and served by ONE
        ``SyncFarm.generate_messages`` call — every Bloom filter build and
        query for the sweep runs as a single device program, the sending-
        side twin of the batcher's single receive dispatch."""
        from ..sync_session import NEEDS_GENERATE

        out: list[tuple[object, bytes]] = []
        need_generate: list[ClientChannel] = []
        for client_id in sorted(self._active, key=repr):
            channel = self.channels.get(client_id)
            if channel is None:
                self._active.discard(client_id)
                continue
            ready = channel.session.poll_begin()
            if ready is NEEDS_GENERATE:
                need_generate.append(channel)
            elif ready is not None:
                out.append((client_id, ready))
                _M_FRAMES_OUT.inc()
                self._mark_sent(channel)
            elif channel.session.pending is None:
                # quiet and nothing awaiting ack: sleep until woken
                self._active.discard(client_id)
        if need_generate:
            generate_t0 = self.clock()
            results = self.sync.generate_messages(
                [(c.doc, c.session.state) for c in need_generate],
                protocols=[
                    "v2" if c.session.v2_active else "v1"
                    for c in need_generate
                ],
            )
            if _AMSCOPE.enabled:
                _AMSCOPE.observe_phase(
                    "generate", self.clock() - generate_t0
                )
            for channel, (state, payload) in zip(need_generate, results):
                frame = channel.session.poll_commit(state, payload)
                if frame is not None:
                    out.append((channel.client_id, frame))
                    _M_FRAMES_OUT.inc()
                    self._mark_sent(channel)
                elif channel.session.pending is None:
                    self._active.discard(channel.client_id)
        return out

    def _mark_sent(self, channel: ClientChannel) -> None:
        """Finishes the channel's committed request scopes: the outbound
        frame just queued carries their ack, which ends the request's
        journey (receive -> window -> dispatch -> commit -> ack-send).
        One truthiness test when request tracing is off."""
        if channel.pending_scopes:
            now = self.clock()
            for scope in channel.pending_scopes:
                scope.mark("sent", now)
                _AMSCOPE.finish(scope)
            channel.pending_scopes.clear()

    def next_deadline(self) -> float | None:
        """The earliest future instant the core needs a ``tick``/``pump``
        call (batcher window expiry or a session retransmission deadline);
        None when fully idle. Harnesses jump simulated time here."""
        deadlines = []
        window = self.batcher.next_deadline()
        if window is not None:
            deadlines.append(window)
        for client_id in self._active:
            channel = self.channels.get(client_id)
            if channel is not None and channel.session.pending is not None:
                deadlines.append(channel.session.pending["deadline"])
        return min(deadlines, default=None)

    # -------------------------------------------------------------- #
    # asyncio adapter (real transports; the core above stays sans-io)

    async def serve_forever(self, host: str = "127.0.0.1", port: int = 0,
                            *, telemetry_port: int | None = None,
                            snapshot_path: str | None = None,
                            snapshot_interval: float = 5.0,
                            slo_engine=None):
        """Binds the core to asyncio streams: 4-byte big-endian length-
        prefixed frames, one connection per client. The first frame of a
        connection is a text hello ``b"HELLO <client_id> <doc> <tenant>"``;
        everything after is session frames. Runs until cancelled. Returns
        the listening server object (``server.sockets[0].getsockname()``
        for the bound port). A fifth hello token ``v2`` opts the channel
        into sync v2 negotiation (``HELLO <client_id> <doc> <tenant> v2``);
        old clients' four-token hello keeps the pure-v1 channel.

        Live telemetry (obs/export.py): ``telemetry_port`` mounts the
        pull-based text exposition (metrics + tenant table with
        exemplars) on a side-car HTTP listener that never enters the
        serving data path; ``snapshot_path`` appends a JSONL telemetry
        snapshot every ``snapshot_interval`` seconds from the flusher
        task — the telemetry file a ``--watch`` renderer tails.
        ``slo_engine`` (an ``obs.slo.SLOEngine``) is evaluated from the
        flusher on this server's clock — the wall-clock leg of the SLO
        plane: its ``slo.*`` gauges ride the exposition page and every
        snapshot line carries the verdicts."""
        import asyncio

        from ..obs.export import SnapshotWriter, serve_exposition

        writer_snapshots = (
            SnapshotWriter(snapshot_path, snapshot_interval,
                           clock=self.clock, slo_engine=slo_engine)
            if snapshot_path else None
        )
        telemetry = (
            await serve_exposition(host, telemetry_port)
            if telemetry_port is not None else None
        )

        writers: dict[object, asyncio.StreamWriter] = {}

        async def _send_all() -> None:
            for client_id, frame in self.pump():
                writer = writers.get(client_id)
                if writer is None:
                    continue
                writer.write(len(frame).to_bytes(4, "big") + frame)
            for writer in writers.values():
                await writer.drain()

        slo_last = None

        async def _flusher() -> None:
            nonlocal slo_last
            while True:
                await asyncio.sleep(self.batcher.config.flush_interval / 2)
                self.tick()
                await _send_all()
                if writer_snapshots is not None:
                    writer_snapshots.maybe_write()
                elif slo_engine is not None:
                    # no snapshot file to drive the export — evaluate at
                    # ~1Hz so the exposition page's slo.* gauges stay live
                    now = self.clock()
                    if slo_last is None or now - slo_last >= 1.0:
                        slo_last = now
                        slo_engine.export(now=now)

        async def _handle(reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
            client_id = None
            try:
                hello = await _read_frame(reader)
                parts = hello.decode("utf-8").split()
                if (
                    len(parts) not in (4, 5)
                    or parts[0] != "HELLO"
                    or (len(parts) == 5 and parts[4] != "v2")
                ):
                    writer.close()
                    return
                client_id, doc, tenant = parts[1], int(parts[2]), parts[3]
                self.connect(client_id, doc, tenant,
                             v2=True if len(parts) == 5 else None)
                writers[client_id] = writer
                while True:
                    frame = await _read_frame(reader)
                    try:
                        self.receive(client_id, frame)
                    except AutomergeError:
                        pass  # shed/backpressure: drop; client retransmits
                    await _send_all()
            except (asyncio.IncompleteReadError, ConnectionError):
                pass
            finally:
                if client_id is not None:
                    writers.pop(client_id, None)
                writer.close()

        async def _read_frame(reader: asyncio.StreamReader) -> bytes:
            header = await reader.readexactly(4)
            return await reader.readexactly(int.from_bytes(header, "big"))

        server = await asyncio.start_server(_handle, host, port)
        flusher = asyncio.ensure_future(_flusher())
        try:
            async with server:
                await server.serve_forever()
        finally:
            flusher.cancel()
            if telemetry is not None:
                telemetry.close()
        return server

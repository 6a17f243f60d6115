"""Session supervision for the sync protocol: reliable delivery over lossy
transports.

The reference Bloom-filter protocol (sync.py, backend/sync.js)
is specified over a reliable, in-order, exactly-once transport. This module
supplies that transport contract on top of an unreliable one: each
``SyncSession`` supervises one peer channel, wrapping
``generate_sync_message``/``receive_sync_message`` in a compact outer
envelope — the inner payload stays the reference wire format, byte for
byte — that adds:

- **sequence numbers + acks** (stop-and-wait): duplicate and stale frames
  are idempotent no-ops, counted on ``sync.session.dup_dropped``;
- **timeout + bounded retransmission** with exponential backoff and full
  jitter, driven by an *injectable* clock and RNG (amlint AM402 bans
  ``time.time``/``random.*`` from the sync data plane);
- **channel quarantine** after the retry budget is exhausted — the channel
  is shed, mirroring the doc farm's quarantine lifecycle, while the
  documents stay live;
- **peer-restart detection**: every session carries a random ``epoch``; a
  peer that comes back with a new epoch gets a clean re-handshake (seq
  tracking reset, our beliefs about the peer dropped) instead of a
  permanent heads mismatch;
- **a convergence watchdog**: no head/sharedHeads progress across K
  supervised rounds while payload frames still flow escalates — first a
  Bloom-filter rebuild (clear ``sentHashes``/``lastSentHeads``, resending
  anything wrongly withheld, e.g. after a pathological Bloom
  false-positive loop), then a full reset exchange (``sharedHeads = []``
  and the peer's filter treated as empty, so everything is offered
  explicitly).

Sessions persist through the existing ``encode_sync_state`` path:
``save()`` appends a versioned extension block (epoch/seq/ack watermarks)
that pre-extension decoders skip, and ``restore()`` resumes a channel
mid-sync after a process restart.

Frame layout (outer framing only; ``FRAME_TYPE`` is disjoint from the
``MESSAGE_TYPE_SYNC``/``PEER_STATE_TYPE`` record space)::

    byte  FRAME_TYPE (0x44)
    4B    checksum = sha256(body)[:4]     (rejects in-flight corruption)
    body: uint32 epoch | uint53 seq | uint53 ack | byte flags
          [prefixed payload when flags & FLAG_PAYLOAD]

``seq`` is 0 on ack-only frames (they carry no payload and are never
retransmitted); payload frames use a monotonic per-session sequence.

**Protocol negotiation (sync v2).** ``FLAG_V2`` in the flags byte
advertises that the sender speaks the range-based reconciliation
protocol (sync_v2.py). Pre-v2 decoders only test
``flags & FLAG_PAYLOAD``, so the bit is invisible to them — a v2 session
talking to a v1 peer produces byte-for-byte the v1 exchange. A session
switches to v2 generation only once BOTH sides have shown the flag
(``v2_active``); inbound payloads dispatch on their leading type byte,
so mixed-protocol transition windows are safe. If a v2 exchange errors,
the session latches ``v2_fallback``: the failed inbound frame is acked
(NOT withheld — a withheld ack would retransmit the same poisoned frame
until quarantine), the flag is dropped from outgoing frames so the peer
downgrades too, and the v1 machinery — Bloom filters, watchdog
escalation ladder and all — takes over. Never a stalled channel.

This is the port's own copy of the JAX package's ``sync_session.py``, over
this package's ``backend``, ``sync``, ``sync_v2`` and ``SyncFarm``: with the
same injected clock and RNG, its frame stream is the JAX package's byte for
byte.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from hashlib import sha256

from . import backend as Backend
from .codecs import Decoder, Encoder
from .errors import (
    ChannelQuarantinedError,
    RetryExhaustedError,
    SyncFrameError,
    SyncProtocolError,
)
from .obs.flight import get_flight
from .obs.metrics import get_metrics
from .sync import (
    decode_sync_message,
    decode_sync_state,
    encode_sync_state,
    generate_sync_message,
    init_sync_state,
    receive_sync_message,
)
from .sync_v2 import (
    MESSAGE_TYPE_SYNC_V2,
    decode_sync_message_v2,
    generate_sync_message_v2,
    index_for_backend,
    receive_sync_message_v2,
)
from .testing.faults import fire as _fault_point

FRAME_TYPE = 0x44
FLAG_PAYLOAD = 0x01
FLAG_V2 = 0x02  # sender speaks range-based reconciliation (sync_v2)

_CHECKSUM_SIZE = 4

#: sentinel returned by ``SyncSession.poll_begin`` when the channel is
#: clear and the caller should run the inner protocol's generate (then
#: ``poll_commit``) — distinguishable from both None and a frame
NEEDS_GENERATE = object()

_METRICS = get_metrics()
# flight-recorder hook (obs/flight.py): session events land in the ring
# for postmortems. Every call site guards with `_FLIGHT.enabled` so the
# disabled path never packs kwargs, and stamps `t` from the session's
# injected clock so simulated-time runs produce simulated timelines.
_FLIGHT = get_flight()
_M_RETRANSMITS = _METRICS.counter(
    "sync.session.retransmits", "payload frames retransmitted after a timeout"
)
_M_DUP_DROPPED = _METRICS.counter(
    "sync.session.dup_dropped",
    "duplicate/stale frames dropped idempotently (re-acked, not applied)",
)
_M_TIMEOUTS = _METRICS.counter(
    "sync.session.timeouts", "retransmission deadlines that expired unacked"
)
_M_BACKOFF_MS = _METRICS.histogram(
    "sync.session.backoff_ms",
    "full-jitter backoff delays (ms) applied before retransmissions",
)
_M_PEER_RESTARTS = _METRICS.counter(
    "sync.session.peer_restarts",
    "epoch changes observed from the peer (clean re-handshakes triggered)",
)
_M_FRAMES_REJECTED = _METRICS.counter(
    "sync.session.frames_rejected",
    "frames dropped as malformed/corrupt (SyncFrameError; state untouched)",
)
_M_SHED = _METRICS.counter(
    "sync.session.shed",
    "frames shed unprocessed because the channel is quarantined",
)
_M_ADVERTS_SUPPRESSED = _METRICS.counter(
    "sync.session.adverts_suppressed",
    "regenerated payloads withheld because the peer already acked the "
    "identical bytes (poll-driven callers would otherwise chatter forever)",
)
_M_WD_STALLS = _METRICS.counter(
    "sync.watchdog.stalls",
    "stalled-pair detections (no head progress while messages flowed)",
)
_M_WD_ESCALATIONS = _METRICS.counter(
    "sync.watchdog.escalations",
    "watchdog escalations (Bloom rebuild, then full reset exchange)",
)
_M_WD_RESETS = _METRICS.counter(
    "sync.watchdog.resets",
    "full reset exchanges forced after a Bloom rebuild failed to unstall",
)
_M_CHQ_ENTERED = _METRICS.counter(
    "sync.channel.quarantine.entered",
    "channels quarantined after the retransmission budget was exhausted",
)
_M_CHQ_RELEASED = _METRICS.counter(
    "sync.channel.quarantine.released", "channels returned to service"
)
_M_CHQ_ACTIVE = _METRICS.gauge(
    "sync.channel.quarantine.active", "channels currently quarantined"
)
_M_V2_NEGOTIATED = _METRICS.counter(
    "sync.v2.sessions.negotiated",
    "sessions upgraded to range-based reconciliation (both sides flagged v2)",
)
_M_V2_FALLBACKS = _METRICS.counter(
    "sync.v2.fallbacks",
    "mid-session downgrades to the Bloom protocol after a v2 exchange error",
)


def _set_active_quarantined():
    # derived from the enter/release counters rather than a module global,
    # so a registry reset() re-zeros the gauge consistently with them
    _M_CHQ_ACTIVE.set(max(0, _M_CHQ_ENTERED.value - _M_CHQ_RELEASED.value))


# ---------------------------------------------------------------------- #
# frame codec (outer framing only; payload is the reference wire format)

def encode_frame(epoch: int, seq: int, ack: int, payload: bytes | None,
                 extra_flags: int = 0) -> bytes:
    body = Encoder()
    body.append_uint32(epoch)
    body.append_uint53(seq)
    body.append_uint53(ack)
    if payload is None:
        body.append_byte(extra_flags)
    else:
        body.append_byte(FLAG_PAYLOAD | extra_flags)
        body.append_prefixed_bytes(payload)
    encoder = Encoder()
    encoder.append_byte(FRAME_TYPE)
    encoder.append_raw_bytes(sha256(body.buffer).digest()[:_CHECKSUM_SIZE])
    encoder.append_raw_bytes(body.buffer)
    return encoder.buffer


def decode_frame(data) -> dict:
    """Decodes one session frame; raises ``SyncFrameError`` on any
    malformed or corrupted input (short reads, checksum mismatch, bad
    type), never a raw decode exception, and touches no session state."""
    try:
        decoder = Decoder(data)
        frame_type = decoder.read_byte()
        if frame_type != FRAME_TYPE:
            raise SyncFrameError(f"unexpected frame type: {frame_type}")
        checksum = decoder.read_raw_bytes(_CHECKSUM_SIZE)
        body = decoder.read_raw_bytes(len(decoder.buf) - decoder.offset)
        if sha256(body).digest()[:_CHECKSUM_SIZE] != checksum:
            raise SyncFrameError("session frame checksum mismatch")
        body_decoder = Decoder(body)
        epoch = body_decoder.read_uint32()
        seq = body_decoder.read_uint53()
        ack = body_decoder.read_uint53()
        flags = body_decoder.read_byte()
        payload = (
            body_decoder.read_prefixed_bytes() if flags & FLAG_PAYLOAD else None
        )
    except SyncFrameError:
        raise
    except (ValueError, TypeError, IndexError) as exc:
        raise SyncFrameError(f"malformed session frame: {exc}") from exc
    return {
        "epoch": epoch, "seq": seq, "ack": ack, "flags": flags,
        "payload": payload,
    }


# ---------------------------------------------------------------------- #
# protocol drivers: what a session supervises

class BackendDriver:
    """Supervises a backend handle via the sequential protocol
    (sync.py). The handle is rebound on every receive, so the
    session owns the document's latest state."""

    def __init__(self, backend):
        self.backend = backend
        self._v2_index = None  # lazily built, incrementally refreshed

    def generate(self, state):
        return generate_sync_message(self.backend, state)

    def receive(self, state, payload):
        self.backend, state, patch = receive_sync_message(
            self.backend, state, payload
        )
        return state, patch

    def _index(self):
        self._v2_index = index_for_backend(self.backend, self._v2_index)
        return self._v2_index

    def generate_v2(self, state):
        return generate_sync_message_v2(self.backend, state, self._index())

    def receive_v2(self, state, payload):
        self.backend, state, patch = receive_sync_message_v2(
            self.backend, state, self._index(), payload
        )
        return state, patch

    def heads(self):
        return Backend.get_heads(self.backend)


class FarmDriver:
    """Supervises one document channel of a batched ``SyncFarm``
    (tpu/sync_farm.py). Malformed payloads raise out of ``receive`` (the
    session must withhold its ack so the peer retransmits), so the inner
    message is validated here before the farm's reject-in-place path."""

    def __init__(self, sync_farm, doc: int):
        self.sync_farm = sync_farm
        self.doc = doc

    def generate(self, state):
        ((state, msg),) = self.sync_farm.generate_messages([(self.doc, state)])
        return state, msg

    def receive(self, state, payload):
        decode_sync_message(payload)  # raises SyncProtocolError, state untouched
        ((state, patch),) = self.sync_farm.receive_messages(
            [(self.doc, state, payload)]
        )
        return state, patch

    def generate_v2(self, state):
        ((state, msg),) = self.sync_farm.generate_messages(
            [(self.doc, state)], protocols=["v2"]
        )
        return state, msg

    def receive_v2(self, state, payload):
        decode_sync_message_v2(payload)  # raises, farm state untouched
        ((state, patch),) = self.sync_farm.receive_messages(
            [(self.doc, state, payload)], protocols=["v2"]
        )
        return state, patch

    def heads(self):
        return self.sync_farm.farm.get_heads(self.doc)


# ---------------------------------------------------------------------- #

@dataclass
class SessionConfig:
    """Supervision knobs. Times are in the injected clock's units
    (seconds under the default monotonic clock)."""

    timeout: float = 1.0          # unacked-frame deadline before retransmit
    max_retries: int = 8          # retransmissions before channel quarantine
    backoff_base: float = 0.5     # first retry's backoff cap
    backoff_cap: float = 10.0     # backoff growth ceiling
    watchdog_rounds: int = 5      # K no-progress rounds before escalation
    enable_v2: bool = False       # advertise range-based reconciliation


def _default_clock():
    # the single wall-clock injection point for the sync data plane; every
    # other call site takes this (or a test clock) as a parameter
    return time.monotonic()  # amlint: disable=AM402 — the injectable-clock default


class SyncSession:
    """One supervised peer channel. Drive it with two calls:

    - ``poll()`` — the send half: returns the next frame to transmit (a
      fresh payload frame, a retransmission, or an owed ack), or None.
    - ``handle(frame)`` — the receive half: processes one incoming frame,
      returns the patch from the inner protocol (or None for acks,
      duplicates and shed frames). Corrupt frames raise ``SyncFrameError``
      (and inapplicable payloads ``SyncProtocolError``) with all session
      state untouched, so the peer's retransmission gets a clean retry.

    ``clock`` is a zero-argument callable; ``rng`` is a ``random.Random``
    instance. Both default to real time / OS entropy but are injectable so
    tests and the chaos harness are fully deterministic.
    """

    def __init__(self, driver, *, clock=None, rng=None, config=None,
                 state=None):
        self.driver = driver
        self.clock = clock if clock is not None else _default_clock
        self.rng = rng if rng is not None else random.Random()
        self.config = config or SessionConfig()
        self.state = state if state is not None else init_sync_state()
        self.epoch = self.rng.getrandbits(32) or 1  # 0 is reserved: "unknown"
        self.seq_out = 0          # last payload sequence number used
        self.last_seen = 0        # highest peer payload seq applied
        self.peer_epoch = None
        self.pending = None       # unacked outgoing payload frame, or None
        self.ack_owed = False
        self.quarantine_cause = None
        # the payload the peer last acknowledged, plus how many inbound
        # payloads had been applied when it was sent: a regenerated
        # payload byte-identical to it is suppressed (see poll_commit)
        # UNLESS the peer has sent us a payload since — without the
        # suppression, a poll-driven caller (the serving loop) chatters
        # forever once one side reaches the reference protocol's
        # reply-suppressed terminal state (receiveSyncMessage sets
        # lastSentHeads = msg.heads, so the peer's theirHeads stays stale
        # and generate keeps re-advertising); without the payload-since
        # escape, the suppression would silence the head-exchange chatter
        # the convergence watchdog counts stalled rounds on
        self._acked_payload = None
        self._acked_rx_mark = -1
        self._payloads_applied = 0
        # v2 negotiation: we advertise when the config opts in AND the
        # driver can actually run both halves of the v2 protocol; the peer
        # advertises via FLAG_V2 on its frames. v2_fallback latches a
        # mid-session downgrade (v2 exchange errored) — permanent for this
        # session incarnation, cleared only by a peer restart.
        self.v2_local = bool(
            self.config.enable_v2
            and hasattr(driver, "generate_v2")
            and hasattr(driver, "receive_v2")
        )
        self.peer_v2 = False
        self.v2_fallback = False
        self.stats = {
            "retransmits": 0, "dup_dropped": 0, "timeouts": 0,
            "backoff_ms": 0.0, "peer_restarts": 0, "shed": 0,
            "stalls": 0, "escalations": 0, "resets": 0, "suppressed": 0,
            "v2_negotiated": 0, "v2_fallbacks": 0,
        }
        self._wd_heads = None
        self._wd_shared = None
        self._wd_rounds = 0
        self._wd_stage = 0

    # -------------------------------------------------------------- #
    # protocol negotiation (sync v2)

    @property
    def v2_active(self) -> bool:
        """True when this session generates v2 messages: both sides have
        advertised the capability and no fallback has latched. Inbound
        dispatch is by payload type byte regardless, so flipping mid-flight
        is safe."""
        return self.v2_local and self.peer_v2 and not self.v2_fallback

    def _flags_out(self) -> int:
        return FLAG_V2 if (self.v2_local and not self.v2_fallback) else 0

    def _note_peer_flags(self, flags: int):
        """Tracks the peer's advertised capability from every frame. A
        frame WITHOUT the flag from a previously-v2 peer downgrades us too
        (the peer latched its own fallback); the symmetric drop is what
        terminates a one-sided fallback instead of leaving us feeding v2
        frames to a peer that now rejects them."""
        peer_v2 = bool(flags & FLAG_V2)
        if peer_v2 == self.peer_v2:
            return
        was_active = self.v2_active
        self.peer_v2 = peer_v2
        if not was_active and self.v2_active:
            _M_V2_NEGOTIATED.inc()
            self.stats["v2_negotiated"] += 1
            if _FLIGHT.enabled:
                _FLIGHT.record("v2.negotiated", t=self.clock(),
                               epoch=self.epoch, peer_epoch=self.peer_epoch)

    def _v2_fall_back(self, where: str, cause):
        """Latches the mid-session downgrade to v1: counted, flight-evented
        (record + trigger — a fallback is a postmortem-worthy anomaly), v2
        descent state dropped so the Bloom machinery starts clean."""
        if self.v2_fallback:
            return
        self.v2_fallback = True
        _M_V2_FALLBACKS.inc()
        self.stats["v2_fallbacks"] += 1
        self._acked_payload = None  # the v1 restart must regenerate freely
        if _FLIGHT.enabled:
            _FLIGHT.record("v2.fallback", t=self.clock(), epoch=self.epoch,
                           where=where, cause=str(cause))
            _FLIGHT.trigger("v2.fallback", t=self.clock(), epoch=self.epoch)
        self.state = {
            k: v for k, v in self.state.items() if not k.startswith("v2")
        }

    # -------------------------------------------------------------- #
    # send half

    def poll(self):
        """Returns the next frame to transmit, or None when idle. Call it
        whenever the transport can send: it retransmits on expired
        deadlines, generates the next protocol message when the channel is
        clear, and emits owed acks."""
        ready = self.poll_begin()
        if ready is not NEEDS_GENERATE:
            return ready
        state, payload = self._generate_dispatch(self.state)
        return self.poll_commit(state, payload)

    def _generate_dispatch(self, state):
        """Runs the negotiated protocol's generate; a v2 generate error
        falls back to v1 (counted + flight-evented) rather than killing
        the channel."""
        if self.v2_active:
            try:
                return self.driver.generate_v2(state)
            except SyncProtocolError as exc:
                self._v2_fall_back("generate", exc)
                state = self.state  # _v2_fall_back stripped the v2 keys
        return self.driver.generate(state)

    def poll_begin(self):
        """The pre-generate half of ``poll``: quarantine shed, owed acks
        while a frame is in flight, and the retransmission/timeout path.
        Returns a frame (or None) when the channel needs no generation,
        or the ``NEEDS_GENERATE`` sentinel when the caller should run the
        inner protocol's generate and finish with ``poll_commit``. The
        serving multiplexer uses this split to batch MANY sessions'
        generates into one device program (``SyncFarm.generate_messages``)
        instead of one dispatch per channel."""
        if self.quarantine_cause is not None:
            return None
        now = self.clock()
        if self.pending is not None:
            if now < self.pending["deadline"]:
                return self._ack_frame() if self.ack_owed else None
            _M_TIMEOUTS.inc()
            self.stats["timeouts"] += 1
            if self.pending["attempt"] >= self.config.max_retries:
                self._enter_quarantine(RetryExhaustedError(
                    f"no ack for frame seq={self.pending['seq']} after "
                    f"{self.pending['attempt']} retransmissions; channel "
                    "quarantined (release() to retry)"
                ))
                return None
            self.pending["attempt"] += 1
            backoff = self._backoff(self.pending["attempt"])
            self.pending["deadline"] = now + self.config.timeout + backoff
            _M_RETRANSMITS.inc()
            self.stats["retransmits"] += 1
            if _FLIGHT.enabled:
                _FLIGHT.record(
                    "session.retransmit", t=now, seq=self.pending["seq"],
                    attempt=self.pending["attempt"],
                    backoff_ms=round(backoff * 1000.0, 3),
                )
            self.ack_owed = False
            # re-frame so the retransmission carries the current ack
            return encode_frame(
                self.epoch, self.pending["seq"], self.last_seen,
                self.pending["payload"], self._flags_out(),
            )
        return NEEDS_GENERATE

    def poll_commit(self, state, payload):
        """The post-generate half of ``poll``: adopts the new sync state
        and frames the payload (fresh seq, retransmission deadline), or
        emits the owed ack when there is nothing (left) to say."""
        self.state = state
        if payload is None:
            return self._ack_frame() if self.ack_owed else None
        if (
            payload == self._acked_payload
            and self._payloads_applied == self._acked_rx_mark
        ):
            # byte-identical to a payload the peer already acknowledged,
            # and the peer has said nothing since: retransmitting carries
            # zero new information and only restarts the ack->regenerate
            # chatter loop. Stay quiet; any real event (our heads move, a
            # peer payload arrives — which re-arms this check so the
            # watchdog's stalled-round chatter still flows — a restart or
            # a watchdog reset) changes the bytes or the mark.
            self.stats["suppressed"] += 1
            _M_ADVERTS_SUPPRESSED.inc()
            return self._ack_frame() if self.ack_owed else None
        self.seq_out += 1
        self.pending = {
            "seq": self.seq_out,
            "payload": payload,
            "attempt": 0,
            "deadline": self.clock() + self.config.timeout,
            "rx_mark": self._payloads_applied,
        }
        self.ack_owed = False
        return encode_frame(self.epoch, self.seq_out, self.last_seen, payload,
                            self._flags_out())

    def _ack_frame(self) -> bytes:
        self.ack_owed = False
        return encode_frame(self.epoch, 0, self.last_seen, None,
                            self._flags_out())

    def _backoff(self, attempt: int) -> float:
        """Full jitter: uniform in [0, min(cap, base * 2^(attempt-1)))."""
        ceiling = min(
            self.config.backoff_cap,
            self.config.backoff_base * (2 ** (attempt - 1)),
        )
        delay = self.rng.uniform(0.0, ceiling)
        _M_BACKOFF_MS.observe(delay * 1000.0)
        self.stats["backoff_ms"] += delay * 1000.0
        return delay

    # -------------------------------------------------------------- #
    # receive half

    def handle(self, frame_bytes):
        """Processes one incoming frame; returns the inner protocol's patch
        (None for acks/duplicates/shed frames)."""
        pre = self.begin(frame_bytes)
        if pre is None:
            return None
        # apply BEFORE advancing the seq watermark: a payload the inner
        # protocol rejects (corrupt/inapplicable) must not be acked, so the
        # peer's intact retransmission gets a clean retry
        state, patch = self._receive_dispatch(self.state, pre["payload"])
        return self.commit(pre, state, patch)

    def _receive_dispatch(self, state, payload):
        """Routes an inbound payload by its leading type byte. A v2
        payload that errors latches the fallback and is ACKED with state
        unchanged: withholding the ack would make the peer retransmit the
        same poisoned frame until the retry budget quarantined the channel.
        v1 payload errors keep the withhold-ack semantics — their
        retransmission path is how transient corruption heals."""
        if self.v2_local and payload and payload[0] == MESSAGE_TYPE_SYNC_V2:
            try:
                return self.driver.receive_v2(state, payload)
            except SyncProtocolError as exc:
                self._v2_fall_back("receive", exc)
                return self.state, None
        return self.driver.receive(state, payload)

    def begin(self, frame_bytes):
        """The envelope half of ``handle``: decodes and validates the
        frame, processes its ack/epoch side effects, and drops duplicates
        — everything except applying the payload through the driver.
        Returns None when there is nothing to apply (ack-only, duplicate,
        shed), else ``{"seq", "payload"}`` to hand to the inner protocol
        and then to ``commit``. The serving batcher (serve/batcher.py)
        uses this split to stage many sessions' payloads into ONE batched
        farm dispatch; ``handle`` composes the same two halves around an
        immediate ``driver.receive``."""
        if self.quarantine_cause is not None:
            _M_SHED.inc()
            self.stats["shed"] += 1
            return None
        _fault_point("session.receive", frame=frame_bytes)
        try:
            frame = decode_frame(frame_bytes)
        except SyncFrameError:
            _M_FRAMES_REJECTED.inc()
            raise
        if frame["epoch"] != self.peer_epoch:
            if self.peer_epoch is not None:
                self._on_peer_restart()
            self.peer_epoch = frame["epoch"]
        self._note_peer_flags(frame["flags"])
        if self.pending is not None and frame["ack"] >= self.pending["seq"]:
            self._acked_payload = self.pending["payload"]
            self._acked_rx_mark = self.pending["rx_mark"]
            self.pending = None
        payload = frame["payload"]
        if payload is None:
            return None
        if frame["seq"] <= self.last_seen:
            _M_DUP_DROPPED.inc()
            self.stats["dup_dropped"] += 1
            self.ack_owed = True  # re-ack so the peer stops retransmitting
            return None
        return {"seq": frame["seq"], "payload": payload}

    def commit(self, pre, state, patch):
        """The post-apply half of ``handle``: adopts the inner protocol's
        new state, advances the seq watermark (the payload is now safe to
        ack), and runs a watchdog round. Must only be called with the
        result of a successful ``driver.receive`` of ``begin``'s payload —
        a rejected payload is NOT committed, so it is never acked and the
        peer's retransmission retries cleanly."""
        self.state = state
        self.last_seen = pre["seq"]
        self.ack_owed = True
        self._payloads_applied += 1
        self._watchdog_round()
        return patch

    def _on_peer_restart(self):
        """The peer came back with a new epoch: reset the envelope-level
        seq tracking and drop everything we believed about the peer, so
        the next exchange is a clean re-handshake (the inner protocol's
        reset paths then re-establish sharedHeads) instead of a permanent
        dup-drop/heads mismatch."""
        _M_PEER_RESTARTS.inc()
        self.stats["peer_restarts"] += 1
        if _FLIGHT.enabled:
            _FLIGHT.record("session.peer_restart", t=self.clock(),
                           epoch=self.epoch, peer_epoch=self.peer_epoch)
        self.last_seen = 0
        self.pending = None  # addressed to the old incarnation; regenerate
        self._acked_payload = None  # the new incarnation acked nothing
        self.state = {
            k: v for k, v in dict(
                self.state,
                theirHeads=None, theirHave=None, theirNeed=None,
                lastSentHeads=[], sentHashes={},
            ).items()
            if not k.startswith("v2")  # in-flight descents die with the peer
        }
        # the new incarnation re-negotiates from scratch (it may have come
        # back without v2, or healthy enough to retry after our fallback)
        self.peer_v2 = False
        self.v2_fallback = False
        self._wd_rounds = 0
        self._wd_stage = 0

    # -------------------------------------------------------------- #
    # convergence watchdog

    def _watchdog_round(self):
        """Called after every applied payload (so "messages still flow" by
        construction): escalates when heads and sharedHeads are both stuck
        for K rounds short of convergence."""
        heads = self.driver.heads()
        shared = self.state["sharedHeads"]
        their = self.state["theirHeads"]
        converged = their is not None and heads == their
        progressed = heads != self._wd_heads or shared != self._wd_shared
        self._wd_heads = heads
        self._wd_shared = shared
        if converged or progressed:
            self._wd_rounds = 0
            self._wd_stage = 0
            return
        self._wd_rounds += 1
        if self._wd_rounds < self.config.watchdog_rounds:
            return
        self._wd_rounds = 0
        _M_WD_STALLS.inc()
        self.stats["stalls"] += 1
        _M_WD_ESCALATIONS.inc()
        self.stats["escalations"] += 1
        if _FLIGHT.enabled:
            _FLIGHT.record("watchdog.stall", t=self.clock(),
                           epoch=self.epoch, stage=self._wd_stage)
        self._acked_payload = None  # escalations must retransmit freely
        if self.v2_active:
            # v2 has no Bloom state to rebuild and no probabilistic
            # failure mode to escalate past — in practice this branch
            # should be unreachable (that's the point of v2). If it ever
            # fires, drop the in-flight descent so the next generate
            # re-probes the full range from current heads.
            if _FLIGHT.enabled:
                _FLIGHT.record("watchdog.escalate", t=self.clock(),
                               epoch=self.epoch, action="v2_reprobe")
            self.state = {
                k: v for k, v in dict(
                    self.state, lastSentHeads=[], sentHashes={},
                ).items()
                if not k.startswith("v2")
            }
            return
        if self._wd_stage == 0:
            # stage 1 — rebuild the Bloom exchange: clearing sentHashes and
            # lastSentHeads makes the next generate resend its filter and
            # re-offer anything wrongly withheld (e.g. a change a stale
            # sentHashes entry or a Bloom false-positive loop suppressed)
            self._wd_stage = 1
            if _FLIGHT.enabled:
                _FLIGHT.record("watchdog.escalate", t=self.clock(),
                               epoch=self.epoch, action="bloom_rebuild")
            self.state = dict(self.state, lastSentHeads=[], sentHashes={})
        else:
            # stage 2 — full reset exchange: treat the peer's filter as
            # empty (every change Bloom-negative, so all of ours are
            # offered explicitly) and rebuild ours from scratch
            self._wd_stage = 0
            _M_WD_RESETS.inc()
            self.stats["resets"] += 1
            if _FLIGHT.enabled:
                _FLIGHT.record("watchdog.reset", t=self.clock(),
                               epoch=self.epoch)
                _FLIGHT.trigger("watchdog.reset", t=self.clock(),
                                epoch=self.epoch)
            self.state = dict(
                self.state,
                sharedHeads=[], lastSentHeads=[], sentHashes={},
                theirHave=[{"lastSync": [], "bloom": b""}],
                theirNeed=self.state["theirNeed"] or [],
            )

    # -------------------------------------------------------------- #
    # channel quarantine (mirrors the doc farm's lifecycle)

    @property
    def quarantined(self) -> bool:
        return self.quarantine_cause is not None

    def _enter_quarantine(self, cause: SyncProtocolError):
        self.quarantine_cause = cause
        self.pending = None
        _M_CHQ_ENTERED.inc()
        _set_active_quarantined()
        if _FLIGHT.enabled:
            _FLIGHT.record("session.quarantine.enter", t=self.clock(),
                           epoch=self.epoch, cause=str(cause))
            _FLIGHT.trigger("session.quarantine", t=self.clock(),
                            epoch=self.epoch)

    def release(self):
        """Returns a quarantined channel to service with a fresh retry
        budget; the next ``poll()`` regenerates from current state. On a
        live channel it just resets the in-flight retry budget — call it
        after a known network heal so a frame that burned most of its
        budget against the partition is not quarantined by its next
        timeout."""
        if self.quarantine_cause is None:
            if self.pending is not None:
                self.pending["attempt"] = 0
            return
        self.quarantine_cause = None
        self._acked_payload = None  # post-heal recovery regenerates freely
        _M_CHQ_RELEASED.inc()
        _set_active_quarantined()
        if _FLIGHT.enabled:
            _FLIGHT.record("session.quarantine.release", t=self.clock(),
                           epoch=self.epoch)

    def check(self):
        """Raises ``ChannelQuarantinedError`` if the channel is shed (the
        explicit-error analogue of the silent shed in ``handle``)."""
        if self.quarantine_cause is not None:
            raise ChannelQuarantinedError(
                f"sync channel is quarantined ({self.quarantine_cause}); "
                "release() to retry"
            )

    # -------------------------------------------------------------- #
    # persistence (resumable sessions)

    def save(self) -> bytes:
        """Durable snapshot: the inner state's sharedHeads plus the session
        extension (epoch and seq/ack watermarks, and the watchdog's
        escalation ladder — without it a restart silently re-armed a
        stalled channel's stall counters from zero). In-flight frames are
        deliberately not persisted — after restore the peer's
        retransmissions and our regenerated frames re-fill the channel."""
        return encode_sync_state(self.state, session={
            "epoch": self.epoch,
            "seqOut": self.seq_out,
            "lastSeen": self.last_seen,
            "peerEpoch": self.peer_epoch,
            "wdRounds": self._wd_rounds,
            "wdStage": self._wd_stage,
            "wdStalls": self.stats["stalls"],
            "wdEscalations": self.stats["escalations"],
            "wdResets": self.stats["resets"],
        })

    @classmethod
    def restore(cls, blob, driver, *, clock=None, rng=None, config=None):
        """Resumes a channel from ``save()`` output. Pre-extension blobs
        (plain ``encode_sync_state``) restore too — the session then starts
        with a fresh epoch, which the peer handles as a restart. Blobs
        written before the watchdog tail existed restore with the
        escalation ladder at rest."""
        state = decode_sync_state(blob)
        session = state.pop("session", None)
        restored = cls(driver, clock=clock, rng=rng, config=config, state=state)
        if session is not None:
            restored.epoch = session["epoch"]
            restored.seq_out = session["seqOut"]
            restored.last_seen = session["lastSeen"]
            restored.peer_epoch = session["peerEpoch"]
            restored._wd_rounds = session.get("wdRounds", 0)
            restored._wd_stage = session.get("wdStage", 0)
            restored.stats["stalls"] = session.get("wdStalls", 0)
            restored.stats["escalations"] = session.get("wdEscalations", 0)
            restored.stats["resets"] = session.get("wdResets", 0)
        return restored

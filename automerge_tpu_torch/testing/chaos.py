"""Deterministic chaos transport: a seeded simulated network for sync tests
and bench.

The sync supervision layer (sync_session.py) promises
convergence over lossy, restart-prone transports; this module is the
adversary that promise is tested against. A ``ChaosLink`` is one directed
byte pipe with seeded per-frame drop/duplicate/reorder/delay/corrupt/
truncate probabilities and byte accounting; a ``ChaosNetwork`` wires links
between named peers and adds partition/heal and in-flight-loss events (the
transport half of a peer restart). ``ChaosHarness`` drives a set of
supervised sessions over a network against a ``ManualClock`` until a
predicate holds, advancing simulated time only when the network goes quiet
— so retransmission timeouts and backoff fire without real sleeping.

Everything is driven by one injected ``random.Random`` and one injected
clock: the same seed replays the same failure schedule byte for byte.

The harness composes with the fault-injection registry
(testing/faults.py): every send and delivery consults the
``chaos.send``/``chaos.deliver`` failure points, so tests can combine
network chaos with merge-path faults (e.g. a poisoned document quarantined
by the farm while its sync channel is also dropping frames).

This is the port's own copy of the JAX package's ``testing/chaos.py``:
for one seed both give the same frame schedule. It must stay importable
on any host: no torch, no tpu imports.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..errors import SyncProtocolError
from .faults import fire as _fault_point


class ManualClock:
    """An injectable clock tests advance by hand. Instances are callable
    (``clock()``), matching the ``SyncSession`` clock contract."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclass
class ChaosConfig:
    """Per-link failure probabilities (all independent per frame) and the
    extra latency range applied when a frame is delayed."""

    drop: float = 0.0        # frame vanishes
    duplicate: float = 0.0   # frame delivered twice
    reorder: float = 0.0     # frame may overtake earlier in-flight frames
    corrupt: float = 0.0     # one random bit flipped
    truncate: float = 0.0    # random tail cut off
    delay: float = 0.0       # frame held for extra latency
    min_delay: float = 0.05  # extra latency range when delayed
    max_delay: float = 1.5
    base_delay: float = 0.0  # fixed latency every frame pays (per-link skew)

    @classmethod
    def lossy(cls, p: float) -> "ChaosConfig":
        """The soak-suite shape: loss, duplication and reordering all at
        probability ``p``, plus occasional latency spikes."""
        return cls(drop=p, duplicate=p, reorder=p, delay=p / 2)


@dataclass
class LinkStats:
    frames_sent: int = 0
    frames_delivered: int = 0
    frames_dropped: int = 0
    frames_duplicated: int = 0
    frames_corrupted: int = 0
    frames_truncated: int = 0
    frames_delayed: int = 0
    frames_reordered: int = 0
    bytes_sent: int = 0
    bytes_delivered: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class ChaosLink:
    """One directed lossy pipe. ``send`` applies the failure schedule and
    queues surviving copies; ``deliver`` returns every frame whose
    simulated arrival time has passed, in (possibly reordered) order."""

    def __init__(self, rng, clock, config: ChaosConfig | None = None,
                 name: str = ""):
        self.rng = rng
        self.clock = clock
        self.config = config or ChaosConfig()
        self.name = name
        self.partitioned = False
        self.stats = LinkStats()
        self._queue: list[tuple[float, float, bytes]] = []  # (at, order, frame)
        self._order = 0.0

    def send(self, frame: bytes) -> None:
        _fault_point("chaos.send", link=self.name, frame=frame)
        cfg, rng = self.config, self.rng
        self.stats.frames_sent += 1
        self.stats.bytes_sent += len(frame)
        if self.partitioned or rng.random() < cfg.drop:
            self.stats.frames_dropped += 1
            return
        copies = 1
        if rng.random() < cfg.duplicate:
            copies = 2
            self.stats.frames_duplicated += 1
        for _ in range(copies):
            damaged = frame
            roll = rng.random()
            if roll < cfg.corrupt and len(frame) > 0:
                buf = bytearray(frame)
                bit = rng.randrange(len(buf) * 8)
                buf[bit >> 3] ^= 1 << (bit & 7)
                damaged = bytes(buf)
                self.stats.frames_corrupted += 1
            elif roll < cfg.corrupt + cfg.truncate and len(frame) > 1:
                damaged = frame[: rng.randrange(1, len(frame))]
                self.stats.frames_truncated += 1
            at = self.clock() + cfg.base_delay
            if rng.random() < cfg.delay:
                at += rng.uniform(cfg.min_delay, cfg.max_delay)
                self.stats.frames_delayed += 1
            self._order += 1.0
            order = self._order
            if rng.random() < cfg.reorder:
                order -= rng.uniform(0.0, 3.0)  # may overtake in-flight frames
                self.stats.frames_reordered += 1
            self._queue.append((at, order, damaged))

    def deliver(self) -> list[bytes]:
        """Frames whose arrival time has passed, earliest order first."""
        now = self.clock()
        ready = sorted(
            (m for m in self._queue if m[0] <= now), key=lambda m: (m[1],)
        )
        self._queue = [m for m in self._queue if m[0] > now]
        out = []
        for _, _, frame in ready:
            _fault_point("chaos.deliver", link=self.name, frame=frame)
            self.stats.frames_delivered += 1
            self.stats.bytes_delivered += len(frame)
            out.append(frame)
        return out

    @property
    def in_flight(self) -> int:
        return len(self._queue)

    def next_arrival(self) -> float | None:
        return min((m[0] for m in self._queue), default=None)

    def clear(self) -> int:
        """Drops everything in flight (a peer restart loses its inbox)."""
        n = len(self._queue)
        self._queue = []
        self.stats.frames_dropped += n
        return n


class ChaosNetwork:
    """Directed links between named peers, created lazily with a shared
    default config (override per link via ``link(a, b).config``)."""

    def __init__(self, rng, clock, config: ChaosConfig | None = None):
        self.rng = rng
        self.clock = clock
        self.config = config or ChaosConfig()
        self._links: dict[tuple, ChaosLink] = {}

    def link(self, src, dst) -> ChaosLink:
        key = (src, dst)
        if key not in self._links:
            self._links[key] = ChaosLink(
                self.rng, self.clock, self.config, name=f"{src}->{dst}"
            )
        return self._links[key]

    def send(self, src, dst, frame: bytes) -> None:
        self.link(src, dst).send(frame)

    def deliver(self, dst) -> list[tuple[object, bytes]]:
        """Every ready (src, frame) addressed to ``dst``."""
        out = []
        for (src, d), link in self._links.items():
            if d != dst:
                continue
            for frame in link.deliver():
                out.append((src, frame))
        return out

    def partition(self, a, b) -> None:
        """Severs both directions between two peers (in-flight frames
        still arrive; new sends are dropped)."""
        self.link(a, b).partitioned = True
        self.link(b, a).partitioned = True

    def heal(self, a, b) -> None:
        self.link(a, b).partitioned = False
        self.link(b, a).partitioned = False

    def partition_one_way(self, src, dst) -> None:
        """Asymmetric partition: ``src -> dst`` drops while ``dst -> src``
        keeps flowing — the half-open failure real networks produce (dead
        uplink, live downlink) that a symmetric partition can't model:
        one side keeps receiving and acking while its own frames vanish."""
        self.link(src, dst).partitioned = True

    def heal_one_way(self, src, dst) -> None:
        self.link(src, dst).partitioned = False

    def set_latency(self, src, dst, base: float) -> None:
        """Per-link latency skew: every ``src -> dst`` frame arrives at
        least ``base`` simulated seconds late, on top of the probabilistic
        delay. Skewing the two directions differently exercises the
        stop-and-wait timers against asymmetric RTT halves."""
        from dataclasses import replace

        link = self.link(src, dst)
        link.config = replace(link.config, base_delay=base)

    def drop_in_flight(self, peer) -> int:
        """Clears every queue to or from ``peer`` (the transport half of a
        peer restart)."""
        dropped = 0
        for (src, dst), link in self._links.items():
            if src == peer or dst == peer:
                dropped += link.clear()
        return dropped

    @property
    def in_flight(self) -> int:
        """Frames queued across every link (0 = the network is quiet)."""
        return sum(link.in_flight for link in self._links.values())

    def next_arrival(self) -> float | None:
        """Earliest simulated arrival time across every link, or None when
        nothing is in flight — event-driven harnesses (serve/loadgen.py)
        jump the clock here instead of ticking through quiet gaps."""
        times = [
            t
            for link in self._links.values()
            if (t := link.next_arrival()) is not None
        ]
        return min(times, default=None)

    def stats(self) -> dict:
        return {link.name: link.stats.as_dict() for link in self._links.values()}


class ChaosHarness:
    """Drives supervised sessions over a chaos network in simulated time.

    Sessions register per directed edge (``add_session(src, dst, s)`` —
    ``s`` speaks for ``src`` on the ``src -> dst`` channel). Each ``step()``
    polls every session, routes the produced frames, and hands deliveries
    to the addressed session; ``run_until`` repeats steps, jumping the
    clock forward over quiet gaps so timeouts and backoff fire without
    real sleeping. Frames the supervision layer rejects
    (``SyncProtocolError``: corruption, truncation) are counted and
    dropped — that is the transport noise the retransmission path exists
    to absorb."""

    def __init__(self, network: ChaosNetwork, clock: ManualClock):
        self.network = network
        self.clock = clock
        self.sessions: dict[tuple, object] = {}
        self.rejected = 0
        self.patches = 0

    def add_session(self, src, dst, session) -> None:
        self.sessions[(src, dst)] = session

    def step(self) -> bool:
        """One poll/route/deliver sweep; True if any frame moved."""
        activity = False
        for (src, dst), session in self.sessions.items():
            frame = session.poll()
            if frame is not None:
                self.network.send(src, dst, frame)
                activity = True
        for receiver in {src for src, _dst in self.sessions}:
            for sender, frame in self.network.deliver(receiver):
                # the frame on link sender->receiver lands at the session
                # speaking for receiver on the (receiver, sender) edge
                session = self.sessions.get((receiver, sender))
                if session is None:
                    continue
                activity = True
                try:
                    if session.handle(frame) is not None:
                        self.patches += 1
                except SyncProtocolError:
                    self.rejected += 1
        return activity

    def run_until(self, predicate, max_time: float = 300.0,
                  idle_step: float = 0.26, tick: float = 0.02) -> bool:
        """Steps until ``predicate()`` holds or ``max_time`` simulated
        seconds elapse. Returns whether the predicate was met. Every step
        advances the clock by ``tick`` (so retransmission deadlines always
        approach, even while chatter keeps the network busy) and quiet
        steps jump ``idle_step`` further."""
        deadline = self.clock() + max_time
        while self.clock() < deadline:
            if predicate():
                return True
            busy = self.step()
            self.clock.advance(tick if busy else idle_step)
        return predicate()

"""Simulated-time load harness: 10^4–10^6 clients against one AmServer.

The serving claim to test is not "a session works" (the session tests show that) but
"a *fleet* of sessions stays dense through the batcher and the service
survives hostile traffic". This harness builds that fleet cheaply: every
client is a reference-backend replica plus a supervised ``SyncSession``,
wired to the server over per-client chaos links (``testing/chaos.py``),
and the whole system runs on one ``ManualClock`` — a million clients'
worth of retransmission timeouts, batching windows and backoff cost zero
real seconds of sleeping. Determinism is total: one seed fixes the edit
schedule, the chaos schedule and every session's jitter.

Workload shape: each client issues ``edits_per_client`` changes of
``ops_per_edit`` key-set ops at seeded times spread over ``spread``
simulated seconds, against a document shared with the other clients
assigned to it (``clients / docs`` co-editors per doc). A ``poison``
fraction of the docs gets hostile clients whose outgoing change buffers
are corrupted in flight — the farm's per-doc isolation quarantines those
docs and the front door's admission control must shed them while every
clean doc's clients still converge.

Figures of merit (reported by ``run()``; ``chip_smoke.py`` phase 16 logs
them on the card):

- **sync latency** (p50/p95/p99, simulated ms): first transmission of a
  payload frame → its ack, which prices the batching window plus the
  dispatch on exactly the path a client feels;
- **e2e ops/s**: committed ops per *host* second — what the serving
  stack actually costs;
- **batch occupancy**: docs carrying changes per farm dispatch (the
  density the batcher exists to create);
- **shed/backpressure counts** from the ``serve.*`` amtrace metrics.

Convergence criterion: every *surviving* client (its doc neither
poisoned nor quarantined) holds exactly the server's heads for its doc.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from .. import backend as Backend
from ..errors import AutomergeError, SyncProtocolError
from ..obs.export import SnapshotWriter, request_breakdown
from ..obs.flight import get_flight
from ..obs.metrics import enabled_metrics, get_metrics
from ..obs.scope import get_amscope
from ..obs.slo import SLOEngine, default_serve_slos, verdicts_ok
from ..sync import decode_sync_message, encode_sync_message
from ..sync_session import (
    BackendDriver,
    SessionConfig,
    SyncSession,
    decode_frame,
    encode_frame,
)
from ..testing.chaos import ChaosConfig, ChaosNetwork, ManualClock
from ..testing.faults import bit_flipped, make_change, set_op
from .batcher import BatcherConfig
from .server import AmServer

_METRICS = get_metrics()
_M_LATENCY = _METRICS.histogram(
    "serve.sync.latency_ms",
    "simulated ms from a payload frame's first transmission to its ack "
    "(prices the batching window + dispatch as the client feels it)",
)
_M_SHED_ADMISSION = _METRICS.counter(
    "serve.loadgen.frames_shed",
    "client frames the front door refused (admission/backpressure); the "
    "session retransmission path retried them",
)
_M_REJECTED_DOWN = _METRICS.counter(
    "serve.loadgen.frames_rejected",
    "server frames a client session rejected (chaos corruption)",
)
_M_CONVERGED_RATIO = _METRICS.gauge(
    "serve.clients.converged_ratio",
    "converged fraction of the surviving fleet (the convergence SLO's "
    "input gauge; surviving = doc neither poisoned nor quarantined)",
)

_SERVER = "server"


@dataclass
class LoadConfig:
    """Harness knobs. Times are simulated seconds."""

    clients: int = 10_000
    docs: int = 1024
    edits_per_client: int = 2
    ops_per_edit: int = 4
    key_space: int = 32          # per-doc key universe (forces co-editor merges)
    spread: float = 2.0          # edit times are spread over [0, spread)
    chaos: float = 0.0           # per-link drop/dup/reorder probability
    poison: float = 0.0          # fraction of docs with hostile clients
    tenants: int = 4             # clients round-robin across this many tenants
    max_time: float = 900.0      # simulated-seconds budget
    seed: int = 0
    tick: float = 0.01           # clock advance while traffic is moving
    batcher: BatcherConfig = field(default_factory=BatcherConfig)
    session: SessionConfig = field(default_factory=SessionConfig)
    # observability stack for the run: "metrics" (the baseline —
    # metrics registry only), "full" (metrics + amscope request tracing +
    # flight recorder), or "off" (nothing enabled: the library-user hot
    # path, used by the bench overhead gate)
    observability: str = "metrics"
    flight_dir: str | None = None       # auto-dump dir for "full" runs
    snapshot_path: str | None = None    # JSONL telemetry snapshots (--watch)
    snapshot_interval: float = 0.5      # simulated seconds between snapshots
    # SLO knobs (active whenever the metrics registry is on). The latency
    # budget is simulated ms against serve.sync.latency_ms and rounds DOWN
    # to a log2 bucket bound (1000 -> 536.87ms effective): generous enough
    # for the batching window + one dispatch, breached by retransmission
    # storms.
    slo_budget_ms: float = 1000.0
    slo_latency_target: float = 0.99


class _Client:
    """One simulated editor: a reference-backend replica + its session."""

    __slots__ = ("index", "actor", "doc", "driver", "session", "seq",
                 "max_op", "poisoned", "edits_left", "inflight_since",
                 "inflight_seq")

    def __init__(self, index, actor, doc, driver, session, poisoned):
        self.index = index
        self.actor = actor
        self.doc = doc
        self.driver = driver
        self.session = session
        self.poisoned = poisoned
        self.seq = 0
        self.max_op = 0
        self.edits_left = 0
        self.inflight_since = None   # first-send time of the unacked payload
        self.inflight_seq = None


class LoadGen:
    """Builds the fleet and runs the event loop. ``run()`` returns the
    report dict; ``self.server``/``self.farm``/``self.clients`` stay
    inspectable afterwards (tests assert on them)."""

    def __init__(self, farm, config: LoadConfig | None = None):
        self.config = config or LoadConfig()
        self.farm = farm
        cfg = self.config
        self.clock = ManualClock()
        self.rng = random.Random(cfg.seed)
        self.net = ChaosNetwork(
            random.Random(cfg.seed + 1), self.clock,
            ChaosConfig.lossy(cfg.chaos),
        )
        self.server = AmServer(
            farm, clock=self.clock, rng=random.Random(cfg.seed + 2),
            config=cfg.batcher, session_config=cfg.session,
        )
        n_poison = int(round(cfg.poison * cfg.docs))
        stride = max(cfg.docs // n_poison, 1) if n_poison else 1
        self.poison_docs = {i * stride for i in range(n_poison)}
        self.clients: list[_Client] = []
        self._build_clients()
        self._schedule = self._build_schedule()
        self._next_event = 0
        self._busy_up: set[int] = set()
        self._busy_down: set[int] = set()
        self._active: set[int] = set()
        self.shed_frames = 0
        self.rejected_down = 0
        self._snapshots = None  # SnapshotWriter, armed by run()
        self._slo = None        # SLOEngine, armed by run()

    # -------------------------------------------------------------- #
    # fleet construction

    def _build_clients(self) -> None:
        cfg = self.config
        for i in range(cfg.clients):
            doc = i % cfg.docs
            client = _Client(
                index=i,
                actor=f"{i:08x}",
                doc=doc,
                driver=BackendDriver(Backend.init()),
                session=None,
                poisoned=doc in self.poison_docs,
            )
            client.session = SyncSession(
                client.driver, clock=self.clock,
                rng=random.Random(cfg.seed * 7919 + i),
                config=cfg.session,
            )
            client.edits_left = cfg.edits_per_client
            self.clients.append(client)
            self.server.connect(i, doc, tenant=f"t{i % cfg.tenants}")

    def _build_schedule(self) -> list[tuple[float, int]]:
        """(time, client index) edit events, sorted. One client's edits
        stay ordered so its seq numbers commit in order."""
        cfg = self.config
        events = []
        for client in self.clients:
            times = sorted(
                self.rng.uniform(0.0, cfg.spread)
                for _ in range(cfg.edits_per_client)
            )
            events.extend((t, client.index) for t in times)
        events.sort()
        return events

    # -------------------------------------------------------------- #
    # workload

    def _edit(self, client: _Client) -> None:
        cfg = self.config
        client.seq += 1
        start = client.max_op + 1
        ops = []
        for k in range(cfg.ops_per_edit):
            key = f"k{self.rng.randrange(cfg.key_space)}"
            ops.append(set_op(key, client.index * 1000 + client.seq))
        buf = make_change(
            client.actor, client.seq, start,
            Backend.get_heads(client.driver.backend), ops,
        )
        client.max_op = start + len(ops) - 1
        client.driver.backend, _ = Backend.apply_changes(
            client.driver.backend, [buf]
        )
        client.edits_left -= 1
        self._active.add(client.index)

    def _corrupt_payload(self, client: _Client, frame: bytes) -> bytes:
        """The hostile-client transform: keeps the envelope and message
        structurally valid but damages every change buffer inside, so the
        farm's per-doc isolation (not the protocol layer) takes the hit."""
        parsed = decode_frame(frame)
        if parsed["payload"] is None:
            return frame
        msg = decode_sync_message(parsed["payload"])
        if not msg["changes"]:
            return frame
        msg["changes"] = [bytes(bit_flipped(c)) for c in msg["changes"]]
        return encode_frame(
            parsed["epoch"], parsed["seq"], parsed["ack"],
            encode_sync_message(msg),
        )

    # -------------------------------------------------------------- #
    # event loop

    def _poll_clients(self) -> bool:
        moved = False
        for i in sorted(self._active):
            client = self.clients[i]
            frame = client.session.poll()
            if frame is None:
                if client.session.pending is None:
                    self._active.discard(i)
                continue
            moved = True
            if client.poisoned:
                frame = self._corrupt_payload(client, frame)
            self.net.link(i, _SERVER).send(frame)
            self._busy_up.add(i)
            pending = client.session.pending
            if pending is not None and pending["seq"] != client.inflight_seq:
                client.inflight_seq = pending["seq"]
                client.inflight_since = self.clock()
        return moved

    def _deliver_up(self) -> bool:
        moved = False
        for i in sorted(self._busy_up):
            link = self.net.link(i, _SERVER)
            for frame in link.deliver():
                moved = True
                try:
                    self.server.receive(i, frame)
                except AutomergeError:
                    self.shed_frames += 1
                    _M_SHED_ADMISSION.inc()
            if link.in_flight == 0:
                self._busy_up.discard(i)
        return moved

    def _pump_server(self) -> bool:
        moved = False
        self.server.tick()
        for i, frame in self.server.pump():
            moved = True
            self.net.link(_SERVER, i).send(frame)
            self._busy_down.add(i)
        return moved

    def _deliver_down(self) -> bool:
        moved = False
        now = self.clock()
        for i in sorted(self._busy_down):
            link = self.net.link(_SERVER, i)
            client = self.clients[i]
            for frame in link.deliver():
                moved = True
                try:
                    client.session.handle(frame)
                except SyncProtocolError:
                    self.rejected_down += 1
                    _M_REJECTED_DOWN.inc()
                self._active.add(i)
                if client.inflight_seq is not None and (
                    client.session.pending is None
                ):
                    if not client.session.quarantined:
                        _M_LATENCY.observe(
                            max(now - client.inflight_since, 1e-6) * 1000.0
                        )
                    client.inflight_seq = None
                    client.inflight_since = None
            if link.in_flight == 0:
                self._busy_down.discard(i)
        return moved

    def _issue_due_edits(self) -> bool:
        now = self.clock()
        issued = False
        while (
            self._next_event < len(self._schedule)
            and self._schedule[self._next_event][0] <= now
        ):
            _, i = self._schedule[self._next_event]
            self._next_event += 1
            self._edit(self.clients[i])
            issued = True
        return issued

    def _surviving(self) -> list[_Client]:
        dead = self.poison_docs | set(self.farm.quarantine)
        return [c for c in self.clients if c.doc not in dead]

    def _unconverged(self, candidates=None) -> list[_Client]:
        out = []
        for client in candidates if candidates is not None else self._surviving():
            if client.driver.heads() != self.farm.get_heads(client.doc):
                out.append(client)
        return out

    def _next_wakeup(self) -> float | None:
        """Earliest future event: a scheduled edit, the batcher window,
        a retransmission deadline (client or server), or a delayed frame
        arriving on a busy link."""
        times = []
        if self._next_event < len(self._schedule):
            times.append(self._schedule[self._next_event][0])
        deadline = self.server.next_deadline()
        if deadline is not None:
            times.append(deadline)
        for i in self._active:
            pending = self.clients[i].session.pending
            if pending is not None:
                times.append(pending["deadline"])
        for i in self._busy_up:
            at = self.net.link(i, _SERVER).next_arrival()
            if at is not None:
                times.append(at)
        for i in self._busy_down:
            at = self.net.link(_SERVER, i).next_arrival()
            if at is not None:
                times.append(at)
        return min(times, default=None)

    def run(self) -> dict:
        """Drives the fleet to convergence (or the simulated-time budget)
        and returns the report. ``config.observability`` picks the stack:
        "metrics" enables the registry (the historical behaviour), "full"
        adds amscope request tracing (phase breakdowns, exemplars, the
        tenant table) and the flight recorder (auto-dumping to
        ``flight_dir`` on quarantine/watchdog events), "off" enables
        nothing — the disabled-hot-path shape the bench overhead gate
        measures. Whenever the registry is on, an ``SLOEngine`` over
        ``default_serve_slos`` samples multi-window burn rates on the
        simulated clock and the report carries its verdicts under
        ``"slo"``."""
        import contextlib

        cfg = self.config
        # the registry is process-wide: zero it so the report reflects
        # exactly this run (the same convention as bench.py's workloads)
        _METRICS.reset()
        scope, flight = get_amscope(), get_flight()
        stack = contextlib.ExitStack()
        if cfg.observability == "full":
            scope.reset()
            flight.clear()
            was_clock, was_dir = flight.clock, flight.dump_dir
            flight.clock = self.clock  # simulated-time timeline
            stack.enter_context(enabled_metrics())
            scope.enabled = True
            stack.callback(lambda: setattr(scope, "enabled", False))
            flight.enabled = True
            if cfg.flight_dir is not None:
                flight.dump_dir = cfg.flight_dir

            def _restore_flight():
                flight.enabled = False
                flight.dump_dir = was_dir
                flight.clock = was_clock

            stack.callback(_restore_flight)
        elif cfg.observability == "metrics":
            stack.enter_context(enabled_metrics())
        elif cfg.observability != "off":
            raise ValueError(  # amlint: disable=AM401 — API-usage validation
                f"unknown observability mode: {cfg.observability!r}"
            )
        self._slo = (
            SLOEngine(
                default_serve_slos(
                    budget_ms=cfg.slo_budget_ms,
                    latency_target=cfg.slo_latency_target,
                    latency_metric="serve.sync.latency_ms",
                ),
                clock=self.clock,
            )
            if cfg.observability != "off" else None
        )
        self._snapshots = (
            SnapshotWriter(cfg.snapshot_path, cfg.snapshot_interval,
                           clock=self.clock, slo_engine=self._slo)
            if cfg.snapshot_path else None
        )
        slo_verdicts = None
        with stack:
            converged = self._run_loop()
            surviving = self._surviving()
            unconverged = self._unconverged(surviving)
            if self._slo is not None:
                denom = len(surviving) or 1
                _M_CONVERGED_RATIO.set(
                    round((len(surviving) - len(unconverged)) / denom, 6)
                )
                slo_verdicts = self._slo.export()
            if self._snapshots is not None:
                self._snapshots.write(self.clock())
        metrics = _METRICS.as_dict()
        occupancy = metrics.get("serve.batch.occupancy", {})
        dispatches = occupancy.get("count", 0)
        latency = metrics.get("serve.sync.latency_ms", {})
        committed = metrics.get("serve.batch.changes", {}).get("value", 0)
        extras = {}
        if slo_verdicts is not None:
            extras["slo"] = {
                "verdicts": slo_verdicts,
                "ok": verdicts_ok(slo_verdicts),
            }
        if cfg.observability == "full":
            extras["breakdown"] = request_breakdown(metrics)
            extras["tenants"] = scope.tenant_stats()
            extras["dispatch_spans"] = len(scope.dispatches)
            extras["flight_events"] = len(flight)
            extras["flight_dumps"] = list(flight.dump_paths)
        return {
            **extras,
            "clients": cfg.clients,
            "docs": cfg.docs,
            "edits": cfg.clients * cfg.edits_per_client,
            "ops": cfg.clients * cfg.edits_per_client * cfg.ops_per_edit,
            "converged": converged and not unconverged,
            "surviving_clients": len(surviving),
            "unconverged_clients": len(unconverged),
            "poisoned_docs": len(self.poison_docs),
            "quarantined_docs": len(self.farm.quarantine),
            "simulated_s": round(self.clock.now(), 3),
            "dispatches": dispatches,
            "occupancy_mean": round(
                occupancy.get("sum", 0.0) / dispatches, 2
            ) if dispatches else 0.0,
            "changes_committed": committed,
            "latency_ms": {
                "p50": latency.get("p50"),
                "p95": latency.get("p95"),
                "p99": latency.get("p99"),
                "samples": latency.get("count", 0),
            },
            "admission": {
                "accepted": metrics.get(
                    "serve.admission.accepted", {}).get("value", 0),
                "rejected_quarantine": metrics.get(
                    "serve.admission.rejected_quarantine", {}).get("value", 0),
                "rejected_backpressure": metrics.get(
                    "serve.admission.rejected_backpressure", {}).get("value", 0),
                "shed_mid_window": metrics.get(
                    "serve.flush.shed_quarantined", {}).get("value", 0),
            },
            "frames_shed": self.shed_frames,
            "frames_rejected_by_clients": self.rejected_down,
        }

    def _run_loop(self) -> bool:
        cfg = self.config
        idle_checks = 0
        while self.clock.now() < cfg.max_time:
            if self._slo is not None:
                self._slo.sample(self.clock())
            if self._snapshots is not None:
                self._snapshots.maybe_write(self.clock())
            moved = self._issue_due_edits()
            moved |= self._poll_clients()
            moved |= self._deliver_up()
            moved |= self._pump_server()
            moved |= self._deliver_down()
            if moved:
                idle_checks = 0
                self.clock.advance(cfg.tick)
                continue
            wake = self._next_wakeup()
            if wake is not None:
                self.clock.advance(max(wake - self.clock.now(), cfg.tick))
                continue
            # fully quiet: either converged, or a stalled pair needs a
            # kick (re-activate unconverged channels so generate runs)
            unconverged = self._unconverged()
            if not unconverged and self._next_event >= len(self._schedule):
                return True
            idle_checks += 1
            if idle_checks > 50:
                return False  # persistent stall; report unconverged
            for client in unconverged:
                self._active.add(client.index)
                self.server.wake(client.index)
            self.clock.advance(cfg.session.timeout)
        return False

"""Mesh worker runtime: one shard's ``TorchDocFarm`` in its own process.

``MeshFarm(mesh_backend="process")`` pairs every shard with a worker
process (this module): the controller keeps only the routing arrays, the
actor reconcile and the result fan-in, while ALL of a shard's host work —
decode, causal gate, column transcode, device dispatch, patch
materialization — runs under the worker's own Python interpreter. The
farm is host-bound (its gate, patch assembly and decode dwarf the device
dispatch), so this is what puts more than one host core to work: the
per-shard host phases that serialize under one GIL in the inline backend
run in N processes.

Every worker builds its farm on the device its spec names
(``spec["device"]``, a string; ``"cuda"`` by default), with a CUDA context
of its own: N workers on one card share ``cuda:0``, and without MPS their
kernels time-slice the card. A worker never builds a CPU farm in place of
the card — without CUDA its farm raises, and the error reaches the
controller through the readiness barrier. The merge runs as plain torch
ops; no worker launches a kernel of ``csrc/`` (the Bloom kernels run in
the controller's ``SyncFarm``).

Protocol (length-framed pickles over a ``multiprocessing`` pipe):

- parent -> child: ``(op, payload)`` — deliveries fan out as per-shard
  column batches (raw change bytes + local routing indices; shards
  share NO mutable state, so nothing else needs to travel). Under the
  pickle transport the batch itself rides in the frame; under the shm
  transport (``parallel/shm.py``) the batch is already sitting in the
  shard's send ring and ``payload[0]`` is a tiny ``SlotRef`` control
  handle instead — same tuple arity either way. Apply payloads carry
  an ``obs`` leg: the controller's flight-enable bit and the ambient
  ``DispatchSpan`` id, so worker-side latency observations stamp the
  controller's trace ids (restored via ``obs.scope.exemplar_context``);
- child -> parent: ``(status, payload, metrics_delta, flight_events)``
  — apply results return as compact frames (patch blob + flat outcome
  tuples, see ``tpu.farm.result_to_wire``; host data only, never a
  tensor) so the controller defers
  patch materialization until someone actually indexes the result.
  Under shm the worker struct-encodes the frame into its result ring
  and ``resp["patches"]``/``resp["outcomes"]`` become one shared
  ``SlotRef`` (falling back to the inline pickled form when the ring
  is briefly full — degrade, never deadlock); every response
  piggybacks the worker registry's metric delta (exemplars included),
  the worker flight recorder's unshipped tail (heartbeat pongs ship it
  too), and, on request, the worker's phase-profile dump for
  ``--watch`` attribution.

Crash forensics: when flight is enabled the worker maintains a bounded
**black-box file** (``obs.flight.write_blackbox``: shard-tagged flight
tail + the last delivery's phase profile), rewritten atomically after
every telemetry-bearing response, registered for an atexit flush, and
flushed again on the fault path — so a SIGKILL mid-delivery still
leaves the previous deliveries' events on disk for ``_recover_worker``
to absorb into the ``mesh.worker.crash`` dump.

Workers are spawned with the **spawn** (not fork) start method: a CUDA
context does not survive a fork, and spawn gives each worker a pristine
interpreter that inherits the controller's environment. Consequently this
module must import cleanly WITHOUT pulling in torch or the farm — the
heavy imports happen inside ``_worker_main`` (pinned by
tests/test_torch_mesh_workers.py).

Supervision lives in ``WorkerHandle``: readiness barrier at spawn,
heartbeat ping, crash detection on every receive (pipe EOF, dead
process, timeout), SIGKILL-hard ``close``. Respawn + doc re-hydration
policy is the controller's (meshfarm.py) — the handle only detects and
reports via ``WorkerCrashError``.
"""
# amlint: mesh-worker
# amlint: mesh-data-plane
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import signal
import time

from ..errors import WorkerCrashError
from . import shm as _shm

#: how long a worker waits for a free result slot before degrading the
#: one response to the inline pickle path (the controller meters it as a
#: ``mesh.shm.<s>.stalls`` tick)
_RESULT_SLOT_TIMEOUT_S = 0.25

_PING_TIMEOUT_S = 5.0


# ---------------------------------------------------------------------- #
# worker child

# (The JAX runtime strips a forced XLA host-device count from each child's
# environment here; that flag has no torch meaning, so nothing is stripped.)


def _worker_main(conn, spec: dict) -> None:
    """Child entry point. Maps the shm rings (stdlib only), then does the
    heavy imports and builds the shard farm on ``spec["device"]``,
    optionally warms it against a throwaway farm, and serves the op loop
    until shutdown/EOF. A setup failure (no CUDA for a card farm, a store
    that will not open) ships as an ``err`` frame through the readiness
    barrier."""
    # shm transport: map the controller-owned rings by name BEFORE the
    # heavy imports (pure stdlib; a respawned worker re-attaches to the
    # same segments here — that is the "remap" the controller meters)
    send_ring = result_ring = None
    if spec.get("shm"):
        send_ring = _shm.attach_ring(spec["shm"]["send"])
        result_ring = _shm.attach_ring(spec["shm"]["result"])

    # each worker records into ITS OWN process-wide registry, flight
    # recorder and observatory and ships deltas/event tails back with
    # every response; the controller merges them.
    import torch

    # amlint: disable=AM502,AM305 — the worker's own recorder IS the
    # shipping buffer: events ship over the pipe / the black-box file,
    # never through this process's exposition
    from ..obs.flight import get_flight, write_blackbox
    # amlint: disable=AM502 — this IS the worker's own registry: the
    # process-global singleton of the *worker* process, never the
    # controller's (deltas ship via diff_frames/merge_frame)
    from ..obs.metrics import diff_frames, get_metrics
    # amlint: disable=AM502 — the worker's own observatory: per-program
    # dispatch counters land in the worker registry and ship home through
    # the same metrics delta as everything else
    from ..obs.prof import get_observatory
    from ..obs.scope import exemplar_context
    from ..profiling import PhaseProfile, use_profile
    from ..tpu.farm import (TorchDocFarm, exc_from_blob, exc_to_blob,
                            result_to_wire)

    metrics = get_metrics()  # amlint: disable=AM502 — same shipping buffer
    metrics.enable()
    flight = get_flight()  # amlint: disable=AM502,AM305 — shipping buffer
    observatory = get_observatory()  # amlint: disable=AM502 — see above
    flight.shard = spec["shard"]
    flight.epoch = spec.get("epoch", 0)
    blackbox_path = spec.get("blackbox_path")
    m_blackbox = metrics.counter(
        "mesh.telemetry.blackbox.writes",
        "black-box files persisted by this worker",
    )
    last_phases = ""
    blackbox_mark = flight._seq  # no events yet -> no file

    def _flush_blackbox() -> None:
        # bounded + atomic; skipped while nothing new happened so the
        # obs-off path never touches the disk
        nonlocal blackbox_mark
        if blackbox_path is None or flight._seq == blackbox_mark:
            return
        blackbox_mark = flight._seq
        write_blackbox(blackbox_path, flight, last_phases)
        m_blackbox.inc()

    import atexit

    atexit.register(_flush_blackbox)
    farm_args = dict(
        capacity=spec["capacity"],
        quarantine_threshold=spec["quarantine_threshold"],
        page_size=spec["page_size"],
        device=spec["device"],
    )
    store = None
    try:
        if torch.device(spec["device"]).type == "cpu":
            # N CPU workers share the host's cores: one intra-op thread
            # each, not N full pools contending for them
            torch.set_num_threads(1)
        farm = TorchDocFarm(spec["num_docs"], **farm_args)
        if spec.get("store_dir"):
            # per-shard crash-consistent store: opening IS recovery, so a
            # respawned worker re-hydrates every committed delivery from
            # disk before the controller's (idempotent) delivery-log
            # replay lands. The store layer records into this worker's own
            # registry/recorder; its counters ship home through the same
            # metrics delta.
            from ..store import ShardStore, hydrate_farm

            store = ShardStore(spec["store_dir"])
            hydrate_farm(farm, store)
            farm.attach_store(store)
        if spec.get("warm_buffers"):
            # run the all-docs-active dispatch shapes once on a throwaway
            # farm before the readiness barrier lifts (CUDA context,
            # allocator and first-dispatch costs), so the measured window
            # never includes worker-side warm-up
            warm = TorchDocFarm(spec["num_docs"], **farm_args)
            warm.apply_changes(
                [list(spec["warm_buffers"]) for _ in range(warm.num_docs)],
                isolation="doc",
            )
            del warm
    except Exception as exc:  # ship the setup failure through the barrier
        conn.send(("err", exc_to_blob(exc), None, None))
        return
    last_frame = metrics.frame()
    conn.send(("ready", os.getpid(), None, None))

    crash_armed = False
    while True:
        try:
            op, payload = conn.recv()
        except (EOFError, OSError):
            break
        if op == "shutdown":
            conn.send(("ok", None, None, None))
            break
        if op == "_debug_die_now":
            # fire-and-forget test hook: die as if kill -9'd externally
            os.kill(os.getpid(), signal.SIGKILL)
        if op == "_debug_die_on_next_apply":
            crash_armed = True
            conn.send(("ok", None, None, None))
            continue
        try:
            if op == "apply":
                if crash_armed:
                    os.kill(os.getpid(), signal.SIGKILL)
                # the obs leg toggles this worker's flight recorder to
                # mirror the controller's and restores the controller's
                # ambient dispatch-span id for exemplar stamping
                obs = payload[3] if len(payload) > 3 else None
                flight.enabled = bool(obs and obs.get("flight"))
                observatory.enabled = bool(obs and obs.get("prof"))
                if send_ring is not None and isinstance(payload[0],
                                                        _shm.SlotRef):
                    # the column batch is in the send ring, not the frame:
                    # validate the handle, copy the buffers out, free the
                    # slot so the controller's next delivery can reuse it
                    ref = payload[0]
                    view = send_ring.accept(ref)
                    try:
                        active = _shm.decode_columns(view)
                    finally:
                        del view
                        send_ring.release(ref.slot)
                    payload = (active,) + tuple(payload[1:])
                with exemplar_context(obs.get("exemplar") if obs else None):
                    resp = _do_apply(
                        farm, payload, PhaseProfile, use_profile,
                        result_to_wire, exc_to_blob,
                    )
                if result_ring is not None:
                    resp = _ship_result_shm(result_ring, resp)
                if isinstance(resp, dict) and resp.get("phases"):
                    last_phases = resp["phases"]
            else:
                resp = _dispatch(farm, op, payload, exc_to_blob, exc_from_blob)
            frame = metrics.frame()
            delta = diff_frames(frame, last_frame)
            last_frame = frame
            events = flight.ship()
            try:
                conn.send(("ok", resp, delta, events))
            except Exception as send_exc:  # unpicklable response payload
                conn.send(("err", exc_to_blob(send_exc), delta, events))
            _flush_blackbox()
        except BaseException as exc:  # ship the failure; keep serving
            _flush_blackbox()
            frame = metrics.frame()
            delta = diff_frames(frame, last_frame)
            last_frame = frame
            conn.send(("err", exc_to_blob(exc), delta, flight.ship()))
    if store is not None:
        store.close()  # final durability barrier on clean shutdown
    for ring in (send_ring, result_ring):
        if ring is not None:
            ring.close()  # attach side: drops the mapping, never unlinks


def _do_apply(farm, payload, PhaseProfile, use_profile, result_to_wire,
              exc_to_blob) -> dict:
    active, is_local, want_phases = payload[0], payload[1], payload[2]
    per_doc = [[] for _ in range(farm.num_docs)]
    for loc, bufs in active:
        per_doc[loc] = list(bufs)
    q_before = set(farm.quarantine)
    t0 = time.perf_counter()
    if want_phases:
        prof = PhaseProfile()
        with use_profile(prof):
            result = farm.apply_changes(per_doc, is_local=is_local,
                                        isolation="doc")
        phases = prof.to_jsonl()
    else:
        result = farm.apply_changes(per_doc, is_local=is_local,
                                    isolation="doc")
        phases = ""
    wall_s = time.perf_counter() - t0
    resp = result_to_wire(result)
    # the controller's quarantine mirror and no-op-patch mirror update
    # from these two deltas — untouched shards then serve facade reads
    # with ZERO round trips
    resp["q_entered"] = {
        loc: exc_to_blob(farm.quarantine[loc])
        for loc in set(farm.quarantine) - q_before
    }
    resp["noop"] = {
        loc: (farm.max_op[loc], dict(farm.clock[loc]),
              list(farm.heads[loc]), len(farm.queue[loc]))
        for loc, _ in active
    }
    resp["phases"] = phases
    resp["wall_s"] = wall_s
    return resp


def _ship_result_shm(result_ring, resp: dict) -> dict:
    """Moves the bulk of one apply response — the patch blob and the
    outcome tuples — into the result ring, leaving a ``SlotRef`` where
    the payload was. A full ring (controller holding every slot as lazy
    patches) or an oversize frame degrades THIS response to the inline
    pickled form instead of ever blocking the op loop; the controller
    notices the inline shape and meters the stall."""
    frame = _shm.encode_result(resp["patches"], resp["outcomes"])
    if len(frame) > result_ring.slot_bytes:
        return resp
    try:
        slot, gen = result_ring.acquire(timeout=_RESULT_SLOT_TIMEOUT_S)
    except _shm.RingStall:
        return resp
    view = result_ring.slot_view(slot)
    try:
        view[:len(frame)] = frame
    finally:
        del view
    ref = result_ring.publish(slot, gen, len(frame))
    resp["patches"] = ref
    resp["outcomes"] = ref
    return resp


def _dispatch(farm, op: str, payload, exc_to_blob, exc_from_blob):
    if op == "get_patch":
        return farm.get_patch(payload)
    if op == "get_heads":
        return farm.get_heads(payload)
    if op == "get_all_changes":
        return farm.get_all_changes(payload)
    if op == "get_changes":
        loc, have_deps = payload
        return farm.get_changes(loc, have_deps)
    if op == "get_change_by_hash":
        loc, hash_ = payload
        return farm.get_change_by_hash(loc, hash_)
    if op == "get_missing_deps":
        loc, heads = payload
        return farm.get_missing_deps(loc, heads)
    if op == "noop_state":
        loc = payload
        return (farm.max_op[loc], dict(farm.clock[loc]),
                list(farm.heads[loc]), len(farm.queue[loc]))
    if op == "release_quarantine":
        return farm.release_quarantine(payload)
    if op == "quarantine_map":
        return {loc: exc_to_blob(e) for loc, e in farm.quarantine.items()}
    if op == "force_quarantine":
        loc, blob = payload
        farm.quarantine[loc] = exc_from_blob(blob)
        return None
    if op == "actor_table":
        return list(farm.actors.table)
    if op == "intern_actors":
        missing = [a for a in payload if farm.actors.find(a) is None]
        for a in missing:
            farm.actors.intern(a)
        return len(missing)
    if op == "export_doc":
        return farm.export_doc(payload)
    if op == "adopt_doc":
        loc, export = payload
        farm.adopt_doc(loc, export)
        return None
    if op == "evict_doc":
        farm.evict_doc(payload)
        return None
    if op == "pages_allocated":
        return int(farm.engine.pages.allocated)
    if op == "doc_lengths":
        return farm.engine.lengths.tolist()
    if op == "replay":
        # crash re-hydration: the controller's committed delivery log,
        # replayed per doc in order. Doc-isolated applies commute across
        # docs, so per-doc replay reproduces the pre-crash patch state
        # byte for byte (pinned by tests/test_mesh_workers.py).
        rehydrated = 0
        for loc, deliveries in payload:
            for bufs, is_local in deliveries:
                per_doc = [[] for _ in range(farm.num_docs)]
                per_doc[loc] = list(bufs)
                farm.apply_changes(per_doc, is_local=is_local,
                                   isolation="doc")
            if deliveries:
                rehydrated += 1
        return rehydrated
    if op == "ping":
        return "pong"
    raise ValueError(f"unknown mesh worker op {op!r}")


# ---------------------------------------------------------------------- #
# controller-side handle


class WorkerHandle:
    """One shard worker's lifecycle + RPC surface, controller side.

    ``request``/``collect`` are split so the controller can fan a
    delivery out to every touched shard before collecting any result
    (the workers overlap); ``call`` is the sequential convenience. Every
    receive path detects death — pipe EOF, exited process, timeout — and
    raises ``WorkerCrashError``; recovery policy (respawn, re-hydrate,
    quarantine in-flight docs) belongs to the controller.

    ``on_delta`` receives each response's metric delta frame;
    ``on_flight`` receives each response's shipped flight-event tail;
    ``on_rpc`` fires once per request; ``on_pipe`` receives
    ``(direction, frame_bytes, pickle_seconds, kind)`` for every frame
    the handle moves — the mesh pickle tax, measured, with ``kind``
    splitting column-payload frames (``"payload"``: an apply request
    carrying the batch inline, a response carrying an inline patch
    blob) from control frames (``"control"``: everything else — ops,
    SlotRefs, acks) so the shm transport's win is attributable per
    frame class (all injected by meshfarm so this module never touches
    the controller's process-global registries). With ``on_pipe`` set
    the handle pickles frames explicitly (``Connection.send`` ==
    ``send_bytes(dumps(...))``, so the child's native protocol is
    unchanged).

    ``last_ok`` is the monotonic timestamp of the last successful
    response (readiness counts) — ``heartbeat_age()`` is what the crash
    event reports as "how long was this worker silent"."""

    def __init__(self, spec: dict, timeout: float | None = None,
                 on_delta=None, on_rpc=None, on_flight=None, on_pipe=None,
                 defer_ready: bool = False):
        self.spec = spec
        if timeout is None:
            timeout = float(os.environ.get("AM_MESH_WORKER_TIMEOUT_S", "600"))
        self.timeout = timeout
        self._on_delta = on_delta
        self._on_rpc = on_rpc
        self._on_flight = on_flight
        self._on_pipe = on_pipe
        self.conn = None
        self.proc = None
        self._ready = False
        self.last_ok: float | None = None
        self._start()
        if not defer_ready:
            self.ensure_ready()

    # -- lifecycle ----------------------------------------------------- #

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(
            target=_worker_main, args=(child_conn, self.spec),
            daemon=True, name=f"am-mesh-worker-{self.spec['shard']}",
        )
        proc.start()
        child_conn.close()
        self.conn, self.proc = parent_conn, proc
        self._ready = False

    def ensure_ready(self) -> int:
        """Blocks on the worker's readiness message (farm built, warm-up
        done). Deferring this lets a controller start every worker first
        so their initialization overlaps. Returns the worker pid; a
        worker whose setup failed has its error re-raised here."""
        if self._ready:
            return self.pid
        msg = self._recv(self.timeout)
        if msg[0] == "err":
            from ..tpu.farm import exc_from_blob

            self._kill()
            raise exc_from_blob(msg[1])
        if msg[0] != "ready":
            self._kill()
            raise WorkerCrashError(
                f"shard {self.spec['shard']} worker sent {msg[0]!r} "
                "instead of readiness"
            )
        self._ready = True
        self.last_ok = time.monotonic()
        return msg[1]

    def spawn(self) -> int:
        """Starts the worker and waits for readiness. Returns the pid."""
        self._start()
        return self.ensure_ready()

    def respawn(self) -> int:
        self._kill()
        # a fresh epoch: the respawned worker's restarted flight seqs must
        # not collide with its previous life's in the merged timeline
        self.spec["epoch"] = self.spec.get("epoch", 0) + 1
        return self.spawn()

    def heartbeat_age(self, now: float | None = None) -> float | None:
        """Seconds since the last successful response, or None before
        readiness ever completed."""
        if self.last_ok is None:
            return None
        return (time.monotonic() if now is None else now) - self.last_ok

    def _kill(self) -> None:
        if self.proc is None:
            return
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(1.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(1.0)
        if self.conn is not None:
            self.conn.close()
        self.conn = self.proc = None

    def close(self, timeout: float = 5.0) -> None:
        """Clean shutdown: ack'd shutdown op, then join; stragglers are
        terminated. Leaves zero child processes behind (pinned by
        tests/test_mesh_workers_smoke.py)."""
        if self.proc is None:
            return
        try:
            self.conn.send(("shutdown", None))
            deadline = time.monotonic() + timeout
            while self.proc.is_alive() and time.monotonic() < deadline:
                if self.conn.poll(0.05):
                    self.conn.recv()  # the shutdown ack (or a straggler)
                else:
                    self.proc.join(0.05)
        except (OSError, EOFError, BrokenPipeError):
            pass
        self._kill()

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()

    @property
    def pid(self) -> int | None:
        return None if self.proc is None else self.proc.pid

    # -- transport ----------------------------------------------------- #

    def _crash(self, why: str) -> WorkerCrashError:
        return WorkerCrashError(
            f"shard {self.spec['shard']} worker (pid {self.pid}): {why}"
        )

    def _recv(self, timeout: float):
        if self.conn is None:
            raise self._crash("not running")
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._kill()
                raise self._crash(f"no response within {timeout:.0f}s")
            try:
                if self.conn.poll(min(0.2, remaining)):
                    return self._recv_frame()
            except (EOFError, OSError) as e:
                raise self._crash(f"pipe closed mid-receive ({e!r})") from e
            if not self.proc.is_alive():
                # drain a final message the worker flushed before dying
                try:
                    if self.conn.poll(0):
                        return self._recv_frame()
                except (EOFError, OSError):
                    pass
                raise self._crash(
                    f"process died (exitcode {self.proc.exitcode})"
                )

    def _recv_frame(self):
        """One frame off the pipe. ``Connection.recv`` IS
        ``loads(recv_bytes())``; splitting the two steps when ``on_pipe``
        is injected makes the frame size and deserialize time observable
        without changing the wire format."""
        if self._on_pipe is None:
            return self.conn.recv()
        buf = self.conn.recv_bytes()
        t0 = time.perf_counter()
        msg = pickle.loads(buf)
        dt = time.perf_counter() - t0
        # a response is a column payload iff the patch blob rides inline;
        # under shm it is a SlotRef and the frame is pure control
        payload_in = (
            isinstance(msg, tuple) and len(msg) == 4
            and isinstance(msg[1], dict)
            and isinstance(msg[1].get("patches"), (bytes, bytearray))
        )
        self._on_pipe("in", len(buf), dt,
                      "payload" if payload_in else "control")
        return msg

    def request(self, op: str, payload=None) -> None:
        if self._on_rpc is not None:
            self._on_rpc()
        if self.conn is None:
            raise self._crash("not running")
        try:
            if self._on_pipe is None:
                self.conn.send((op, payload))
            else:
                t0 = time.perf_counter()
                # amlint: disable=AM504 — the pickle-ORACLE transport: under
                # mesh_transport="pickle" the column batch legitimately rides
                # the frame (byte-for-byte parity baseline); under shm the
                # batch is a SlotRef by the time it reaches here
                buf = pickle.dumps((op, payload),
                                   protocol=pickle.HIGHEST_PROTOCOL)
                ser_s = time.perf_counter() - t0
                self.conn.send_bytes(buf)
                # an apply whose batch rides inline is the column payload
                # path; a SlotRef apply (shm) is a control frame
                payload_out = (
                    op == "apply" and isinstance(payload, tuple)
                    and bool(payload) and isinstance(payload[0], list)
                )
                self._on_pipe("out", len(buf), ser_s,
                              "payload" if payload_out else "control")
        except (OSError, BrokenPipeError, ValueError) as e:
            raise self._crash(f"pipe closed mid-send ({e!r})") from e

    def collect(self, timeout: float | None = None):
        status, payload, delta, events = self._recv(
            self.timeout if timeout is None else timeout
        )
        self.last_ok = time.monotonic()
        if delta and self._on_delta is not None:
            self._on_delta(delta)
        if events and self._on_flight is not None:
            self._on_flight(events)
        if status == "err":
            from ..tpu.farm import exc_from_blob

            raise exc_from_blob(payload)
        return payload

    def call(self, op: str, payload=None, timeout: float | None = None):
        self.request(op, payload)
        return self.collect(timeout)

    # -- the shard facade (local doc indexes) -------------------------- #

    def get_patch(self, loc):
        return self.call("get_patch", loc)

    def get_heads(self, loc):
        return self.call("get_heads", loc)

    def get_all_changes(self, loc):
        return self.call("get_all_changes", loc)

    def get_changes(self, loc, have_deps):
        return self.call("get_changes", (loc, have_deps))

    def get_change_by_hash(self, loc, hash_):
        return self.call("get_change_by_hash", (loc, hash_))

    def get_missing_deps(self, loc, heads=()):
        return self.call("get_missing_deps", (loc, heads))

    def release_quarantine(self, loc=None):
        return self.call("release_quarantine", loc)

    def quarantine_map(self) -> dict:
        from ..tpu.farm import exc_from_blob

        return {
            loc: exc_from_blob(blob)
            for loc, blob in self.call("quarantine_map").items()
        }

    def force_quarantine(self, loc, exc) -> None:
        from ..tpu.farm import exc_to_blob

        self.call("force_quarantine", (loc, exc_to_blob(exc)))

    def actor_table(self):
        return self.call("actor_table")

    def intern_actors(self, actors):
        return self.call("intern_actors", list(actors))

    def export_doc(self, loc):
        return self.call("export_doc", loc)

    def adopt_doc(self, loc, export) -> None:
        self.call("adopt_doc", (loc, export))

    def evict_doc(self, loc) -> None:
        self.call("evict_doc", loc)

    def pages_allocated(self):
        return self.call("pages_allocated")

    def doc_lengths(self):
        return self.call("doc_lengths")

    def noop_state(self, loc):
        return self.call("noop_state", loc)

    def replay(self, items):
        return self.call("replay", items)

    def ping(self, timeout: float = _PING_TIMEOUT_S) -> bool:
        self.request("ping")
        return self.collect(timeout) == "pong"

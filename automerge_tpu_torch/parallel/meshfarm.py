"""MeshFarm: a doc-sharded merge farm of shard-local farms.

One controller front over N shard-local ``TorchDocFarm``s. Each shard owns
its documents outright — interners, page slab, host mirrors, quarantine
set — so shards share NO mutable state and each one can live on its own
device: shard ``s`` builds its farm on ``devices[s % len(devices)]``, or
on ``device`` (``"cuda"`` by default) for every shard. On one card every
shard sits on ``cuda:0``. The controller:

- **routes** every document to a shard by a stable doc-id hash
  (splitmix64 of the global index — the placement is a pure function of
  ``(num_docs, num_shards)``, so a restarted controller recovers the
  same routing without any persisted table);
- **fans out** one ``apply_changes`` delivery into per-shard
  ``apply_changes(isolation="doc")`` sub-dispatches and **merges** the
  per-shard ``FarmApplyResult``s back into one global-index result;
- **reconciles** the shard-local actor interner tables every
  ``reconcile_interval`` applies: shards intern actors independently, so
  a reconcile pass exchanges the table deltas (the union is interned
  into every shard) to keep actor-rank-dependent readbacks and sync
  filters globally consistent. Convergence is testable: a second pass
  immediately after a first syncs zero entries;
- **rebalances** hot/overfull documents between shards with
  page-granular migration (``farm.export_doc`` → id translation →
  ``engine.adopt_rows`` whole-page scatter → source ``evict_doc``),
  driven by per-shard slab page occupancy and the controller's per-doc
  dispatch histogram — explicitly via ``rebalance()``, or as a
  controller *policy* that runs every ``rebalance_interval`` applies.

Two execution backends share every code path above through a uniform
per-shard handle interface (``mesh_backend=`` ctor arg / the
``AM_MESH_BACKEND`` env knob):

- ``"inline"`` (default, the parity oracle): shards are in-process
  ``TorchDocFarm``s; ``AM_MESH_CONCURRENCY`` > 1 runs sub-dispatches on
  a thread pool — device dispatches overlap, but every shard's HOST work
  still serializes under one GIL;
- ``"process"``: each shard's farm lives in its own worker process
  (``parallel/workers.py``, spawn-context, one CUDA context per worker;
  without MPS the workers' kernels time-slice the card).
  Deliveries fan out as per-shard column batches over a two-transport
  data plane (``mesh_transport=`` / ``AM_MESH_TRANSPORT``): the default
  ``"shm"`` transport writes each batch into a per-shard shared-memory
  send ring and ships only a ``SlotRef`` control frame over the pipe,
  with results struct-encoded into the worker's result ring the same
  way (``parallel/shm.py``); ``"pickle"`` keeps the batch in the pipe
  frame and stays the byte-for-byte parity oracle (and the automatic
  fallback when POSIX shared memory is unavailable). Either way results
  come back as compact outcome/patch frames (patches stay pickled until
  someone indexes the result — under shm straight out of the mapped
  segment), and the controller additionally keeps
  three tiny mirrors so untouched shards need zero round trips: a
  quarantine mirror (the serve batcher reads ``mesh.quarantine`` on
  every submit), a no-op-patch mirror (clock/heads/maxOp/pending per
  doc) for docs whose shard was not dispatched, and a per-doc
  committed-delivery log that re-hydrates a respawned worker after a
  crash. Worker supervision — heartbeat, crash detection, respawn with
  re-hydration or quarantine of in-flight docs (``WorkerCrashError``) —
  is the controller's job; see ``heartbeat`` and ``_recover_worker``.

The facade exposes the exact ``TorchDocFarm`` surface the serving stack
consumes (``num_docs``, ``device``, ``quarantine``, ``apply_changes``,
``get_*``, ``release_quarantine``), all in GLOBAL doc indexes, so
``SyncFarm`` and ``DynamicBatcher`` run unmodified over a mesh — with
either backend. ``device`` is the controller's: a ``SyncFarm`` over the
mesh builds its Bloom filters there (the Bloom kernels launch in the
controller; no worker launches a kernel).

Decode-cache ownership: the columnar decode caches are process-global
and SHARED by every inline shard on purpose — cached entries hold actor
*strings* and immutable op lists, never interner ids, and each shard
interns at transcode time into its own tables. Sharing parses is safe;
sharing interner state would not be, and there is none to share (pinned
by tests/test_torch_mesh_parity.py). Under the process backend each
worker simply has its own cache with identical behavior (the env knobs
travel to the worker at spawn).

This is the port of the JAX package's ``parallel/meshfarm.py``: every
``mesh.*`` metric and flight event keeps its JAX name.
"""
# amlint: mesh-data-plane
from __future__ import annotations

import contextlib
import contextvars
import os
import pickle
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..errors import PackingLimitError, WorkerCrashError, error_kind
from ..obs.flight import get_flight, read_blackbox
from ..obs.metrics import get_metrics
from ..obs.prof import get_observatory
from ..obs.scope import current_exemplar
from ..profiling import get_profile
from ..tpu.farm import (
    _APPLIED,
    DocOutcome,
    FarmApplyResult,
    TorchDocFarm,
    _empty_object_patch,
    exc_from_blob,
    outcome_from_wire,
)
from . import shm as _shm
from .workers import WorkerHandle

_METRICS = get_metrics()
_M_SHARDS = _METRICS.gauge("mesh.shards", "shards in the mesh farm")
_M_APPLY = _METRICS.counter(
    "mesh.apply.calls", "deliveries fanned out through the mesh front"
)
_M_MIGRATED = _METRICS.counter(
    "mesh.docs.migrated",
    "documents moved between shards by page-granular migration",
)
_M_RECONCILE_RUNS = _METRICS.counter(
    "mesh.reconcile.runs", "cross-shard actor-table reconcile passes"
)
_M_RECONCILE_SYNCED = _METRICS.counter(
    "mesh.reconcile.actors_synced",
    "actor table entries copied between shard interners by reconcile",
)
_M_REBALANCE = _METRICS.counter(
    "mesh.rebalance.moves",
    "documents migrated by the occupancy-driven rebalancer",
)
_M_W_SPAWNS = _METRICS.counter(
    "mesh.worker.spawns", "mesh worker processes started (incl. respawns)"
)
_M_W_CRASHES = _METRICS.counter(
    "mesh.worker.crashes",
    "mesh worker deaths detected (pipe EOF, exit, timeout)",
)
_M_W_RESPAWNS = _METRICS.counter(
    "mesh.worker.respawns", "crashed mesh workers brought back up"
)
_M_W_RPCS = _METRICS.counter(
    "mesh.worker.rpcs", "controller->worker round trips"
)
_M_W_REHYDRATED = _METRICS.counter(
    "mesh.worker.rehydrated_docs",
    "documents replayed into a respawned worker from the delivery log",
)
_M_W_LOST = _METRICS.counter(
    "mesh.worker.lost_docs",
    "in-flight documents quarantined because their worker crashed",
)
_M_TELEMETRY_EVENTS = _METRICS.counter(
    "mesh.telemetry.events",
    "worker flight events absorbed into the controller timeline",
)
_M_TELEMETRY_RECOVERED = _METRICS.counter(
    "mesh.telemetry.blackbox.recovered",
    "dead-worker black-box files recovered into crash dumps",
)
_M_SHM_SEGMENTS = _METRICS.gauge(
    "mesh.shm.segments",
    "live shared-memory ring segments owned by this controller",
)
_M_SHM_REMAPS = _METRICS.counter(
    "mesh.shm.remaps",
    "worker respawns that reclaimed + re-attached existing shm rings",
)
_FLIGHT = get_flight()
_OBSERVATORY = get_observatory()


#: monotonic suffix for black-box paths (parallel meshes in one process)
_BB_SEQ = 0


def _absorb_worker_events(events) -> None:
    """The controller end of the flight telemetry channel: shipped worker
    event tails merge into the controller's unified timeline with fresh
    controller seqs (origin keys preserved). Injected into every
    ``WorkerHandle`` as ``on_flight``."""
    _M_TELEMETRY_EVENTS.inc(len(events))
    _FLIGHT.absorb(events)

# per-shard instrument families, registered lazily on first touch (the
# farm.quarantine.causes.<kind> idiom): full-literal-prefix names so the
# README catalog's <s> placeholder rows match them
_SHARD_DISPATCH_MS: dict[int, object] = {}
_SHARD_DOCS: dict[int, object] = {}


def _shard_dispatch_ms(s: int):
    h = _SHARD_DISPATCH_MS.get(s)
    if h is None:
        h = _METRICS.histogram(
            f"mesh.shard.{s}.dispatch_ms",
            f"wall time of shard {s}'s apply_changes sub-dispatches",
        )
        _SHARD_DISPATCH_MS[s] = h
    return h


def _shard_docs(s: int):
    c = _SHARD_DOCS.get(s)
    if c is None:
        c = _METRICS.counter(
            f"mesh.shard.{s}.docs",
            f"active documents dispatched to shard {s}",
        )
        _SHARD_DOCS[s] = c
    return c


# the mesh pickle tax, measured: every frame the controller moves over a
# shard's pipe records its pickled size and serialize/deserialize wall
# time under mesh.pipe.<s>.* — the family the shared-memory transport is
# judged against
_PIPE_INSTRUMENTS: dict[int, tuple] = {}


def _pipe_instruments(s: int) -> tuple:
    m = _PIPE_INSTRUMENTS.get(s)
    if m is None:
        m = (
            _METRICS.counter(
                f"mesh.pipe.{s}.bytes_out",
                f"pickled bytes sent to shard {s}'s worker",
            ),
            _METRICS.counter(
                f"mesh.pipe.{s}.bytes_in",
                f"pickled bytes received from shard {s}'s worker",
            ),
            _METRICS.counter(
                f"mesh.pipe.{s}.frames_out",
                f"frames sent to shard {s}'s worker",
            ),
            _METRICS.counter(
                f"mesh.pipe.{s}.frames_in",
                f"frames received from shard {s}'s worker",
            ),
            _METRICS.histogram(
                f"mesh.pipe.{s}.serialize_ms",
                f"controller-side pickle time per frame to shard {s}",
            ),
            _METRICS.histogram(
                f"mesh.pipe.{s}.deserialize_ms",
                f"controller-side unpickle time per frame from shard {s}",
            ),
            _METRICS.histogram(
                f"mesh.pipe.{s}.payload_ms",
                f"pickle/unpickle time per COLUMN-PAYLOAD frame on shard "
                f"{s}'s pipe (inline batches + inline patch blobs)",
            ),
            _METRICS.histogram(
                f"mesh.pipe.{s}.control_ms",
                f"pickle/unpickle time per CONTROL frame on shard {s}'s "
                f"pipe (ops, SlotRefs, acks, telemetry)",
            ),
            _METRICS.counter(
                f"mesh.pipe.{s}.payload_bytes",
                f"pipe bytes in COLUMN-PAYLOAD frames for shard {s}, both "
                f"directions (zero when the shm rings carry the columns)",
            ),
            _METRICS.counter(
                f"mesh.pipe.{s}.control_bytes",
                f"pipe bytes in CONTROL frames for shard {s}, both "
                f"directions (ops, SlotRefs, acks, telemetry deltas)",
            ),
        )
        _PIPE_INSTRUMENTS[s] = m
    return m


def _pipe_recorder(s: int):
    """The ``on_pipe`` callback for shard ``s``'s WorkerHandle: cheap
    no-op while metrics are disabled, full accounting otherwise. The
    ``kind`` leg splits column-payload frames from control frames so
    ``serialize_ms``'s aggregate has an attributable breakdown — under
    the shm transport the payload histograms go silent and the whole
    pickle tax is visibly control-frame noise."""

    def on_pipe(direction: str, nbytes: int, pickle_s: float,
                kind: str = "payload") -> None:
        if not _METRICS.enabled:
            return
        (b_out, b_in, f_out, f_in, ser_ms, deser_ms,
         payload_ms, control_ms,
         payload_bytes, control_bytes) = _pipe_instruments(s)
        if direction == "out":
            b_out.inc(nbytes)
            f_out.inc()
            ser_ms.observe(pickle_s * 1000.0)
        else:
            b_in.inc(nbytes)
            f_in.inc()
            deser_ms.observe(pickle_s * 1000.0)
        if kind == "payload":
            payload_ms.observe(pickle_s * 1000.0)
            payload_bytes.inc(nbytes)
        else:
            control_ms.observe(pickle_s * 1000.0)
            control_bytes.inc(nbytes)

    return on_pipe


# the shm transport's accounting twin: bytes that moved through the
# rings instead of the pipe, ring occupancy, and the stall/fallback
# count the backpressure design trades deadlocks for
_SHM_INSTRUMENTS: dict[int, tuple] = {}


def _shm_instruments(s: int) -> tuple:
    m = _SHM_INSTRUMENTS.get(s)
    if m is None:
        m = (
            _METRICS.counter(
                f"mesh.shm.{s}.bytes_out",
                f"column-batch bytes written to shard {s}'s send ring",
            ),
            _METRICS.counter(
                f"mesh.shm.{s}.bytes_in",
                f"result-frame bytes read from shard {s}'s result ring",
            ),
            _METRICS.gauge(
                f"mesh.shm.{s}.slots_in_use",
                f"shard {s} result-ring slots held (worker-side writes + "
                f"controller-side lazy patches)",
            ),
            _METRICS.counter(
                f"mesh.shm.{s}.stalls",
                f"shard {s} shm stalls: ring-full waits, oversize batches "
                f"and responses degraded to the inline pickle path",
            ),
        )
        _SHM_INSTRUMENTS[s] = m
    return m


def _route(num_docs: int, num_shards: int) -> np.ndarray:
    """Stable doc-id -> shard map: splitmix64 of the global index mod the
    shard count. Pure and stateless — rebalancing overrides individual
    entries at runtime, but the BASE placement needs no persisted table."""
    x = np.arange(num_docs, dtype=np.uint64)
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(num_shards)).astype(np.int64)


class _InlineShard:
    """The in-process twin of ``workers.WorkerHandle``: same per-shard
    facade over a directly owned ``TorchDocFarm``, so every controller
    path above the apply fan-out is backend-agnostic."""

    __slots__ = ("farm",)

    def __init__(self, farm: TorchDocFarm):
        self.farm = farm

    def get_patch(self, loc):
        return self.farm.get_patch(loc)

    def get_heads(self, loc):
        return self.farm.get_heads(loc)

    def get_all_changes(self, loc):
        return self.farm.get_all_changes(loc)

    def get_changes(self, loc, have_deps):
        return self.farm.get_changes(loc, have_deps)

    def get_change_by_hash(self, loc, hash_):
        return self.farm.get_change_by_hash(loc, hash_)

    def get_missing_deps(self, loc, heads=()):
        return self.farm.get_missing_deps(loc, heads)

    def release_quarantine(self, loc=None):
        return self.farm.release_quarantine(loc)

    def quarantine_map(self):
        return dict(self.farm.quarantine)

    def force_quarantine(self, loc, exc):
        self.farm.quarantine[loc] = exc

    def actor_table(self):
        return list(self.farm.actors.table)

    def intern_actors(self, actors):
        missing = [a for a in actors if self.farm.actors.find(a) is None]
        for a in missing:
            self.farm.actors.intern(a)
        return len(missing)

    def export_doc(self, loc):
        return self.farm.export_doc(loc)

    def adopt_doc(self, loc, export):
        self.farm.adopt_doc(loc, export)

    def evict_doc(self, loc):
        self.farm.evict_doc(loc)

    def pages_allocated(self):
        return int(self.farm.engine.pages.allocated)

    def doc_lengths(self):
        return self.farm.engine.lengths.tolist()

    def ping(self, timeout=None):
        return True

    def close(self):
        pass


def _raise_first_shard_error(errors: dict):
    """Re-raises the FIRST failing shard's exception (lowest shard id)
    with the shard attached: ``exc.shard`` plus a ``[shard N]`` message
    prefix. Callers collect errors from EVERY dispatched shard first, so
    a mid-dispatch failure never abandons other shards' results (pinned
    by tests/test_torch_mesh_workers.py)."""
    s = min(errors)
    exc = errors[s]
    exc.shard = s
    if exc.args and isinstance(exc.args[0], str):
        exc.args = (f"[shard {s}] {exc.args[0]}",) + exc.args[1:]
    else:
        exc.args = (f"[shard {s}]",) + tuple(exc.args)
    raise exc


#: placeholder for a patch that still lives inside a shard's pickled frame
_PENDING = object()


class _LazyPatches:
    """One shard's double-pickled patch column: unpickles on first index."""

    __slots__ = ("_blob", "_patches")

    def __init__(self, blob: bytes):
        self._blob = blob
        self._patches = None

    def get(self) -> list:
        if self._patches is None:
            self._patches = pickle.loads(self._blob)
            self._blob = None
        return self._patches

    def __getstate__(self):  # keep result objects picklable either way
        return {"blob": self._blob, "patches": self._patches}

    def __setstate__(self, state):
        self._blob = state["blob"]
        self._patches = state["patches"]


class _ShmPatches(_LazyPatches):
    """One shard's patch column still sitting in its result-ring slot:
    the slot stays CONSUMER_HELD until someone indexes the result, then
    the blob unpickles straight out of the mapped segment (no
    controller-side copy) and the slot frees for the worker's next
    response. Dropping the result without touching it frees the slot
    too (``__del__``); a farm ``close()`` before that is also fine —
    ``release`` is a no-op on a closed ring, the patches are just gone
    with the segment."""

    __slots__ = ("_ring", "_slot", "_off", "_len")

    def __init__(self, ring, slot: int, off: int, length: int):
        super().__init__(None)
        self._ring = ring
        self._slot = int(slot)
        self._off = int(off)
        self._len = int(length)

    def get(self) -> list:
        if self._patches is None:
            view = self._ring.slot_view(self._slot)
            blob = view[self._off:self._off + self._len]
            try:
                self._patches = pickle.loads(blob)
            finally:
                del blob, view
            self._ring.release(self._slot)
            self._ring = None
        return self._patches

    def __getstate__(self):  # materialize before leaving the process
        return {"blob": None, "patches": self.get()}

    def __del__(self):
        ring = getattr(self, "_ring", None)
        if ring is not None:
            ring.release(self._slot)


class _MeshApplyResult(FarmApplyResult):
    """``FarmApplyResult`` whose patches materialize lazily out of the
    per-shard pickled frames. Indexing (and iteration, which routes
    through indexing) unpickles the owning shard's frame once and caches
    the materialized patch in place; callers that only look at
    ``outcomes`` (the serve batcher's accounting path) never pay the
    patch unpickle at all. NOTE: the underlying raw list holds
    ``_PENDING`` placeholders until touched, so serialize via
    ``list(result)``/iteration, never the raw list object."""

    def __init__(self, patches, outcomes, lazy: dict):
        super().__init__(patches, outcomes)
        self._lazy = lazy

    def _materialize(self, i: int):
        frame, loc = self._lazy.pop(i)
        patch = frame.get()[loc]
        list.__setitem__(self, i, patch)
        return patch

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        v = list.__getitem__(self, i)
        return self._materialize(i) if v is _PENDING else v

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class MeshFarm:
    """N shard-local TorchDocFarms behind one controller. See module
    docstring.

    `device` is where every shard's farm lives (the card unless the
    caller asks for the CPU); `devices`, a list of torch devices, places
    shard ``s`` on ``devices[s % len(devices)]`` instead. The controller's
    own device (``self.device``) is the first of them. There is no
    fallback: without CUDA a card mesh raises before any shard is built.

    `num_shards` defaults to the length of `devices` when it is given,
    else 1. `spare_slots` sizes each shard's migration headroom
    (empty doc slots a rebalance can adopt into). `mesh_backend` picks
    "inline" (default; env ``AM_MESH_BACKEND``) or "process" workers;
    `rebalance_interval` arms `rebalance_policy` ("page_load" or a
    callable taking the mesh) every that many applies. `warm_changes`
    (process backend) warms each worker on a throwaway farm before the
    readiness barrier lifts.

    `mesh_transport` picks the process backend's data plane: "shm"
    (shared-memory column rings, pipe carries control frames only),
    "pickle" (batches ride the pipe frames — the parity oracle), or
    None/"auto" (env ``AM_MESH_TRANSPORT``, else shm when the host
    supports it). Explicitly requesting "shm" on a host without POSIX
    shared memory degrades to "pickle" rather than failing — the
    transports are byte-for-byte interchangeable. Inline backends have
    no transport; the resolved value is always "pickle" there.

    `store_dir` turns on the crash-consistent persistence tier
    (``store/``): each shard owns ``<store_dir>/shard-NNN`` —
    workers (or inline shards) recover + hydrate from it on open, commit
    every delivery through its WAL before acking, and a
    ``_recover_worker`` respawn re-hydrates from disk instead of relying
    only on the controller's in-memory delivery log. Store directories
    deliberately survive ``close()`` — they ARE the durability story.
    Controller-side mirrors (no-op patch clocks for never-touched docs)
    reflect only deliveries this controller observed."""

    def __init__(self, num_docs: int, num_shards: int | None = None,
                 capacity: int = 1024, quarantine_threshold: int | None = 3,
                 page_size: int | None = None, device="cuda", devices=None,
                 reconcile_interval: int | None = 64,
                 spare_slots: int | None = None,
                 mesh_backend: str | None = None,
                 mesh_transport: str | None = None,
                 rebalance_policy="page_load",
                 rebalance_interval: int | None = None,
                 worker_timeout: float | None = None,
                 warm_changes=None, store_dir: str | None = None):
        if mesh_backend is None:
            mesh_backend = os.environ.get("AM_MESH_BACKEND", "inline")
        if mesh_backend not in ("inline", "process"):
            # amlint: disable=AM401 — API-usage validation, not a
            # data-plane fault (nothing was decoded or dispatched)
            raise ValueError(
                f"mesh_backend must be 'inline' or 'process', "
                f"got {mesh_backend!r}"
            )
        if mesh_transport is None:
            mesh_transport = os.environ.get("AM_MESH_TRANSPORT", "auto")
        if mesh_transport not in ("auto", "pickle", "shm"):
            # amlint: disable=AM401 — API-usage validation, not a
            # data-plane fault (nothing was decoded or dispatched)
            raise ValueError(
                f"mesh_transport must be 'auto', 'pickle' or 'shm', "
                f"got {mesh_transport!r}"
            )
        if mesh_backend != "process":
            mesh_transport = "pickle"  # no pipe to take off the data path
        elif mesh_transport != "pickle":
            # auto resolves to shm; an explicit shm ask degrades to the
            # pickle oracle when the host has no working POSIX shm
            mesh_transport = "shm" if _shm.shm_available() else "pickle"
        if store_dir is not None and rebalance_interval:
            # amlint: disable=AM401 — API-usage validation, not a
            # data-plane fault (nothing was decoded or dispatched)
            raise ValueError(
                "store_dir with automatic rebalancing is unsupported: the "
                "per-shard WAL is keyed by worker-local slots, which "
                "migration re-assigns"
            )
        self._devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        if any(d.type == "cuda" for d in self._devices) and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "MeshFarm runs on the card by default and CUDA is not "
                "available here; pass device='cpu' to run on the CPU"
            )
        #: the controller's device: a SyncFarm over the mesh builds there
        self.device = self._devices[0]
        if num_shards is None:
            num_shards = len(devices) if devices else 1
        if num_shards < 1 or num_docs < num_shards:
            # amlint: disable=AM401 — API-usage validation, not a
            # data-plane fault (nothing was decoded or dispatched)
            raise ValueError(
                f"need 1 <= num_shards <= num_docs, got "
                f"num_shards={num_shards} num_docs={num_docs}"
            )
        self.num_docs = num_docs
        self.num_shards = num_shards
        self.backend = mesh_backend
        self.transport = mesh_transport
        self.reconcile_interval = reconcile_interval
        self.rebalance_policy = rebalance_policy
        self.rebalance_interval = rebalance_interval
        self._shard_of = _route(num_docs, num_shards)
        self._local_of = np.zeros(num_docs, np.int64)
        if spare_slots is None:
            spare_slots = max(2, (num_docs // num_shards) // 8)
        self._owners: list[list] = []
        self._free: list[list] = []
        self._slots: list[int] = []
        self.shards: list[TorchDocFarm] = []
        self._handles: list = []
        specs = []
        for s in range(num_shards):
            mine = np.nonzero(self._shard_of == s)[0]
            self._local_of[mine] = np.arange(len(mine), dtype=np.int64)
            self._owners.append(mine.tolist() + [None] * spare_slots)
            self._free.append(
                list(range(len(mine) + spare_slots - 1, len(mine) - 1, -1))
            )
            self._slots.append(len(mine) + spare_slots)
            specs.append(dict(
                shard=s, num_docs=len(mine) + spare_slots,
                capacity=capacity, quarantine_threshold=quarantine_threshold,
                page_size=page_size, device=str(self._shard_device(s)),
                epoch=0,
                blackbox_path=self._blackbox_path(s),
                warm_buffers=tuple(warm_changes) if warm_changes else None,
                store_dir=self._shard_store_dir(store_dir, s),
            ))
        # shm transport: the controller owns one send ring + one result
        # ring per shard; workers attach by name (spec["shm"]) at spawn
        # and RE-attach to the same segments on respawn
        self._rings: list[tuple] = []
        if mesh_backend == "process" and mesh_transport == "shm":
            for spec in specs:
                s = spec["shard"]
                send = _shm.create_ring(f"s{s}-tx")
                result = _shm.create_ring(f"s{s}-rx")
                self._rings.append((send, result))
                spec["shm"] = {"send": send.name, "result": result.name}
            _M_SHM_SEGMENTS.set(2 * num_shards)
        if mesh_backend == "process":
            # start every worker before awaiting any readiness message,
            # so farm construction + warm-up overlap across workers
            self._handles = [
                WorkerHandle(
                    spec, timeout=worker_timeout, defer_ready=True,
                    on_delta=_METRICS.merge_frame, on_rpc=_M_W_RPCS.inc,
                    on_flight=_absorb_worker_events,
                    on_pipe=_pipe_recorder(spec["shard"]),
                )
                for spec in specs
            ]
            ready = [h.ensure_ready() for h in self._handles]
            _M_W_SPAWNS.inc(num_shards)
            if _FLIGHT.enabled:
                for s, pid in enumerate(ready):
                    _FLIGHT.record("mesh.worker.spawn", shard=s, pid=pid)
        else:
            for s, slots in enumerate(self._slots):
                farm = TorchDocFarm(
                    slots, capacity=capacity,
                    quarantine_threshold=quarantine_threshold,
                    page_size=page_size, device=self._shard_device(s),
                )
                if specs[s]["store_dir"] is not None:
                    from ..store import ShardStore, hydrate_farm

                    shard_store = ShardStore(specs[s]["store_dir"])
                    hydrate_farm(farm, shard_store)
                    farm.attach_store(shard_store)
                self.shards.append(farm)
            self._handles = [_InlineShard(f) for f in self.shards]
        # process-backend controller mirrors (see module docstring):
        # quarantine cache, per-doc no-op-patch state, committed-delivery
        # log for crash re-hydration
        self._qcache: dict[int, BaseException] = {}
        self._noop_state: list = [(0, {}, [], 0) for _ in range(num_docs)]
        self._doc_log: dict[int, list] = {}
        self._calls = 0
        self._doc_dispatches = np.zeros(num_docs, np.int64)
        workers = int(os.environ.get("AM_MESH_CONCURRENCY", "1"))
        self._executor = (
            ThreadPoolExecutor(max_workers=min(workers, num_shards))
            if workers > 1 and num_shards > 1 and mesh_backend == "inline"
            else None
        )
        _M_SHARDS.set(num_shards)

    # ------------------------------------------------------------------ #
    # routing

    @staticmethod
    def _shard_store_dir(root: str | None, s: int) -> str | None:
        """Shard ``s``'s store directory under the mesh ``store_dir`` (None
        when persistence is off). Deterministic — a new controller over the
        same root re-adopts every shard's history."""
        return None if root is None else os.path.join(root, f"shard-{s:03d}")

    @staticmethod
    def _blackbox_path(s: int) -> str:
        """Where shard ``s``'s worker persists its black box: the flight
        dump dir when one is configured (crash forensics land next to the
        crash dumps), the system temp dir otherwise. Unique per
        controller pid + spec so parallel meshes never collide; stable
        across respawns so recovery always knows where to look."""
        global _BB_SEQ
        _BB_SEQ += 1
        base = _FLIGHT.dump_dir or tempfile.gettempdir()
        return os.path.join(
            base, f"am-blackbox-{os.getpid()}-{_BB_SEQ:04d}-s{s}.json"
        )

    def _shard_device(self, s: int) -> torch.device:
        """Where shard `s`'s farm lives: the device list, round-robin."""
        return self._devices[s % len(self._devices)]

    def shard_of(self, d: int) -> int:
        """Current owning shard of global doc `d` (base routing overridden
        by migrations). The serve batcher uses this for its per-shard
        flush accounting."""
        return int(self._shard_of[d])

    def _local(self, d: int):
        s = self._shard_of[d]
        return self._handles[s], self._local_of[d]

    # ------------------------------------------------------------------ #
    # lifecycle (process backend; inline no-ops)

    def close(self) -> None:
        """Shuts every worker down cleanly (ack'd shutdown, join,
        terminate stragglers), removes the workers' black-box files and
        releases the dispatch pool. Idempotent; leaves zero child
        processes behind."""
        for h in self._handles:
            h.close()
            if isinstance(h, _InlineShard):
                # final durability barrier; the store DIRECTORY persists
                if h.farm.store is not None:
                    h.farm.store.close()
                continue
            path = getattr(h, "spec", {}).get("blackbox_path")
            if path:
                with contextlib.suppress(OSError):
                    os.remove(path)
        if self._rings:
            # workers are down; unlink every segment so /dev/shm is clean
            # (pinned by tests/test_torch_mesh_workers.py)
            for rings in self._rings:
                for ring in rings:
                    ring.close()
            self._rings = []
            _M_SHM_SEGMENTS.set(0)
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()

    def heartbeat(self):
        """Pings every shard; a dead worker is detected here even between
        deliveries, respawned and re-hydrated (in-flight docs: none —
        nothing was in flight). Returns {shard: "ok" | "respawned"}."""
        status = {}
        for s, h in enumerate(self._handles):
            try:
                h.ping()
                status[s] = "ok"
            except WorkerCrashError as exc:
                self._recover_worker(s, in_flight=(), cause=exc,
                                     phase="heartbeat")
                status[s] = "respawned"
        return status

    def inject_worker_fault(self, shard: int, when: str = "next_apply"):
        """Test/chaos hook (process backend only): make `shard`'s worker
        SIGKILL itself — immediately (`when="now"`, fire-and-forget) or
        at its next apply (`"next_apply"`, i.e. mid-delivery from the
        controller's point of view)."""
        if self.backend != "process":
            # amlint: disable=AM401 — API-usage validation, not a
            # data-plane fault (nothing was decoded or dispatched)
            raise ValueError("worker fault injection needs the process "
                             "backend")
        h = self._handles[shard]
        if when == "now":
            h.request("_debug_die_now")
        else:
            h.call("_debug_die_on_next_apply")

    # ------------------------------------------------------------------ #
    # the fan-out data plane

    def apply_changes(self, per_doc_buffers, is_local: bool = False,
                      isolation: str = "doc"):
        """Routes one global delivery into per-shard sub-deliveries,
        dispatches each shard's farm, and merges the per-shard results
        into one global-index FarmApplyResult. Shards with no active docs
        are not dispatched; their docs report the same no-op patch an
        empty delivery produces."""
        if isolation != "doc":
            # amlint: disable=AM401 — API-usage validation: batch-wide
            # rollback cannot span shard-local fault domains
            raise ValueError(
                "MeshFarm supports isolation='doc' only (shards are "
                "independent fault domains)"
            )
        assert len(per_doc_buffers) == self.num_docs
        self._calls += 1
        _M_APPLY.inc()
        shard_of, local_of = self._shard_of, self._local_of
        active = [d for d, bufs in enumerate(per_doc_buffers) if bufs]
        np.add.at(self._doc_dispatches, active, 1)
        # plain ints: shard ids flow into flight-event fields and JSON
        # dumps, where a stray np.int64 would stringify
        touched = sorted({int(shard_of[d]) for d in active})
        counts = {
            s: sum(1 for d in active if shard_of[d] == s) for s in touched
        }
        if self.backend == "process":
            result = self._apply_process(
                per_doc_buffers, active, touched, counts, is_local
            )
        else:
            result = self._apply_inline(
                per_doc_buffers, active, touched, counts, is_local
            )
        if self.reconcile_interval and (
            self._calls % self.reconcile_interval == 0
        ):
            self.reconcile_actors()
        if self.rebalance_interval and (
            self._calls % self.rebalance_interval == 0
        ):
            if callable(self.rebalance_policy):
                self.rebalance_policy(self)
            elif self.rebalance_policy == "page_load":
                self.rebalance()
        return result

    def _apply_inline(self, per_doc_buffers, active, touched, counts,
                      is_local):
        shard_of, local_of = self._shard_of, self._local_of
        subs = [
            [[] for _ in range(f.num_docs)] for f in self.shards
        ]
        for d in active:
            subs[shard_of[d]][local_of[d]] = list(per_doc_buffers[d])

        def run_shard(s):
            t0 = time.perf_counter()
            result = self.shards[s].apply_changes(
                subs[s], is_local=is_local, isolation="doc"
            )
            if _METRICS.enabled:
                _shard_dispatch_ms(s).observe(
                    (time.perf_counter() - t0) * 1000.0,
                    exemplar=current_exemplar(),
                )
                _shard_docs(s).inc(counts[s])
            return result

        results = self._dispatch_shards(touched, run_shard)
        patches = [
            results[shard_of[g]][local_of[g]]
            if shard_of[g] in results
            else self.shards[shard_of[g]]._noop_patch(local_of[g])
            for g in range(self.num_docs)
        ]
        outcomes = [
            results[shard_of[g]].outcomes[local_of[g]]
            if shard_of[g] in results
            else _APPLIED
            for g in range(self.num_docs)
        ]
        return FarmApplyResult(patches, outcomes)

    def _apply_process(self, per_doc_buffers, active, touched, counts,
                       is_local):
        """Send-all-then-collect fan-out: every touched worker receives
        its pickled column batch before any result is awaited, so the
        per-shard host phases genuinely overlap across processes. The
        collect loop ALWAYS drains every touched shard — raising early
        would leave a queued response in a pipe and desynchronize the
        whole protocol — then crashes recover, then the first
        non-crash shard error (lowest shard id) re-raises with its shard
        attached, exactly like the inline dispatch path."""
        shard_of, local_of = self._shard_of, self._local_of
        want_phases = bool(get_profile().enabled)
        # the obs leg: the flight-enable bit mirrors this controller's
        # recorder into the worker, and the ambient DispatchSpan id rides
        # along so worker-side farm.dispatch/readback observations stamp
        # the controller's trace ids. None when observability is off — the
        # disabled path ships nothing extra.
        obs = None
        if _FLIGHT.enabled or _METRICS.enabled or _OBSERVATORY.enabled:
            obs = {"flight": _FLIGHT.enabled, "prof": _OBSERVATORY.enabled,
                   "exemplar": current_exemplar()}
        groups = {s: [] for s in touched}
        for d in active:
            groups[shard_of[d]].append(
                (int(local_of[d]), tuple(per_doc_buffers[d]))
            )
        sent = []
        crashed = {}
        for s in touched:
            batch = (
                self._tx_columns(s, groups[s]) if self._rings else groups[s]
            )
            try:
                self._handles[s].request(
                    "apply", (batch, is_local, want_phases, obs)
                )
                sent.append(s)
            except WorkerCrashError as exc:
                crashed[s] = exc
        responses = {}
        errors = {}
        for s in sent:
            try:
                responses[s] = self._handles[s].collect()
            except WorkerCrashError as exc:
                crashed[s] = exc
            except BaseException as exc:
                errors[s] = exc
        prof = get_profile()
        for s, resp in sorted(responses.items()):
            if _METRICS.enabled:
                _shard_dispatch_ms(s).observe(
                    resp["wall_s"] * 1000.0, exemplar=current_exemplar()
                )
                _shard_docs(s).inc(counts[s])
            if resp["phases"] and prof.enabled:
                prof.absorb_jsonl(resp["phases"])
            owners = self._owners[s]
            for loc, state in resp["noop"].items():
                self._noop_state[owners[loc]] = state
            for loc, blob in resp["q_entered"].items():
                self._qcache[owners[loc]] = exc_from_blob(blob)
        crash_outcomes = {}
        for s, cause in sorted(crashed.items()):
            in_flight = [d for d in active if shard_of[d] == s]
            crash_outcomes.update(
                self._recover_worker(s, in_flight, cause, phase="apply")
            )
        if errors:
            _raise_first_shard_error(errors)
        frames = {}
        outcome_cols = {}
        for s, resp in responses.items():
            frames[s], wires = self._rx_result(s, resp)
            outcome_cols[s] = [outcome_from_wire(w) for w in wires]
        outcomes = [
            outcome_cols[shard_of[g]][local_of[g]]
            if shard_of[g] in outcome_cols
            else crash_outcomes.get(g, _APPLIED)
            for g in range(self.num_docs)
        ]
        lazy = {
            g: (frames[s], loc)
            for s in frames
            for loc, g in enumerate(self._owners[s])
            if g is not None
        }
        patches = [
            _PENDING if g in lazy else self._noop_patch_mirror(g)
            for g in range(self.num_docs)
        ]
        committed = [
            d for d in active
            if outcomes[d].status == "applied"
        ]
        for d in committed:
            self._doc_log.setdefault(d, []).append(
                (tuple(per_doc_buffers[d]), is_local)
            )
        return _MeshApplyResult(patches, outcomes, lazy)

    # -- the shm transport's two legs ---------------------------------- #

    def _shm_stall(self, s: int, reason: str, nbytes: int) -> None:
        """One shm degradation tick: ring-full wait, oversize batch, or a
        worker response that fell back inline. Counted per shard and
        flight-recorded so a transport that quietly stopped being
        zero-copy shows up in the timeline."""
        if _METRICS.enabled:
            _shm_instruments(s)[3].inc()
        if _FLIGHT.enabled:
            # plain ints only: these fields land in flight JSONL dumps,
            # where a stray np.int64 would stringify
            _FLIGHT.record(
                "mesh.shm.stall", shard=int(s), reason=reason,
                nbytes=int(nbytes),
            )

    def _tx_columns(self, s: int, batch: list):
        """Stages one shard's column batch in its send ring and returns
        the ``SlotRef`` control frame — or the batch itself when the
        ring cannot take it (oversize payload, or full past the acquire
        timeout), in which case this one delivery rides the pickle
        oracle path. Degrade, never deadlock."""
        send_ring, _ = self._rings[s]
        nbytes = _shm.measure_columns(batch)
        if nbytes > send_ring.slot_bytes:
            self._shm_stall(s, "oversize", nbytes)
            return batch
        waits = send_ring.stalls
        try:
            slot, gen = send_ring.acquire(timeout=1.0)
        except _shm.RingStall:
            self._shm_stall(s, "ring_full", nbytes)
            return batch
        if send_ring.stalls != waits:
            self._shm_stall(s, "waited", nbytes)
        view = send_ring.slot_view(slot)
        try:
            used = _shm.encode_columns_into(view, batch)
        finally:
            del view
        if _METRICS.enabled:
            _shm_instruments(s)[0].inc(used)
        return send_ring.publish(slot, gen, used)

    def _rx_result(self, s: int, resp: dict):
        """One apply response's bulk payload, as ``(patch frame,
        outcome wires)``: read out of the result ring when the worker
        shipped a ``SlotRef`` (the slot stays CONSUMER_HELD inside the
        returned ``_ShmPatches`` until someone materializes patches —
        that is the zero-copy hold), from the inline pickled fields
        otherwise. An inline response while the shm transport is on IS
        the worker's declared slot-exhaustion fallback — metered as a
        stall so the degradation stays visible."""
        ref = resp["patches"]
        if not isinstance(ref, _shm.SlotRef):
            if self._rings:
                self._shm_stall(s, "inline_response", len(ref))
            return _LazyPatches(ref), resp["outcomes"]
        _, result_ring = self._rings[s]
        view = result_ring.accept(ref)
        try:
            (p_off, p_len), wires = _shm.decode_result(view)
        finally:
            del view
        if _METRICS.enabled:
            m = _shm_instruments(s)
            m[1].inc(ref.nbytes)
            m[2].set(result_ring.slots_in_use())
        return _ShmPatches(result_ring, ref.slot, p_off, p_len), wires

    def _noop_patch_mirror(self, g: int) -> dict:
        """The patch of a delivery that changed nothing, built from the
        controller's no-op mirror — byte-identical to the owning farm's
        ``_noop_patch`` without a round trip."""
        max_op, clock, heads, pending = self._noop_state[g]
        return {
            "maxOp": max_op,
            "clock": dict(clock),
            "deps": list(heads),
            "pendingChanges": pending,
            "diffs": _empty_object_patch("_root", "map"),
        }

    def _recover_worker(self, s: int, in_flight, cause, phase: str):
        """Crash recovery: recover the dead worker's black box into the
        flight timeline and trigger the ``mesh.worker.crash`` dump, then
        respawn shard `s`'s worker, re-hydrate its committed state, and
        re-impose surviving quarantines; docs whose delivery was in
        flight when the worker died are quarantined (taxonomy:
        ``WorkerCrashError``, kind "worker_crash"). Returns {global doc:
        DocOutcome} for the in-flight docs.

        Re-hydration is two-source: with a mesh ``store_dir``, the
        respawned worker first recovers every fsynced commit from its
        shard store during spawn (``_worker_main``); the controller's
        per-doc delivery-log replay then lands on top — hash-graph dedup
        makes the overlap a no-op while repairing any group-commit
        durability window the crash cut off. Without a store, the replay
        is the only source, exactly as before."""
        h = self._handles[s]
        old_pid = h.pid
        heartbeat_age = h.heartbeat_age()
        _M_W_CRASHES.inc()
        if _FLIGHT.enabled:
            # black-box forensics BEFORE respawn (the fresh incarnation
            # will start rewriting the same path): absorb the dead
            # worker's final shard-tagged events, deduped against what it
            # already shipped live, then dump the merged timeline
            bb_path = h.spec.get("blackbox_path")
            blackbox = read_blackbox(bb_path) if bb_path else None
            recovered = 0
            if blackbox:
                recovered = _FLIGHT.absorb(
                    blackbox.get("events", ()), dedup=True
                )
                _M_TELEMETRY_RECOVERED.inc()
            _FLIGHT.record(
                "mesh.worker.crash", shard=s, pid=old_pid, phase=phase,
                cause=str(cause),
                heartbeat_age_s=(
                    None if heartbeat_age is None
                    else round(heartbeat_age, 3)
                ),
                blackbox=bb_path if blackbox else None,
                blackbox_events=recovered,
            )
            _FLIGHT.trigger("mesh.worker.crash", shard=s)
        freed_slots = 0
        if self._rings:
            # reclaim the ring slots the dead worker may have held: the
            # send ring entirely (this shard's delivery already failed —
            # nothing of ours is outstanding in it), the result ring's
            # PRODUCER_HELD slots only — CONSUMER_HELD ones back live
            # ``_ShmPatches`` from earlier responses and stay valid
            # across the respawn; the bumped generation counters keep
            # any stale pre-crash SlotRef from aliasing a reused slot
            send_ring, result_ring = self._rings[s]
            freed_slots = send_ring.reclaim() + result_ring.reclaim(
                held_by_producer_only=True
            )
        new_pid = h.respawn()
        _M_W_SPAWNS.inc()
        _M_W_RESPAWNS.inc()
        if self._rings:
            # the respawned worker re-attached the same segments by name
            _M_SHM_REMAPS.inc()
            if _FLIGHT.enabled:
                # plain ints only (JSONL dump fields)
                _FLIGHT.record(
                    "mesh.shm.remap", shard=int(s),
                    epoch=int(h.spec.get("epoch", 0)),
                    freed_slots=int(freed_slots),
                )
        owned = [g for g in self._owners[s] if g is not None]
        in_flight = set(in_flight)
        replay_items = [
            (int(self._local_of[g]), self._doc_log.get(g, []))
            for g in owned
        ]
        rehydrated = h.replay(replay_items)
        _M_W_REHYDRATED.inc(rehydrated)
        survivors_quarantined = [
            g for g in owned if g in self._qcache and g not in in_flight
        ]
        for g in survivors_quarantined:
            h.force_quarantine(int(self._local_of[g]), self._qcache[g])
        outcomes = {}
        for g in sorted(in_flight):
            err = WorkerCrashError(
                f"worker for shard {s} (pid {old_pid}) died mid-delivery; "
                f"doc {g}'s delivery was in flight and is quarantined "
                f"pending release ({cause})"
            )
            self._qcache[g] = err
            h.force_quarantine(int(self._local_of[g]), err)
            _M_W_LOST.inc()
            outcomes[g] = DocOutcome("quarantined", err, error_kind(err))
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "mesh.worker.respawn", shard=s, pid=new_pid,
                rehydrated=rehydrated, lost=len(in_flight),
            )
        return outcomes

    def _dispatch_shards(self, touched, fn):
        """Runs `fn(s)` for every touched shard; concurrently when the
        pool is enabled (context propagated so ambient profile/scope
        state follows each sub-dispatch), serially otherwise. Results
        come back keyed by shard id either way. Every future is drained
        before any failure surfaces — a mid-dispatch shard exception
        neither deadlocks the pool nor abandons other shards' completed
        results — and the FIRST failing shard's exception (lowest shard
        id) re-raises with the shard id attached (``exc.shard`` + a
        message prefix)."""
        results = {}
        errors = {}
        if self._executor is not None and len(touched) > 1:
            futures = {
                s: self._executor.submit(
                    contextvars.copy_context().run, fn, s
                )
                for s in touched
            }
            for s in touched:
                try:
                    results[s] = futures[s].result()
                except BaseException as exc:
                    errors[s] = exc
        else:
            for s in touched:
                try:
                    results[s] = fn(s)
                except BaseException as exc:
                    errors[s] = exc
        if errors:
            _raise_first_shard_error(errors)
        return results

    # ------------------------------------------------------------------ #
    # cross-shard actor reconcile

    def reconcile_actors(self) -> int:
        """Exchanges actor-table deltas between shards: the union of every
        shard's actor strings is interned into every shard (append-only,
        first-seen order, so the pass is deterministic). Returns the
        number of entries copied; a converged mesh returns 0."""
        union: list[str] = []
        seen: set[str] = set()
        for h in self._handles:
            for a in h.actor_table():
                if a not in seen:
                    seen.add(a)
                    union.append(a)
        synced = 0
        for h in self._handles:
            synced += h.intern_actors(union)
        _M_RECONCILE_RUNS.inc()
        _M_RECONCILE_SYNCED.inc(synced)
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "mesh.reconcile", actors=len(union), synced=synced
            )
        return synced

    # ------------------------------------------------------------------ #
    # page-granular migration + the rebalancer

    def migrate_doc(self, d: int, dest_shard: int) -> None:
        """Moves global doc `d` onto `dest_shard` by whole pages: export
        (dense page readback + host state), id translation into the
        destination farm's interners, one adopt-scatter into freshly
        allocated pages, then the source slot is evicted and freed.
        Under the process backend the page snapshot travels over the
        pipe — export and adopt run in two different worker processes."""
        src_shard = int(self._shard_of[d])
        if src_shard == dest_shard:
            return
        if not self._free[dest_shard]:
            raise PackingLimitError(
                f"shard {dest_shard} has no free doc slots for migration"
            )
        src, dst = self._handles[src_shard], self._handles[dest_shard]
        l_src = int(self._local_of[d])
        l_dst = self._free[dest_shard].pop()
        export = src.export_doc(l_src)
        dst.adopt_doc(l_dst, export)
        src.evict_doc(l_src)
        self._owners[src_shard][l_src] = None
        self._free[src_shard].append(l_src)
        self._owners[dest_shard][l_dst] = d
        self._shard_of[d] = dest_shard
        self._local_of[d] = l_dst
        _M_MIGRATED.inc()
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "mesh.migrate", doc=d, src=src_shard, dest=dest_shard,
                rows=int(export["rows"]["key"].shape[0]),
            )

    def rebalance(self, max_moves: int = 1, min_gain_pages: int = 2):
        """Migrates the hottest doc off the most page-loaded shard onto
        the least-loaded one, up to `max_moves` times, while the page-load
        spread exceeds `min_gain_pages`. Heat = the controller's per-doc
        dispatch counts, tie-broken by row count. Returns the moves as
        (doc, src_shard, dest_shard) triples. Runs automatically every
        `rebalance_interval` applies when armed (the controller policy
        hook)."""
        moves = []
        for _ in range(max_moves):
            loads = np.fromiter(
                (h.pages_allocated() for h in self._handles),
                np.int64, count=self.num_shards,
            )
            src_shard = int(np.argmax(loads))
            dest_shard = int(np.argmin(loads))
            if (
                src_shard == dest_shard
                or loads[src_shard] - loads[dest_shard] < min_gain_pages
                or not self._free[dest_shard]
            ):
                break
            candidates = [
                g for g in self._owners[src_shard] if g is not None
            ]
            if not candidates:
                break
            lengths = self._handles[src_shard].doc_lengths()
            hot = max(
                candidates,
                key=lambda g: (
                    self._doc_dispatches[g],
                    lengths[self._local_of[g]],
                ),
            )
            self.migrate_doc(hot, dest_shard)
            moves.append((hot, src_shard, dest_shard))
            _M_REBALANCE.inc()
        if moves and _FLIGHT.enabled:
            _FLIGHT.record("mesh.rebalance", moves=len(moves))
        return moves

    def audit(self) -> None:
        """Cross-shard ownership invariants: every global doc is owned by
        exactly one shard slot, routing arrays agree with the owner
        tables, and free lists cover exactly the unowned slots. Raises
        AssertionError on any leak."""
        seen: dict[int, tuple[int, int]] = {}
        for s, owners in enumerate(self._owners):
            assert len(owners) == self._slots[s]
            frees = set(self._free[s])
            for loc, g in enumerate(owners):
                if g is None:
                    assert loc in frees, (s, loc)
                    continue
                assert loc not in frees, (s, loc)
                assert g not in seen, f"doc {g} owned twice: {seen[g]}, {(s, loc)}"
                seen[g] = (s, loc)
                assert int(self._shard_of[g]) == s
                assert int(self._local_of[g]) == loc
        assert len(seen) == self.num_docs, "docs lost across shards"

    # ------------------------------------------------------------------ #
    # TorchDocFarm facade (global doc indexes) — the surface SyncFarm and
    # the serve stack consume

    @property
    def quarantine(self):
        """{global doc: last failure} across every shard. Inline reads
        the live shard sets; the process backend serves the controller's
        quarantine mirror — the serve batcher hits this on EVERY submit,
        so it must not fan out round trips."""
        if self.backend == "process":
            return dict(self._qcache)
        out = {}
        for s, h in enumerate(self._handles):
            owners = self._owners[s]
            out.update({
                owners[loc]: exc
                for loc, exc in h.quarantine_map().items()
            })
        return out

    def release_quarantine(self, doc: int | None = None):
        if doc is not None:
            h, loc = self._local(doc)
            released = [doc] if h.release_quarantine(int(loc)) else []
        else:
            released = []
            for s, h in enumerate(self._handles):
                owners = self._owners[s]
                released.extend(owners[loc] for loc in h.release_quarantine())
        for g in released:
            self._qcache.pop(g, None)
        return released

    def get_patch(self, d: int):
        h, loc = self._local(d)
        return h.get_patch(loc)

    def get_heads(self, d: int):
        h, loc = self._local(d)
        return h.get_heads(loc)

    def get_all_changes(self, d: int):
        h, loc = self._local(d)
        return h.get_all_changes(loc)

    def get_changes(self, d: int, have_deps):
        h, loc = self._local(d)
        return h.get_changes(loc, have_deps)

    def get_change_by_hash(self, d: int, hash_):
        h, loc = self._local(d)
        return h.get_change_by_hash(loc, hash_)

    def get_missing_deps(self, d: int, heads=()):
        h, loc = self._local(d)
        return h.get_missing_deps(loc, heads)

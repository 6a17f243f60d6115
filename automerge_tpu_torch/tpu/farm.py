"""Batched document farm: the backend contract over the device merge engine.

PyTorch counterpart of the JAX package's ``tpu/farm.py``, for map/counter
documents. ``TorchDocFarm`` manages N documents and speaks the reference
backend's applyChanges -> patch protocol (backend/backend.js:27,
new.js:1796) for all of them at once: binary changes in, reference-format
patches out, with the merge + visibility/conflict computation running as
batched device programs (engine.py, paging.py) per call.

Division of labour:
- **Host**: change decoding (columnar -> op dicts, memoised in a bounded
  LRU so a change gossiped to N documents is parsed once), the causal gate
  (dedup by hash, dependency check, per-actor seq contiguity — the port of
  new.js:1550-1597), op transcoding to dense rows, and patch *assembly*
  from device-computed visibility. Assembly reads a host ROW MIRROR of the
  device op table (static columns replicated with zero transfers; the
  merge-dependent visibility/total columns cached per (doc, slot) and
  refreshed from the device only for spans a commit invalidated).
- **Device**: the op-table merge (succ/overwrite resolution) and the
  visibility/winner/counter-total computation for every document in the
  batch — the work the reference does per-doc in mergeDocChangeOps
  (new.js:1052) and updatePatchProperty (new.js:884).

Patch assembly reproduces the reference's patch shape exactly: per touched
key a conflict map of every visible op {opId: valueDiff}, child objects
linked through parent props up to the root (setupPatches, new.js:1461),
counters emitted with per-target accumulated totals (new.js:937-965),
deleted keys as empty conflict maps.

Map-family keys (maps, tables, counters, nested trees) get reference-exact
patch parity via the batched device path. List/text objects additionally
run through the reference merge walk (the sequential engine in opset.py,
embedded lazily per document): the reference's incremental list edit
stream is an order-dependent state machine (listIndex increments only
after updatePatchProperty at insert boundaries, propState action
conversions, appendUpdate conflict popping — new.js:747-1033) whose output
is not a function of (old state, new state) alone, so no state diff can
reproduce it byte for byte. Documents that have never seen a list op pay
nothing for this; the first list op replays that doc's committed changes
through the walk once, and from then on its incremental patches are
byte-exact by construction. The device engine still carries every doc's
rows (list rows included: element forests feed the batched RGA rank in
rga.py) for whole-document reads, conflict winners and counter totals.

Persistence: ``attach_store`` routes every committed delivery through a
``store.ShardStore`` write-ahead log and its group-commit fsync barrier
before the call returns (acked means durable), and ``store.open_farm``
rebuilds a farm from that log in one batched delivery.

Fault isolation: under the default ``isolation="doc"`` every document is
its own fault domain — a poisoned delivery (corrupt bytes, causal
violations, packing overflows) quarantines only that doc, with its host
state rolled back to a pre-call snapshot and the failure classified by the
error taxonomy (errors.py) in the call's outcome report. Repeat offenders
enter a traffic-shedding quarantine set (release_quarantine restores
them), and a failing device dispatch degrades to the sequential reference
walk after bisecting out the poison docs (``degraded``). The bisection
probes run on the device, so they isolate a fault that a document's rows
raise in a call (the ``farm.device_dispatch`` and ``engine.apply_batch``
fault points of testing/faults.py inject one). A CUDA fault such as an
illegal address poisons the process's CUDA context instead: every later
probe fails too, so nobody is blamed and every doc of the call is served
by the walk, but the device stays unusable for the rest of the process
(and CUDA may report such a fault only at a later synchronising call,
outside the dispatch). ``isolation="batch"`` keeps the all-or-nothing contract.
"""
from __future__ import annotations

import os
import pickle
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..columnar import decode_change_cached, decode_change_meta_cached
from .decode import warm_decode_cache
from ..common import utf16_key
from ..errors import (
    CausalityError,
    DeviceFaultError,
    PackingLimitError,
    QuarantinedError,
    error_kind,
)
from ..obs.flight import get_flight
from ..obs.metrics import get_metrics
from ..obs.scope import current_exemplar
from ..opset import OpSet, append_edit
from ..testing.faults import fire as _fault_point
from .engine import (
    ACTION_DEL,
    ACTION_INC,
    ACTION_SET,
    ACTOR_BITS,
    ACTOR_MASK,
    BatchedMapEngine,
    PAD_KEY,
    _MKEY_OP_BITS,
    _to_host,
    changes_from_numpy,
)
from . import rga
from .transcode import (
    DEP_COMMITTED,
    DEP_UNKNOWN,
    _Interner,
    _MAX_COUNTER,
    _MAX_SLOTS,
    actor_rank_table,
    gate_verdicts,
    lamport_keys,
    ragged_spans,
)


class ValueCell(NamedTuple):
    """Interned scalar payload of a set op: raw value + optional datatype."""

    value: object
    datatype: object


class ChildObj(NamedTuple):
    """Interned value marking 'this key holds the object with this id'."""

    object_id: str


_ROOT_META = {"parentObj": None, "parentKey": None, "type": "map"}


def replay_walk(changes, queue) -> OpSet:
    """A document's reference walk rebuilt from its committed change log
    (buffers) and its queued decoded changes, re-delivered one by one."""
    opset = OpSet()
    if changes:
        opset.apply_changes(list(changes))
    # amlint: disable=AM107 — cold path: one-time OpSet rebuild when a doc
    # first needs the reference walk
    for change in queue:
        opset.apply_changes([change["buffer"]])
    return opset


# change hash -> (targets a list/text object, list inserts): the hash is
# sha256 over the change bytes, so every farm may share an entry, and a
# change gossiped to many documents and farms is scanned once
_LIST_PROFILES: dict[str, tuple[bool, int]] = {}
_LIST_PROFILES_MAX = 1 << 16


def _list_profile(change) -> tuple[bool, int]:
    """Whether a decoded change has a list/text op, and how many list
    inserts it makes (the walk's routing test and the element-capacity
    check of `_prevalidate_limits` both read this)."""
    h = change["hash"]
    out = _LIST_PROFILES.get(h)
    if out is None:
        touches, inserts = False, 0
        # amlint: disable=AM107 — the packing-limit prevalidation walk, op
        # level: it guards the quarantine boundary, not a throughput
        # phase, and runs once per change hash (cached above)
        for op in change["ops"]:
            if op.get("insert"):
                touches, inserts = True, inserts + 1
            elif op.get("elemId") is not None:
                touches = True
        out = (touches, inserts)
        if len(_LIST_PROFILES) >= _LIST_PROFILES_MAX:
            _LIST_PROFILES.clear()
        _LIST_PROFILES[h] = out
    return out


def _remap_packed(col, amap):
    """Rewrites the actor field of a packed-opid column through `amap`
    (source actor id -> destination actor id); -1 sentinels pass through.
    The counter field is actor-independent and survives unchanged."""
    out = np.asarray(col, np.int64).copy()
    live = out >= 0
    ops = out[live]
    out[live] = (ops & ~np.int64(ACTOR_MASK)) | amap[ops & np.int64(ACTOR_MASK)]
    return out


def _remap_packed_one(packed: int, amap) -> int:
    return int((packed & ~ACTOR_MASK) | int(amap[packed & ACTOR_MASK]))

# farm metrics (process-wide registry, disabled unless a workload opts in —
# obs/metrics.py). All recording is host-side, outside the device phases.
_METRICS = get_metrics()
_M_ROWS = _METRICS.counter(
    "farm.rows.transcoded", "dense op rows produced by gate+transcode"
)
_M_PAD_ROWS = _METRICS.counter(
    "farm.rows.padding", "wasted (padded) cells in packed device batches"
)
_M_PAD_RATIO = _METRICS.gauge(
    "farm.pad_waste_ratio", "padding fraction of the last packed batch"
)
_M_OCCUPANCY = _METRICS.histogram(
    "farm.batch.occupancy", "rows / cells fill ratio per packed batch"
)
_M_WALKS = _METRICS.counter(
    "farm.exact.walks", "documents served by the embedded reference walk"
)
_M_WALK_OPS = _METRICS.counter(
    "farm.walk.ops", "ops of the changes handed to the embedded reference walk"
)
_M_RANKED = _METRICS.counter(
    "farm.rga.elems_ranked", "list elements put in order by the RGA rank"
)
_M_FB_CALLS = _METRICS.counter(
    "farm.fallback.calls",
    "apply_changes calls that lost the batched device path mid-dispatch",
)
_M_FB_DOCS = _METRICS.counter(
    "farm.fallback.docs",
    "documents served by the sequential reference walk after a device failure",
)
_M_BISECT = _METRICS.counter(
    "farm.bisect.rounds",
    "bisection probes run to isolate device-poison documents",
)
_M_ABORTS = _METRICS.counter(
    "farm.prevalidation.aborts",
    "apply_changes calls rejected batch-wide by the packing-limit pre-pass",
)
_M_APPLIED = _METRICS.counter(
    "farm.changes.applied", "changes committed by the causal gate"
)
_M_DEFERRALS = _METRICS.counter(
    "farm.gate.deferrals",
    "delivered changes left causally pending (queued) by the gate",
)
_M_Q_ENTERED = _METRICS.counter(
    "farm.quarantine.entered",
    "documents moved into the quarantine set after repeated failures",
)
_M_Q_RELEASED = _METRICS.counter(
    "farm.quarantine.released", "documents returned to service"
)
_M_Q_SHED = _METRICS.counter(
    "farm.quarantine.shed",
    "deliveries dropped unprocessed because the target doc is quarantined",
)
_M_Q_ACTIVE = _METRICS.gauge(
    "farm.quarantine.active", "documents currently quarantined"
)
_M_RB_ROWS = _METRICS.counter(
    "farm.readback.rows",
    "rows transferred device→host by the scoped visibility readback",
)
_M_RB_SKIPPED = _METRICS.counter(
    "farm.readback.rows_skipped",
    "live rows NOT transferred because their cached visibility was fresh "
    "(what the old full readback would have paid)",
)
_M_RB_HITS = _METRICS.counter(
    "farm.readback.cache_hits",
    "(doc, slot) spans served from the host visibility cache",
)
_M_VECTOR_ROWS = _METRICS.counter(
    "farm.assembly.vector_rows",
    "rows processed by the vectorized (column-mask) assembly path",
)
_M_VEC_CHANGES = _METRICS.counter(
    "farm.gate.vector_changes",
    "changes gated by the columnar verdict program (transcode.gate_verdicts)",
)
_M_DEV_COLS = _METRICS.counter(
    "farm.patch.device_columns",
    "patch rows whose emit mask was computed on device by the fused "
    "visibility+patch-columns program",
)
_M_GATE_ORACLE = _METRICS.counter(
    "farm.gate.oracle_docs",
    "docs routed to the scalar gate oracle before verdicts (uncacheable "
    "ops or in-delivery duplicate hashes)",
)
_M_TC_ORACLE = _METRICS.counter(
    "farm.transcode.oracle_docs",
    "docs re-routed to the scalar chain after verdicts (seq/ref anomalies "
    "whose canonical error the oracle owns)",
)
# amscope hooks: the dispatch/readback latency histograms carry the
# ambient serve DispatchSpan id as their bucket exemplar, so a farm-side
# latency spike links back to the batched request traces it served.
_M_DISPATCH_MS = _METRICS.histogram(
    "farm.dispatch.latency_ms",
    "host-measured batched device merge dispatch latency (on the card the "
    "host clock reads the enqueue: apply_batch does not synchronise); "
    "exemplars name the owning serve dispatch span",
)
_M_READBACK_MS = _METRICS.histogram(
    "farm.readback.latency_ms",
    "host-measured scoped visibility readback latency; exemplars name "
    "the owning serve dispatch span",
)
# flight-recorder hook (obs/flight.py): quarantine transitions and device
# faults leave timeline events (with the offending change hashes) and
# auto-dump the ring for postmortems.
_FLIGHT = get_flight()

# One counter family for every per-doc quarantine cause, dimensioned by the
# taxonomy's error_kind (decode/checksum/causality/packing/device/...): the
# single funnel for "why did a doc lose this delivery", replacing the old
# split where only prevalidation aborts were counted (the batch-wide
# `farm.prevalidation.aborts` counter still tracks isolation="batch" aborts).
_QUARANTINE_CAUSES: dict[str, object] = {}


def _quarantine_cause(kind: str):
    counter = _QUARANTINE_CAUSES.get(kind)
    if counter is None:
        counter = _METRICS.counter(
            f"farm.quarantine.causes.{kind}",
            f"per-doc quarantined deliveries with error_kind={kind}",
        )
        _QUARANTINE_CAUSES[kind] = counter
    return counter

_MAKE_TYPES = {
    "makeMap": "map",
    "makeTable": "table",
    "makeList": "list",
    "makeText": "text",
}


def _empty_object_patch(object_id, type_):
    if type_ in ("list", "text"):
        return {"objectId": object_id, "type": type_, "edits": []}
    return {"objectId": object_id, "type": type_, "props": {}}


class DocOutcome(NamedTuple):
    """Per-document result of one apply_changes call (isolation="doc")."""

    status: str                       # "applied" | "quarantined"
    error: BaseException | None = None
    error_kind: str | None = None     # taxonomy dimension (errors.error_kind)
    offending_hashes: tuple = ()      # change hashes implicated, if known
    fallback: bool = False            # served by the sequential walk


_APPLIED = DocOutcome("applied")
_APPLIED_FALLBACK = DocOutcome("applied", fallback=True)


class FarmApplyResult(list):
    """apply_changes' return value: the per-doc patch list every existing
    caller indexes into, plus the per-doc outcome report."""

    def __init__(self, patches, outcomes):
        super().__init__(patches)
        self.outcomes = list(outcomes)

    @property
    def quarantined(self):
        """{doc index: DocOutcome} of the docs that lost this delivery."""
        return {
            d: o for d, o in enumerate(self.outcomes) if o.status == "quarantined"
        }

    @property
    def applied(self):
        """{doc index: DocOutcome} of the docs whose delivery committed
        (fallback-walk-served docs included) — the symmetric accessor to
        ``quarantined``."""
        return {
            d: o for d, o in enumerate(self.outcomes) if o.status == "applied"
        }


# ---------------------------------------------------------------------- #
# wire frames: the picklable shipping format a mesh worker process uses
# to return one FarmApplyResult over a pipe (parallel/workers.py).
# Patches are double-pickled — the whole per-doc patch list rides as ONE
# opaque blob inside the response — so the controller can defer (or
# skip) materializing thousands of patch dicts it may never index into;
# outcomes travel as flat tuples with the exception safely pickled
# (exceptions can carry unpicklable payloads, e.g. wrapped runtime
# errors — those degrade to a same-taxonomy stand-in carrying the repr).
# Every payload is host data (dicts, lists, str, int, bytes, numpy), never
# a torch tensor: ``import torch`` registers reductions that would ship a
# card tensor across the pipe as a CUDA IPC handle.

def exc_to_blob(exc: BaseException | None) -> bytes | None:
    """Pickles an exception, degrading unpicklable ones to a
    DeviceFaultError-taxonomy stand-in that preserves kind + repr."""
    if exc is None:
        return None
    try:
        blob = pickle.dumps(exc)
        pickle.loads(blob)  # some exceptions pickle but fail to rebuild
        return blob
    except Exception:
        stand_in = DeviceFaultError(
            f"[unpicklable {type(exc).__name__}] {exc!r}"
        )
        stand_in.kind = error_kind(exc)
        return pickle.dumps(stand_in)


def exc_from_blob(blob: bytes | None) -> BaseException | None:
    return None if blob is None else pickle.loads(blob)


def outcome_to_wire(o: DocOutcome) -> tuple:
    return (
        o.status, exc_to_blob(o.error), o.error_kind,
        tuple(o.offending_hashes), o.fallback,
    )


def outcome_from_wire(w: tuple) -> DocOutcome:
    status, blob, kind, offending, fallback = w
    if status == "applied" and blob is None and not offending:
        return _APPLIED_FALLBACK if fallback else _APPLIED
    return DocOutcome(status, exc_from_blob(blob), kind, offending, fallback)


def result_to_wire(result: FarmApplyResult) -> dict:
    """{patches: blob, outcomes: [wire tuples]} — see block comment."""
    return {
        "patches": pickle.dumps(
            list(result), protocol=pickle.HIGHEST_PROTOCOL
        ),
        "outcomes": [outcome_to_wire(o) for o in result.outcomes],
    }


def result_from_wire(frame: dict) -> FarmApplyResult:
    return FarmApplyResult(
        pickle.loads(frame["patches"]),
        [outcome_from_wire(w) for w in frame["outcomes"]],
    )


#: cache sentinel for changes the column transcoder cannot express
_UNCACHEABLE = object()


class _ChangeCols:
    """One decoded change transcoded ONCE into column form (cached per
    change hash): the dense row array plus every per-doc side effect of
    `_op_rows` recorded as replayable data. A change gossiped to N
    documents builds its columns a single time; committing it to a doc
    replays the recorded effects (counter registration, inc max-merge,
    child metas) without any per-op Python. List/text ops and unknown
    actions are uncacheable (`_build_change_cols` returns None): they
    mutate order-dependent per-doc element state, so their docs route
    through the scalar oracle chain."""

    __slots__ = (
        "hash", "actor", "seq", "deps", "max_ctr", "arr", "counter_packed",
        "inc_updates", "starved", "children", "objs", "external_refs",
        "cut_slots", "cut_packed", "_sorted",
    )

    def __init__(self, change, max_ctr, arr, counter_packed, inc_updates,
                 starved, children, objs, external_refs, cut_slots,
                 cut_packed):
        self.hash = change["hash"]
        self.actor = change["actor"]
        self.seq = change["seq"]
        self.deps = tuple(change["deps"])
        self.max_ctr = max_ctr
        self.arr = arr
        self.counter_packed = counter_packed
        self.inc_updates = inc_updates
        self.starved = starved
        self.children = children
        self.objs = objs
        self.external_refs = external_refs
        self.cut_slots = cut_slots
        self.cut_packed = cut_packed
        self._sorted = None

    def sorted_cols(self):
        """Mirror-weave columns in merge-key order, lazily sorted once and
        shared by every doc the change merges into:
        (mkey sorted, key32, op, action32, unique slots)."""
        if self._sorted is None:
            arr = self.arr
            mkey = (arr[:, 0] << _MKEY_OP_BITS) | arr[:, 1]
            order = np.argsort(mkey, kind="stable")
            self._sorted = (
                mkey[order],
                arr[order, 0].astype(np.int32),
                arr[order, 1],
                arr[order, 2].astype(np.int32),
                np.unique(arr[:, 0]),
            )
        return self._sorted


class TorchDocFarm:
    """N documents, one device engine. See module docstring.

    `device` is where the op slab and the merge programs live: the card
    unless the caller asks for the CPU (``device="cpu"``); there is no
    fallback from one to the other.

    `quarantine_threshold`: consecutive failed deliveries after which a
    document enters the quarantine set and sheds its traffic until
    `release_quarantine` (None disables the set; every failure still
    quarantines that one delivery)."""

    def __init__(self, num_docs: int, capacity: int = 1024,
                 quarantine_threshold: int | None = 3,
                 page_size: int | None = None,
                 gate_mode: str | None = None,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchDocFarm runs on the card by default and CUDA is not "
                "available here; pass device='cpu' to run on the CPU"
            )
        # "columnar" gates whole deliveries with verdict columns
        # (transcode.gate_verdicts) and commits ready changes from cached
        # column arrays; "oracle" pins every doc to the scalar gate chain
        # (the parity oracle the columnar path re-routes anomalies to).
        gate_mode = gate_mode or os.environ.get("AM_GATE_MODE", "columnar")
        if gate_mode not in ("columnar", "oracle"):
            raise ValueError(f"unknown gate mode: {gate_mode!r}")  # amlint: disable=AM401 — API-usage validation
        self.gate_mode = gate_mode
        self.num_docs = num_docs
        self.engine = BatchedMapEngine(num_docs, capacity,
                                       page_size=page_size, device=device)
        # optional crash-consistent persistence tier (store/): attach_store
        # routes every committed delivery through the WAL and a
        # group-commit fsync barrier before its patches are acked
        self.store = None
        # interners are shared across the batch: actor ids, (objectId, key)
        # slots and scalar values are global tables, document state is not.
        # Caps guard the merge-key packing ranges (slot << 44 | ctr << 20 |
        # actor): an overflowing table would silently corrupt sort order.
        self.actors = _Interner(max_size=1 << ACTOR_BITS, name="actor")
        self.slots = _Interner(max_size=_MAX_SLOTS, name="slot")
        # amlint: disable=AM103 — value ids are payloads, never packed into
        # merge keys, so the table has no bit-field cap
        self.values = _Interner()
        # per-document host state
        self.object_meta = [{"_root": dict(_ROOT_META)} for _ in range(num_docs)]
        self.clock = [{} for _ in range(num_docs)]
        self.heads = [[] for _ in range(num_docs)]
        self.queue = [[] for _ in range(num_docs)]
        self.changes = [[] for _ in range(num_docs)]  # raw change buffers
        self.change_index_by_hash = [{} for _ in range(num_docs)]
        self.hashes_by_actor = [{} for _ in range(num_docs)]
        # hash graph (computeHashGraph, new.js:1879) — maintained eagerly
        self.dependencies_by_hash = [{} for _ in range(num_docs)]
        self.dependents_by_hash = [{} for _ in range(num_docs)]
        self.max_op = [0] * num_docs
        self.counter_ops = [set() for _ in range(num_docs)]  # packed opids
        # max inc opId per counter (Lamport tuple) — gates counter emission
        self.inc_max = [{} for _ in range(num_docs)]
        # counters named by a multi-pred inc as a non-highest pred: the
        # reference registers each inc to its highest-opId pred only
        # (counterStates overwrite, new.js:621-628), so these counters'
        # succ lists never drain and they never emit
        self.starved = [set() for _ in range(num_docs)]
        # per-(obj, key) cache of 'visible values at last walk' (the
        # reference's objectMeta children map, new.js:426) used by the
        # setupPatches ancestor-linking walk
        self.children = [{} for _ in range(num_docs)]
        # list/text element tables (rank inputs): one forest per doc
        # spanning ALL of its list objects — per-object document order is
        # the global RGA preorder filtered by owning object (rga.py)
        self.elem_capacity = 64
        self.elem_opid = np.zeros((num_docs, self.elem_capacity), np.int64)
        self.elem_parent = np.full((num_docs, self.elem_capacity), -1, np.int32)
        self.num_elems = np.zeros(num_docs, np.int32)
        self.elem_index = [{} for _ in range(num_docs)]  # elemId -> local idx
        self.elem_ids = [[] for _ in range(num_docs)]  # local idx -> elemId
        self.elem_object = [[] for _ in range(num_docs)]  # local idx -> objectId
        # reference merge walk per doc, created lazily on the first op that
        # targets a list/text object (see module docstring): authoritative
        # for that doc's incremental patch stream from then on
        self.exact: list[OpSet | None] = [None] * num_docs
        # fault-isolation state (isolation="doc"): consecutive failure
        # streaks, the quarantine set (doc -> last cause), and docs pinned
        # to the sequential walk after a device-path failure
        self.quarantine_threshold = quarantine_threshold
        self.fault_counts = [0] * num_docs
        self.quarantine: dict[int, BaseException] = {}
        self.degraded: set[int] = set()
        # host mirror of the device op table (incremental readback, README
        # "Performance"): per doc, the live rows in exact device order —
        # the host produced every row and the merge insert position is
        # deterministic (engine._merge_one_doc), so key/op/action never
        # need a device transfer. visible/total are a per-(doc, slot)
        # cache refreshed from the device only for slots invalidated by a
        # commit; steady-state sync rounds read back only deltas.
        self._vis_mkey = [np.empty(0, np.int64) for _ in range(num_docs)]
        self._vis_key = [np.empty(0, np.int32) for _ in range(num_docs)]
        self._vis_op = [np.empty(0, np.int64) for _ in range(num_docs)]
        self._vis_action = [np.empty(0, np.int32) for _ in range(num_docs)]
        self._vis_visible = [np.empty(0, bool) for _ in range(num_docs)]
        self._vis_total = [np.empty(0, np.int64) for _ in range(num_docs)]
        self._vis_stale = [set() for _ in range(num_docs)]  # slot ids to re-read
        self._vis_all_stale = [False] * num_docs
        # actor-rank table cached per interner size (it only ever grows)
        self._rank_cache = (0, np.zeros(0, np.int32))
        # interned value ids that hold ChildObj cells (child detection in
        # the vectorized children-cache update without a lookup per row)
        self._child_value_ids: set[int] = set()
        # columnar-gate caches: change hash -> _ChangeCols (a change
        # gossiped to N docs transcodes once), packed opid -> "ctr@actor",
        # value id -> leaf valueDiff template (device-column assembly)
        self._cols_cache: OrderedDict = OrderedDict()
        self._opid_strs: dict[int, str] = {}
        self._leaf_tpls: dict[int, dict] = {}

    @property
    def device(self) -> torch.device:
        """Where the op slab and the merge programs live (the engine's
        device): a ``SyncFarm`` over this farm builds its filters there."""
        return self.engine.device

    # ------------------------------------------------------------------ #
    # transcoding

    def _pack_opid(self, op_id: str) -> int:
        ctr, actor = op_id.split("@")
        return (int(ctr) << ACTOR_BITS) | self.actors.intern(actor)

    def _opid_str(self, packed: int) -> str:
        return f"{packed >> ACTOR_BITS}@{self.actors.lookup(packed & ACTOR_MASK)}"

    def _op_rows(self, d: int, op: dict, ctr: int, actor: str):
        """Dense rows for one decoded backend-form op (columnar.decode_ops
        output). Multi-pred ops emit one primary row plus marker rows (one
        per extra pred) that exist purely to record the extra succ edges;
        markers share the primary's opId and sort directly after it (stable
        sort + left-searchsorted), so opId lookups always hit the primary."""
        if "key" not in op or op.get("insert") or op.get("elemId") is not None:
            return self._list_op_rows(d, op, ctr, actor)
        obj, key = op["obj"], op["key"]
        if obj not in self.object_meta[d]:
            raise CausalityError(f"op for missing object {obj}")
        slot = self.slots.intern((obj, key))
        packed = (ctr << ACTOR_BITS) | self.actors.intern(actor)
        preds = [self._pack_opid(p) for p in op.get("pred", ())]
        action = op["action"]
        if action == "set":
            datatype = op.get("datatype")
            if datatype == "counter":
                self.counter_ops[d].add(packed)
                value = int(op["value"])
            else:
                value = self.values.intern(ValueCell(op["value"], datatype))
            rows = [(slot, packed, ACTION_SET, value, preds[0] if preds else -1)]
        elif action in _MAKE_TYPES:
            value = self._register_child(d, obj, key, action, ctr, actor)
            rows = [(slot, packed, ACTION_SET, value, preds[0] if preds else -1)]
        elif action == "inc":
            lam = (ctr, actor)
            for target in op.get("pred", ()):
                t = self._pack_opid(target)
                if t not in self.inc_max[d] or self.inc_max[d][t] < lam:
                    self.inc_max[d][t] = lam
            # A multi-pred inc adds its value to only ONE target in the
            # reference: counterStates[incOp] is overwritten by each walked
            # counter, so the highest-opId pred wins (new.js:621-628). The
            # primary row carries the value to preds[-1] (preds are sorted
            # ascending); the rest get zero-valued inc markers, which keep
            # the extra counters visible (inc successors never hide,
            # new.js:937-944) without contributing.
            rows = [(slot, packed, ACTION_INC, int(op["value"]), preds[-1] if preds else -1)]
            for extra in preds[:-1]:
                self.starved[d].add(extra)
                rows.append((slot, packed, ACTION_INC, 0, extra))
            return rows
        elif action == "del":
            rows = [(slot, packed, ACTION_DEL, 0, preds[0] if preds else -1)]
        else:
            raise NotImplementedError(f"op action {action!r} not supported by the farm")
        for extra in preds[1:]:
            rows.append((slot, packed, ACTION_DEL, 0, extra))
        return rows

    def _register_child(self, d, obj, parent_key, action, ctr, actor):
        child_id = f"{ctr}@{actor}"
        self.object_meta[d][child_id] = {
            "parentObj": obj,
            "parentKey": parent_key,
            "type": _MAKE_TYPES[action],
        }
        value = self.values.intern(ChildObj(child_id))
        self._child_value_ids.add(value)
        return value

    def _grow_elems(self, needed: int):
        if needed > rga.MAX_ELEMS:
            raise PackingLimitError(
                f"document exceeds {rga.MAX_ELEMS} list elements (incl. "
                "tombstones): beyond the rank kernel's key-packing range"
            )
        while needed > self.elem_capacity:
            pad = self.elem_capacity
            self.elem_opid = np.concatenate(
                [self.elem_opid, np.zeros((self.num_docs, pad), np.int64)], axis=1
            )
            self.elem_parent = np.concatenate(
                [self.elem_parent, np.full((self.num_docs, pad), -1, np.int32)],
                axis=1,
            )
            self.elem_capacity *= 2

    def _list_op_rows(self, d: int, op: dict, ctr: int, actor: str):
        """Dense rows for one list/text op. Inserts register the element in
        the doc's forest (parent = the referenced element, -1 for _head) and
        key all engine rows by the element's id, so per-element conflict
        resolution rides the same device programs as map keys; document
        order comes from the batched RGA rank (rga.py)."""
        obj = op["obj"]
        meta = self.object_meta[d].get(obj)
        if meta is None:
            raise CausalityError(f"op for missing object {obj}")
        if meta["type"] not in ("list", "text"):
            raise CausalityError(f"list op for non-list object {obj}")
        packed = (ctr << ACTOR_BITS) | self.actors.intern(actor)
        preds = [self._pack_opid(p) for p in op.get("pred", ())]
        action = op["action"]

        if op.get("insert"):
            # counter range is enforced batch-wide by _prevalidate_limits
            # before any transcoding starts (the single enforcement point);
            # this only restates the invariant for direct-row callers
            assert ctr < rga.MAX_COUNTER, "op counter outside merge-key packing range"
            elem_id = f"{ctr}@{actor}"
            ref = op.get("elemId") or "_head"
            idx = int(self.num_elems[d])
            self._grow_elems(idx + 1)
            self.num_elems[d] += 1
            self.elem_opid[d, idx] = packed
            if ref == "_head":
                self.elem_parent[d, idx] = -1
            elif ref in self.elem_index[d]:
                self.elem_parent[d, idx] = self.elem_index[d][ref]
            else:
                raise CausalityError(f"unknown list element {ref}")
            self.elem_index[d][elem_id] = idx
            self.elem_ids[d].append(elem_id)
            self.elem_object[d].append(obj)
            key_elem = elem_id
        else:
            key_elem = op["elemId"]
            if key_elem not in self.elem_index[d]:
                raise CausalityError(f"unknown list element {key_elem}")
        slot = self.slots.intern((obj, key_elem))

        if action == "set":
            datatype = op.get("datatype")
            if datatype == "counter":
                self.counter_ops[d].add(packed)
                value = int(op["value"])
            else:
                value = self.values.intern(ValueCell(op.get("value"), datatype))
            rows = [(slot, packed, ACTION_SET, value, preds[0] if preds else -1)]
        elif action in _MAKE_TYPES:
            value = self._register_child(d, obj, key_elem, action, ctr, actor)
            rows = [(slot, packed, ACTION_SET, value, preds[0] if preds else -1)]
        elif action == "inc":
            lam = (ctr, actor)
            for target in op.get("pred", ()):
                t = self._pack_opid(target)
                if t not in self.inc_max[d] or self.inc_max[d][t] < lam:
                    self.inc_max[d][t] = lam
            rows = [(slot, packed, ACTION_INC, int(op["value"]),
                     preds[-1] if preds else -1)]
            for extra in preds[:-1]:
                self.starved[d].add(extra)
                rows.append((slot, packed, ACTION_INC, 0, extra))
            return rows
        elif action == "del":
            rows = [(slot, packed, ACTION_DEL, 0, preds[0] if preds else -1)]
        else:
            raise NotImplementedError(f"list op action {action!r}")
        for extra in preds[1:]:
            rows.append((slot, packed, ACTION_DEL, 0, extra))
        return rows

    def _element_ranks(self, d: int):
        """Device RGA document order of doc `d`'s element forest: rank per
        element index (the JAX farm ranks every doc's forest at once; each
        doc's ranks depend on its own forest only)."""
        from .text_engine import _next_pow2

        dev = self.engine.device
        n = int(self.num_elems[d])
        width = max(_next_pow2(n), 1)
        rank = actor_rank_table(
            self.actors.table,
            pad_to=_next_pow2(max(len(self.actors.table), 1)),
        )
        parent = np.full((1, width), -1, np.int32)
        opid = np.zeros((1, width), np.int64)
        parent[0, :n] = self.elem_parent[d, :n]
        opid[0, :n] = self.elem_opid[d, :n]
        valid = torch.arange(width, dtype=torch.int64, device=dev)[None, :] < n
        ranks = rga.batched_rga_rank(
            torch.from_numpy(parent).to(dev), torch.from_numpy(opid).to(dev),
            valid, torch.from_numpy(rank).to(dev),
        )
        _M_RANKED.inc(n)
        return ranks[0, :n].cpu().numpy()

    def _actor_rank(self):
        n = len(self.actors.table)
        if self._rank_cache[0] != n:  # the interner only ever grows
            self._rank_cache = (n, actor_rank_table(self.actors.table))
        return self._rank_cache[1]

    def _lamport(self, packed: int):
        return (packed >> ACTOR_BITS, self.actors.lookup(packed & ACTOR_MASK))

    # ------------------------------------------------------------------ #
    # run segmentation and patch cutoffs
    #
    # The sequential merge (mergeDocChangeOps, new.js:1052) walks doc ops of
    # a key only while that key's change ops are pending; once the run's
    # batching advances to a later key, the rest of the key's ops are copied
    # without patch emission. Each walk also RESETS the key's conflict map
    # (first_op => props[key] = {}, new.js:1000). Net effect: a touched
    # key's final conflict map equals the LAST touching run's walk — the
    # final visible ops of the key whose opId is <= that run's cutoff for
    # the key (+inf when the key is the run's last batch, because the stale
    # change-op comparison keeps the walk going to the end of the key run).
    # Counters additionally require every inc successor to be walked
    # (new.js:1124-1133), i.e. max inc opId <= cutoff.

    _INF = (float("inf"), "")

    def _compute_cutoffs(self, d, applied_ops):
        """applied_ops: in-order [(op_dict, ctr, actor, gate_batch)] of every
        map-family op applied this call. Returns {slot: lamport-cutoff}
        where later touching runs overwrite earlier ones. Runs may span
        consecutive changes of one actor within a causal gate batch (the
        reference's change_state walks all ops of a batch in sequence) but
        never a gate-batch boundary (each batch is a separate merge pass,
        new.js:1816-1822)."""
        cutoffs = {}
        run = None  # {"actor", "obj", "last_key", "batches": [(key, release)]}

        def close(run):
            if run is None:
                return
            last = len(run["batches"]) - 1
            for i, (key, release) in enumerate(run["batches"]):
                slot = self.slots.intern((run["obj"], key))
                cutoffs[slot] = self._INF if i == last else release

        last_batch = None
        # amlint: disable=AM107 — scalar-oracle cutoff walk: the columnar
        # path precomputes cut columns once per distinct change hash
        for op, ctr, actor, gate_batch in applied_ops:
            if gate_batch != last_batch:
                close(run)
                run = None
                last_batch = gate_batch
            key = op.get("key")
            if key is None or op.get("insert") or op.get("elemId") is not None:
                # list/text ops never produce map-key cutoffs (docs touching
                # them are served by the reference walk); a list op here can
                # only mean a new op kind leaked in — close the run safely
                close(run)
                run = None
                continue
            obj = op["obj"]
            lam = (ctr, actor)
            preds = []
            for p in op.get("pred", ()):
                pctr, pactor = p.split("@")
                preds.append((int(pctr), pactor))
            # a del op leaves the pending batch when its last pred is walked
            release = max(preds, default=lam) if op["action"] == "del" else lam

            if run is not None and run["actor"] == actor and run["obj"] == obj:
                bkey, brel = run["batches"][-1]
                overwrite = any(p in run["batch_ids"] for p in preds)
                if key == bkey and not overwrite:
                    run["batches"][-1] = (bkey, max(brel, release))
                    run["batch_ids"].add(lam)
                    run["last_key"] = key
                    continue
                if utf16_key(run["last_key"]) < utf16_key(key):
                    run["batches"].append((key, release))
                    run["batch_ids"] = {lam}
                    run["last_key"] = key
                    continue
            close(run)
            run = {"actor": actor, "obj": obj, "last_key": key,
                   "batches": [(key, release)], "batch_ids": {lam}}
        close(run)
        return cutoffs

    # ------------------------------------------------------------------ #
    # causal gate (port of the applyChanges function, new.js:1550)

    def _gate_round(self, d: int, pending):
        heads = set(self.heads[d])
        clock = dict(self.clock[d])
        round_hashes = set()
        applied, enqueued = [], []
        # amlint: disable=AM107 — the scalar causal gate IS the parity
        # oracle the columnar verdicts are tested against; anomalous docs
        # re-route here for the canonical result/error
        for change in pending:
            if (
                change["hash"] in self.change_index_by_hash[d]
                or change["hash"] in round_hashes
            ):
                continue
            expected_seq = clock.get(change["actor"], 0) + 1
            ready = all(
                dep in self.change_index_by_hash[d] or dep in round_hashes
                for dep in change["deps"]
            )
            if not ready:
                enqueued.append(change)
            elif change["seq"] < expected_seq:
                exc = CausalityError(
                    f"Reuse of sequence number {change['seq']} for actor {change['actor']}"
                )
                exc.offending_hashes = (change["hash"],)
                raise exc
            elif change["seq"] > expected_seq:
                exc = CausalityError(
                    f"Skipped sequence number {expected_seq} for actor {change['actor']}"
                )
                exc.offending_hashes = (change["hash"],)
                raise exc
            else:
                clock[change["actor"]] = change["seq"]
                round_hashes.add(change["hash"])
                for dep in change["deps"]:
                    heads.discard(dep)
                heads.add(change["hash"])
                applied.append(change)
        if applied:
            self.heads[d] = sorted(heads)
            self.clock[d] = clock
        return applied, enqueued

    # ------------------------------------------------------------------ #
    # columnar causal gate (gate_mode="columnar"): verdict columns for a
    # whole delivery at once (transcode.gate_verdicts) + per-change column
    # arrays cached across docs, with the scalar chain above as the
    # bit-for-bit parity oracle for anything the columns cannot express

    def _build_change_cols(self, change):
        """Columnar form of one decoded change, or None when any op falls
        outside the cacheable map-family subset. Mirrors `_op_rows` row
        for row (primary + marker rows); doc-independent because map-family
        rows only consult the shared interners, never per-doc state.
        Interner entries created here survive even if the change never
        commits — they are append-only lookup tables, never doc state
        (same policy as rollback)."""
        rows = []
        counter_packed = []
        inc_updates = []
        starved = []
        children = []
        local_children = set()
        external = []
        objs = set()
        actor = change["actor"]
        actor_idx = self.actors.intern(actor)
        ctr = change["startOp"]
        # amlint: disable=AM107 — columnar-cache transcode: runs ONCE per
        # distinct change hash (LRU across the whole farm), not per
        # (doc, op) delivery; every doc replays the recorded columns
        for op in change["ops"]:
            if "key" not in op or op.get("insert") or op.get("elemId") is not None:
                return None
            obj, key = op["obj"], op["key"]
            objs.add(obj)
            if obj != "_root" and obj not in local_children:
                external.append(obj)
            slot = self.slots.intern((obj, key))
            packed = (ctr << ACTOR_BITS) | actor_idx
            preds = [self._pack_opid(p) for p in op.get("pred", ())]
            action = op["action"]
            if action == "set":
                datatype = op.get("datatype")
                if datatype == "counter":
                    counter_packed.append(packed)
                    value = int(op["value"])
                else:
                    value = self.values.intern(ValueCell(op["value"], datatype))
                rows.append((slot, packed, ACTION_SET, value,
                             preds[0] if preds else -1))
            elif action in _MAKE_TYPES:
                child_id = f"{ctr}@{actor}"
                value = self.values.intern(ChildObj(child_id))
                self._child_value_ids.add(value)
                children.append((child_id, {
                    "parentObj": obj,
                    "parentKey": key,
                    "type": _MAKE_TYPES[action],
                }))
                local_children.add(child_id)
                rows.append((slot, packed, ACTION_SET, value,
                             preds[0] if preds else -1))
            elif action == "inc":
                lam = (ctr, actor)
                for target in op.get("pred", ()):
                    inc_updates.append((self._pack_opid(target), lam))
                rows.append((slot, packed, ACTION_INC, int(op["value"]),
                             preds[-1] if preds else -1))
                for extra in preds[:-1]:
                    starved.append(extra)
                    rows.append((slot, packed, ACTION_INC, 0, extra))
                ctr += 1
                continue
            elif action == "del":
                rows.append((slot, packed, ACTION_DEL, 0,
                             preds[0] if preds else -1))
            else:
                return None
            for extra in preds[1:]:
                rows.append((slot, packed, ACTION_DEL, 0, extra))
            ctr += 1
        max_ctr = ctr - 1
        arr = np.asarray(rows, np.int64).reshape(-1, 5)
        # single-change cutoffs are doc-independent too (`_compute_cutoffs`
        # only consults slots/keys/actor): cache them as rank-translatable
        # columns — ctr << ACTOR_BITS | actor INDEX, int64 max = walk to end
        applied_ops = [
            (op, change["startOp"] + i, actor, 1)
            for i, op in enumerate(change["ops"])
        ]
        cut_items = sorted(self._compute_cutoffs(None, applied_ops).items())
        cut_slots = np.asarray([s for s, _ in cut_items], np.int64)
        cut_packed = np.empty(len(cut_items), np.int64)
        inf = np.iinfo(np.int64).max
        for k, (_s, cut) in enumerate(cut_items):
            if cut[0] == float("inf"):
                cut_packed[k] = inf
            else:
                cut_packed[k] = (int(cut[0]) << ACTOR_BITS) | self.actors.intern(cut[1])
        return _ChangeCols(
            change, max_ctr, arr, counter_packed, inc_updates, starved,
            children, objs, tuple(dict.fromkeys(external)), cut_slots,
            cut_packed,
        )

    def _change_cols(self, change):
        """LRU-cached `_build_change_cols`. Exceptions while building cache as
        uncacheable — the scalar oracle chain owns the canonical error."""
        cache = self._cols_cache
        h = change["hash"]
        cols = cache.get(h)
        if cols is not None:
            cache.move_to_end(h)
            return None if cols is _UNCACHEABLE else cols
        try:
            cols = self._build_change_cols(change)
        except Exception:
            cols = None
        cache[h] = _UNCACHEABLE if cols is None else cols
        if len(cache) > 4096:
            cache.popitem(last=False)
        return cols

    def _gate_verdict_columns(self, per_doc_decoded):
        """Causal-gate verdicts for the whole delivery as column programs:
        per doc, assemble dep-index columns over (decoded + queued) entries
        and run `transcode.gate_verdicts` for commit order / deferrals in
        one pass. Returns (plans, scalar_docs): plans[d] =
        (pend, cols_list, batch, order); scalar_docs re-route through the
        scalar oracle (uncacheable ops, in-delivery duplicate hashes, or
        seq/ref anomalies whose canonical error the oracle owns)."""
        plans = {}
        scalar_docs = []
        vec_changes = 0
        for d, decoded in enumerate(per_doc_decoded):
            if not decoded:
                # no new changes: queued entries cannot become ready (their
                # missing deps only arrive with a commit), and the queue
                # holds no committed duplicates — the scalar loop would be
                # a no-op for this doc
                continue
            pend0 = decoded + self.queue[d] if self.queue[d] else decoded
            index = self.change_index_by_hash[d]
            pend = []
            positions = {}
            dup = False
            for c in pend0:
                h = c["hash"]
                if h in index:
                    continue  # committed duplicate: silently dropped
                if h in positions:
                    dup = True  # in-delivery duplicate: oracle owns dedup
                    break
                positions[h] = len(pend)
                pend.append(c)
            if dup:
                scalar_docs.append(d)
                _M_GATE_ORACLE.inc()
                continue
            if not pend:
                self.queue[d] = []
                continue
            cols_list = [self._change_cols(c) for c in pend]
            if any(cols is None for cols in cols_list):
                scalar_docs.append(d)
                _M_GATE_ORACLE.inc()
                continue
            if all(dep in index for c in pend for dep in c["deps"]):
                # every dep already committed (the steady-state shape:
                # deliveries extending known heads) — gate_verdicts would
                # assign batch 1 everywhere and keep delivery order
                batch = np.ones(len(pend), np.int64)
                order = np.arange(len(pend), dtype=np.int64)
            else:
                dep_idx = []
                dep_counts = np.empty(len(pend), np.int64)
                for i, c in enumerate(pend):
                    deps = c["deps"]
                    dep_counts[i] = len(deps)
                    for dep in deps:
                        if dep in index:
                            dep_idx.append(DEP_COMMITTED)
                        else:
                            dep_idx.append(positions.get(dep, DEP_UNKNOWN))
                batch = gate_verdicts(dep_idx, dep_counts)
                committed = np.nonzero(batch > 0)[0]
                order = committed[np.argsort(batch[committed], kind="stable")]
            if not self._validate_commit(d, pend, cols_list, order):
                scalar_docs.append(d)
                _M_TC_ORACLE.inc()
                continue
            plans[d] = (pend, cols_list, batch, order)
            vec_changes += len(pend)
        if _METRICS.enabled and vec_changes:
            _M_VEC_CHANGES.inc(vec_changes)
        return plans, scalar_docs

    def _validate_commit(self, d, pend, cols_list, order):
        """Checks the anomalies the scalar gate/transcode raises on —
        per-actor seq contiguity over the commit order, and external object
        refs resolving against committed state + earlier-committed makes.
        Returns False to re-route the doc through the scalar chain, which
        owns the canonical error (and its offending_hashes)."""
        seqs = {}
        known = self.object_meta[d]
        made = set()
        for i in order:
            c = pend[int(i)]
            cols = cols_list[int(i)]
            actor = c["actor"]
            expected = seqs.get(actor)
            if expected is None:
                expected = self.clock[d].get(actor, 0) + 1
            if c["seq"] != expected:
                return False
            seqs[actor] = expected + 1
            for obj in cols.external_refs:
                if obj not in known and obj not in made:
                    return False
            for child_id, _meta in cols.children:
                made.add(child_id)
        return True

    def _transcode_columns(self, d, plan, per_doc_arrays, applied_ops,
                           touched_objects, applied_changes, col_cuts,
                           mirror_pre):
        """Commits one doc's gate verdicts: replays each ready change's
        cached column side effects (the bookkeeping the scalar loop does
        per op) and takes the doc's dense row array straight from the
        cached column blocks — zero per-op Python on this path."""
        pend, cols_list, batch, order = plan
        deferred = [pend[i] for i in range(len(pend)) if batch[i] == 0]
        if len(deferred) == len(pend):
            self.queue[d] = deferred
            return
        clock = dict(self.clock[d])
        heads = set(self.heads[d])
        arrays = []
        multi = len(pend) - len(deferred) > 1
        for i in order:
            change = pend[int(i)]
            cols = cols_list[int(i)]
            clock[change["actor"]] = change["seq"]
            for dep in change["deps"]:
                heads.discard(dep)
            heads.add(change["hash"])
            arrays.append(cols.arr)
            touched_objects[d] |= cols.objs
            self.max_op[d] = max(self.max_op[d], cols.max_ctr)
            applied_changes[d].append(change)
            self.changes[d].append(change["buffer"])
            self.change_index_by_hash[d][change["hash"]] = (
                len(self.changes[d]) - 1
            )
            by_actor = self.hashes_by_actor[d].setdefault(change["actor"], [])
            while len(by_actor) < change["seq"]:
                by_actor.append(None)
            by_actor[change["seq"] - 1] = change["hash"]
            self.dependencies_by_hash[d][change["hash"]] = list(change["deps"])
            self.dependents_by_hash[d].setdefault(change["hash"], [])
            for dep in change["deps"]:
                self.dependents_by_hash[d].setdefault(dep, []).append(
                    change["hash"]
                )
            if cols.counter_packed:
                self.counter_ops[d].update(cols.counter_packed)
            for target, lam in cols.inc_updates:
                cur = self.inc_max[d].get(target)
                if cur is None or cur < lam:
                    self.inc_max[d][target] = lam
            if cols.starved:
                self.starved[d].update(cols.starved)
            for child_id, meta in cols.children:
                self.object_meta[d][child_id] = dict(meta)
            if multi:
                ctr = change["startOp"]
                gb = int(batch[int(i)])
                # amlint: disable=AM107 — multi-change cutoff
                # materialisation: bounded by delivery size; single-change
                # deliveries (the steady state) reuse the cached cutoff
                # columns and never run this
                for op in change["ops"]:
                    applied_ops[d].append((op, ctr, change["actor"], gb))
                    ctr += 1
        self.clock[d] = clock
        self.heads[d] = sorted(heads)
        self.queue[d] = deferred
        arr = arrays[0] if len(arrays) == 1 else np.vstack(arrays)
        if arr.shape[0]:
            per_doc_arrays[d] = arr
            if not multi:
                cols = cols_list[int(order[0])]
                col_cuts[d] = (cols.cut_slots, cols.cut_packed)
                mirror_pre[d] = cols.sorted_cols()

    def _cutoffs_from_cols(self, cuts):
        """Rebuilds the {slot: lamport-cutoff} dict `_build_diffs` expects
        from cached cutoff columns (actor-INDEX packed; int64 max = walk
        to the end of the key run)."""
        cut_slots, cut_packed = cuts
        inf = np.iinfo(np.int64).max
        out = {}
        for slot, cut in zip(cut_slots.tolist(), cut_packed.tolist()):
            out[slot] = self._INF if cut == inf else (
                cut >> ACTOR_BITS, self.actors.lookup(cut & ACTOR_MASK)
            )
        return out

    # ------------------------------------------------------------------ #
    # the reference merge walk (lazily embedded per doc)

    def _ensure_exact(self, d: int) -> OpSet:
        """Bootstraps the reference walk for doc `d` from its committed
        change log and queue, so the walk's state matches the farm's
        exactly from this call onward."""
        if self.exact[d] is None:
            from ..profiling import get_profile

            with get_profile().span("walk_replay"):
                self.exact[d] = replay_walk(self.changes[d], self.queue[d])
        return self.exact[d]

    @staticmethod
    def _targets_list(decoded_changes) -> bool:
        return any(_list_profile(change)[0] for change in decoded_changes)

    def _prevalidate_limits(self, d: int, decoded_changes) -> None:
        """Raises the farm's packing-limit errors BEFORE anything commits,
        so a failed apply leaves all state untouched.

        Every op counter must stay below 2^24, because the merge key packs
        (slot << 44 | ctr << 20 | actor) for all ops (engine._merge_key).
        The element-capacity estimate counts list inserts from this
        delivery plus the queue (queued changes may become ready in this
        call) against the rank's MAX_ELEMS, and skips changes already
        applied (duplicates never re-apply).

        Under isolation="doc" an over-limit document quarantines only its
        own delivery; under isolation="batch" the pre-pass runs for every
        doc before any doc commits, so one over-limit document fails the
        whole call with every document untouched. The queue estimate is
        conservative: a permanently stuck queued change with inserts keeps
        shrinking the doc's element budget."""
        inserts = 0
        insert_hashes = set()
        seen = set()
        # amlint: disable=AM107 — packing-limit prevalidation must walk
        # every candidate op to count list inserts BEFORE any commit;
        # it guards the quarantine boundary, not a throughput phase
        for change in list(decoded_changes) + list(self.queue[d]):
            if change["hash"] in self.change_index_by_hash[d] or change["hash"] in seen:
                continue
            seen.add(change["hash"])
            last = change["startOp"] + len(change["ops"]) - 1
            if change["ops"] and last >= _MAX_COUNTER:
                exc = PackingLimitError(
                    f"op counter {max(change['startOp'], _MAX_COUNTER)} "
                    "exceeds the merge-key packing range"
                )
                exc.offending_hashes = (change["hash"],)
                raise exc
            n_ins = _list_profile(change)[1]
            if n_ins:
                inserts += n_ins
                insert_hashes.add(change["hash"])
        if int(self.num_elems[d]) + inserts > rga.MAX_ELEMS:
            exc = PackingLimitError(
                f"document exceeds {rga.MAX_ELEMS} list elements (incl. "
                "tombstones): beyond the rank kernel's key-packing range"
            )
            exc.offending_hashes = tuple(sorted(insert_hashes))
            raise exc

    # ------------------------------------------------------------------ #
    # the batched applyChanges step

    def apply_changes(self, per_doc_buffers, is_local=False, isolation="doc"):
        """Applies binary changes to every document (one device merge for
        the whole batch) and returns one reference-format patch per doc
        (a FarmApplyResult: a plain list of patches carrying a per-doc
        `outcomes` report). `per_doc_buffers` is a list of num_docs lists
        of change buffers.

        Isolation modes:
        - ``"doc"`` (default): decode, prevalidation, walk and gate failures
          are captured PER DOCUMENT — healthy docs proceed through transcode,
          pack and device dispatch in the same call, the failing doc's
          state stays untouched (snapshot/rollback around the commit
          phase) and its outcome reports ``quarantined(error,
          offending_hashes)``. Docs failing `quarantine_threshold`
          consecutive deliveries enter the quarantine set and shed traffic
          until `release_quarantine`. If the batched device program itself
          fails mid-dispatch, the batch is bisected on the device to
          isolate the poison doc(s) and the survivors are served through
          the sequential reference walk (degraded mode), so the call still
          returns patches.
        - ``"batch"``: the all-or-nothing contract — the first failure
          raises out of the call (prevalidation aborts the whole batch
          before anything commits).

        Phases (recorded on the ambient PhaseProfile): decode ->
        walk (docs with list/text objects) -> gate_verdicts ->
        transcode_columns -> gate+transcode (scalar oracle) -> pack ->
        device_dispatch -> fallback_walk (only after a failed dispatch) ->
        visibility (host mirror merge + scoped device readback of stale
        spans) -> patch_assembly (vectorized over the mirror); prevalidate
        between decode and walk, decode_parse inside decode, walk_replay
        (the walk's first bootstrap from the log) and walk_apply (the
        embedded OpSet's apply) inside walk."""
        from ..profiling import get_profile

        if isolation not in ("doc", "batch"):
            raise ValueError(f"unknown isolation mode: {isolation!r}")  # amlint: disable=AM401 — API-usage validation
        doc_mode = isolation == "doc"

        prof = get_profile()
        assert len(per_doc_buffers) == self.num_docs
        per_doc_rows = [[] for _ in range(self.num_docs)]
        per_doc_arrays = [None] * self.num_docs
        applied_ops = [[] for _ in range(self.num_docs)]
        touched_objects = [set() for _ in range(self.num_docs)]
        applied_changes = [[] for _ in range(self.num_docs)]
        # fault-domain state for this call (isolation="doc")
        exact_patches: dict[int, dict] = {}
        failures: dict[int, BaseException] = {}
        snapshots: dict[int, dict] = {}
        fallback_docs: set[int] = set()
        attempted = [d for d in range(self.num_docs) if per_doc_buffers[d]]
        # WAL capture: remember each attempted doc's committed-change count.
        # The delta at return is exactly what this call committed — uniform
        # across the columnar gate, the scalar oracle and the fallback walk,
        # and naturally zero for docs a quarantine rollback restored.
        store_marks = (
            {d: len(self.changes[d]) for d in attempted}
            if self.store is not None else None
        )

        def quarantine(d, exc):
            """Captures one doc's failure: rolls its state back, drops its
            rows/patch work, and counts the cause by error_kind."""
            if d in snapshots:
                # the rolled-back delivery never reached the mirror or the
                # device (the merge replays only after every doc committed),
                # so only the spans it MEANT to touch need a re-read
                arr = per_doc_arrays[d]
                if arr is not None:
                    stale = np.unique(arr[:, 0]).tolist()
                elif per_doc_rows[d]:
                    stale = {int(r[0]) for r in per_doc_rows[d]}
                else:
                    stale = ()
                self._restore_doc(d, snapshots.pop(d), stale_slots=stale)
            exact_patches.pop(d, None)
            failures[d] = exc
            per_doc_decoded[d] = []
            per_doc_rows[d] = []
            per_doc_arrays[d] = None
            applied_ops[d] = []
            touched_objects[d] = set()
            applied_changes[d] = []
            _quarantine_cause(error_kind(exc)).inc()
            self.fault_counts[d] += 1
            if (
                self.quarantine_threshold is not None
                and self.fault_counts[d] >= self.quarantine_threshold
                and d not in self.quarantine
            ):
                self.quarantine[d] = exc
                _M_Q_ENTERED.inc()
                _M_Q_ACTIVE.set(len(self.quarantine))
                if _FLIGHT.enabled:
                    _FLIGHT.record(
                        "farm.quarantine.enter", doc=d,
                        kind=error_kind(exc),
                        offending_hashes=list(
                            getattr(exc, "offending_hashes", ())
                        ),
                        failures=self.fault_counts[d],
                    )
                    _FLIGHT.trigger("farm.quarantine", doc=d)

        # quarantined docs shed their traffic before any work happens
        if doc_mode and self.quarantine:
            per_doc_buffers = list(per_doc_buffers)
            for d, cause in self.quarantine.items():
                if per_doc_buffers[d]:
                    per_doc_buffers[d] = []
                    failures[d] = QuarantinedError(
                        f"document {d} is quarantined after "
                        f"{self.fault_counts[d]} failed deliveries (last "
                        f"cause: {cause}); release_quarantine({d}) to "
                        "restore traffic"
                    )
                    _M_Q_SHED.inc()

        with prof.phase("decode"):
            # batched first-touch decode: every distinct cache miss in the
            # delivery parses in ONE vector pass (tpu/decode) — the per-doc
            # loop below then hits the shared LRU. Buffers the batch pass
            # cannot decode stay uncached and raise their canonical error
            # inside the owning doc's fault domain.
            with prof.span("decode_parse"):
                warm_decode_cache(
                    [b for buffers in per_doc_buffers for b in buffers]
                )
            per_doc_decoded = []
            for d, buffers in enumerate(per_doc_buffers):
                decoded = []
                try:
                    _fault_point("farm.decode", doc=d, buffers=buffers)
                    for buffer in buffers:
                        # LRU-backed: one parse per distinct change however
                        # many documents it is gossiped to (shallow copy per
                        # doc; the shared ops list is never mutated)
                        change = decode_change_cached(buffer)
                        change["buffer"] = bytes(buffer)
                        decoded.append(change)
                except Exception as exc:
                    if not doc_mode:
                        raise
                    per_doc_decoded.append([])
                    quarantine(d, exc)
                    continue
                per_doc_decoded.append(decoded)

        # Docs receiving no changes this call skip prevalidation entirely:
        # their queue was validated at its original delivery and a queued
        # change can only become ready when a NEW change for the same doc
        # commits. The JAX farm's table leaves this time in no phase.
        with prof.phase("prevalidate"):
            for d, decoded in enumerate(per_doc_decoded):
                if not decoded:
                    continue
                try:
                    self._prevalidate_limits(d, decoded)
                except ValueError as exc:
                    if not doc_mode:
                        _M_ABORTS.inc()
                        raise
                    quarantine(d, exc)

        # list/text-targeting docs route through the reference walk, whose
        # patch is authoritative for them (byte-exact edit streams; see
        # module docstring). It runs BEFORE the farm's own gate so error
        # behaviour (seq reuse, missing objects) matches the sequential
        # engine's.
        with prof.phase("walk"):
            for d, decoded in enumerate(per_doc_decoded):
                if decoded and (
                    self.exact[d] is not None or self._targets_list(decoded)
                ):
                    try:
                        self._ensure_exact(d)
                        with prof.span("walk_apply"):
                            exact_patches[d] = self.exact[d].apply_changes(
                                [c["buffer"] for c in decoded], is_local
                            )
                        _M_WALK_OPS.inc(sum(len(c["ops"]) for c in decoded))
                    except Exception as exc:
                        if not doc_mode:
                            raise
                        # the walk bootstrap/apply may be mid-flight;
                        # rebuild lazily from the committed log
                        self.exact[d] = None
                        quarantine(d, exc)

        # snapshot + columnar verdicts: the whole delivery's gate decisions
        # (commit order / deferrals) come from one dep-column program per
        # doc (transcode.gate_verdicts); docs the columns cannot express
        # re-route through the scalar oracle below, which owns the
        # canonical result/error. Batch isolation keeps the all-scalar
        # behaviour (one raise aborts the call).
        use_columnar = doc_mode and self.gate_mode == "columnar"
        col_cuts: dict[int, tuple] = {}
        mirror_pre: dict[int, tuple] = {}
        with prof.phase("gate_verdicts"):
            if doc_mode:
                for d, decoded in enumerate(per_doc_decoded):
                    if decoded:
                        snapshots[d] = self._snapshot_doc(d)
            if use_columnar:
                plans, scalar_docs = self._gate_verdict_columns(per_doc_decoded)
            else:
                plans, scalar_docs = {}, range(self.num_docs)

        with prof.phase("transcode_columns"):
            for d, plan in plans.items():
                try:
                    self._transcode_columns(
                        d, plan, per_doc_arrays, applied_ops,
                        touched_objects, applied_changes, col_cuts,
                        mirror_pre,
                    )
                except Exception as exc:
                    self.exact[d] = None
                    col_cuts.pop(d, None)
                    mirror_pre.pop(d, None)
                    quarantine(d, exc)

        with prof.phase("gate+transcode"):
            for d in scalar_docs:
                decoded = per_doc_decoded[d]
                pending = decoded + self.queue[d] if self.queue[d] else decoded
                gate_batch = 0
                try:
                    while True:
                        applied, pending = self._gate_round(d, pending)
                        if not applied:
                            break
                        gate_batch += 1
                        # amlint: disable=AM107 — scalar-oracle transcode:
                        # docs land here only on gate_mode="oracle" or an
                        # anomaly re-route; the chain owns the canonical
                        # result and its offending_hashes
                        for change in applied:
                            ctr = change["startOp"]
                            # amlint: disable=AM107 — same oracle chain
                            for op in change["ops"]:
                                rows = self._op_rows(d, op, ctr, change["actor"])
                                per_doc_rows[d].extend(rows)
                                applied_ops[d].append(
                                    (op, ctr, change["actor"], gate_batch)
                                )
                                touched_objects[d].add(op["obj"])
                                ctr += 1
                            self.max_op[d] = max(self.max_op[d], ctr - 1)
                            applied_changes[d].append(change)
                            # commit immediately so later gate rounds (and
                            # later calls) see this hash as a satisfied
                            # dependency
                            self.changes[d].append(change["buffer"])
                            self.change_index_by_hash[d][change["hash"]] = (
                                len(self.changes[d]) - 1
                            )
                            by_actor = self.hashes_by_actor[d].setdefault(
                                change["actor"], []
                            )
                            while len(by_actor) < change["seq"]:
                                by_actor.append(None)
                            by_actor[change["seq"] - 1] = change["hash"]
                            self.dependencies_by_hash[d][change["hash"]] = list(
                                change["deps"]
                            )
                            self.dependents_by_hash[d].setdefault(change["hash"], [])
                            for dep in change["deps"]:
                                self.dependents_by_hash[d].setdefault(dep, []).append(
                                    change["hash"]
                                )
                        if not pending:
                            break
                    self.queue[d] = pending
                except Exception as exc:
                    if not doc_mode:
                        raise
                    # exact walk state (if any) committed the delivery the
                    # farm is rolling back; rebuild it lazily
                    self.exact[d] = None
                    quarantine(d, exc)

        if _METRICS.enabled:
            _M_WALKS.inc(len(exact_patches))
            _M_APPLIED.inc(sum(len(c) for c in applied_changes))
            delivered = {
                c["hash"] for decoded in per_doc_decoded for c in decoded
            }
            _M_DEFERRALS.inc(sum(
                1
                for d in range(self.num_docs)
                for c in self.queue[d]
                if c["hash"] in delivered
            ))

        # one device merge for the ACTIVE docs only: the paged engine
        # gathers just their rows from the slab, so idle documents cost
        # neither device traffic nor kernel work. Columnar-gated docs
        # already carry their dense row arrays (cached column blocks);
        # scalar-gated docs densify their row lists here.
        device_failed = False
        for d, rows in enumerate(per_doc_rows):
            if rows and per_doc_arrays[d] is None:
                per_doc_arrays[d] = np.asarray(rows, np.int64)
        width = max(
            (a.shape[0] for a in per_doc_arrays if a is not None), default=0
        )
        if width > 0:
            active = tuple(
                d for d in range(self.num_docs)
                if per_doc_arrays[d] is not None
            )
            if _METRICS.enabled:
                # pad waste is measured over the ACTIVE docs' cells
                rows = sum(per_doc_arrays[d].shape[0] for d in active)
                cells = len(active) * width
                _M_ROWS.inc(rows)
                _M_PAD_ROWS.inc(cells - rows)
                _M_PAD_RATIO.set(1.0 - rows / cells)
                _M_OCCUPANCY.observe(rows / cells)
            with prof.phase("pack"):
                batch, counts = self._pack_subset(
                    per_doc_arrays, active, width=width
                )
            with prof.phase("device_dispatch"):
                try:
                    _fault_point("farm.device_dispatch", docs=active)
                    dispatch_t0 = time.perf_counter()
                    self.engine.apply_batch(batch, docs=active, counts=counts)
                    if _METRICS.enabled:
                        _M_DISPATCH_MS.observe(
                            (time.perf_counter() - dispatch_t0) * 1000.0,
                            exemplar=current_exemplar(),
                        )
                except Exception as exc:
                    if not doc_mode:
                        raise
                    # Degraded mode: the batched device path is gone for
                    # this call (the engine handed its fresh pages back).
                    # Bisect to find the doc(s) whose rows poison the
                    # program; quarantine them (host state rolled back) and
                    # serve every survivor through the sequential
                    # reference walk below.
                    device_failed = True
                    _M_FB_CALLS.inc()
                    if _FLIGHT.enabled:
                        _FLIGHT.record("farm.device_fault",
                                       docs=list(active), error=str(exc))
                        _FLIGHT.trigger("farm.device_fault")
                    poison = self._bisect_device_faults(per_doc_arrays, active)
                    for d in sorted(poison):
                        quarantine(d, DeviceFaultError(
                            f"batched device dispatch fails with document "
                            f"{d}'s rows in the batch: {exc}"
                        ))
                    fallback_docs.update(d for d in active if d not in poison)

        if device_failed:
            with prof.phase("fallback_walk"):
                for d in sorted(fallback_docs):
                    try:
                        if d in exact_patches:
                            # the walk already produced this call's patch;
                            # just pin the doc to walk-served mode
                            self.degraded.add(d)
                        else:
                            exact_patches[d] = self._fallback_walk(
                                d,
                                snapshots.get(d),
                                [c["buffer"] for c in per_doc_decoded[d]],
                                is_local,
                            )
                        _M_FB_DOCS.inc()
                    except Exception as exc:
                        quarantine(d, exc)

        emit_info: dict[int, tuple] = {}
        with prof.phase("visibility"):
            # after a device failure nothing may touch the device again
            # this call: every doc with applied rows is fallback- or
            # quarantine-served, so the other docs' patches need no read
            if width > 0 and not device_failed:
                # replicate the committed merge on the host mirror (exact
                # device row order, no transfer), then refresh the stale
                # (doc, slot) visibility spans with one scoped gather.
                # Docs whose whole delivery is a single cached columnar
                # change on counter-free, child-free state take the FUSED
                # program: visibility + row gather + patch emit mask in one
                # readback (engine.read_patch_columns), leaving only
                # column->JSON materialisation for patch assembly.
                for d, arr in enumerate(per_doc_arrays):
                    if arr is not None:
                        self._merge_mirror(d, arr, pre=mirror_pre.get(d))
                # walk-served docs take their patch from the walk; their
                # stale spans refresh at the next whole-doc read
                vis_docs = [
                    d for d in range(self.num_docs)
                    if d not in failures and d not in exact_patches
                    and per_doc_arrays[d] is not None
                ]
                fast = []
                if not self._child_value_ids:
                    fast = [
                        d for d in vis_docs
                        if d in col_cuts
                        and not self.counter_ops[d]
                        and not self.children[d]
                    ]
                if fast:
                    emit_info = self._refresh_patch_columns(fast, col_cuts)
                self._refresh_visibility(
                    [d for d in vis_docs if d not in emit_info]
                )
        with prof.phase("patch_assembly"):
            patches = []
            outcomes = []
            for d in range(self.num_docs):
                if d in failures:
                    exc = failures[d]
                    patches.append(self._noop_patch(d))
                    outcomes.append(DocOutcome(
                        "quarantined",
                        error=exc,
                        error_kind=error_kind(exc),
                        offending_hashes=tuple(
                            getattr(exc, "offending_hashes", ())
                        ),
                    ))
                    continue
                if d in attempted:
                    self.fault_counts[d] = 0  # a clean delivery ends the streak
                outcomes.append(
                    _APPLIED_FALLBACK if d in fallback_docs else _APPLIED
                )
                if d in exact_patches:
                    patches.append(exact_patches[d])
                    continue
                if d in emit_info:
                    idx_e, emit_e = emit_info[d]
                    diffs = self._build_diffs_columns(
                        d, idx_e, emit_e, col_cuts[d][0], touched_objects[d]
                    )
                elif d in col_cuts:
                    diffs = self._build_diffs(
                        d, self._cutoffs_from_cols(col_cuts[d]),
                        touched_objects[d],
                    )
                else:
                    cutoffs = self._compute_cutoffs(d, applied_ops[d])
                    diffs = self._build_diffs(d, cutoffs, touched_objects[d])
                patch = {
                    "maxOp": self.max_op[d],
                    "clock": self.clock[d],
                    "deps": self.heads[d],
                    "pendingChanges": len(self.queue[d]),
                    "diffs": diffs,
                }
                if (
                    is_local
                    and len(per_doc_buffers[d]) == 1
                    and applied_changes[d]
                ):
                    patch["actor"] = applied_changes[d][0]["actor"]
                    patch["seq"] = applied_changes[d][0]["seq"]
                patches.append(patch)
        if self.store is not None:
            # acked ⇒ durable: commits reach the WAL and the group-commit
            # fsync barrier BEFORE patches leave this call. A store failure
            # here raises out of apply_changes — the caller never sees an
            # ack the log cannot replay.
            with prof.phase("store_commit"):
                for d in attempted:
                    tail = self.changes[d][store_marks[d]:]
                    if tail:
                        self.store.append_commit(d, tail)
                self.store.commit_barrier(self._store_quarantine_snapshot())
        return FarmApplyResult(patches, outcomes)

    # ------------------------------------------------------------------ #
    # persistence (store/): the WAL rides the ack boundary

    def attach_store(self, store) -> None:
        """Attaches a ``ShardStore``: every committed delivery is appended
        to its WAL and made durable before ``apply_changes`` returns, and
        quarantine transitions persist to the store's sidecar. Hydrate the
        farm from the store FIRST (``store.hydrate.open_farm`` does both in
        order) — attached commits are logged, hydration must not be."""
        self.store = store
        # seed the sidecar so pre-existing quarantine state survives even
        # if no further delivery ever arrives
        store.save_quarantine(self._store_quarantine_snapshot())

    def _store_quarantine_snapshot(self) -> dict:
        from ..store.hydrate import quarantine_snapshot

        return quarantine_snapshot(self)

    # ------------------------------------------------------------------ #
    # fault domains: snapshot/rollback, quarantine

    def _snapshot_doc(self, d: int) -> dict:
        """Captures doc `d`'s mutable host state before the commit phase.
        Containers the gate replaces wholesale (heads/clock/queue) are kept
        by reference; containers it mutates in place are shallow-copied.
        The element arrays need only their live count: rows past
        num_elems[d] are dead (masked by the valid range) and the next
        insert overwrites them."""
        return {
            "object_meta": dict(self.object_meta[d]),
            "clock": self.clock[d],
            "heads": self.heads[d],
            "queue": self.queue[d],
            "changes_len": len(self.changes[d]),
            "change_index": dict(self.change_index_by_hash[d]),
            "hashes_by_actor": {
                k: list(v) for k, v in self.hashes_by_actor[d].items()
            },
            "deps_by_hash": {
                k: list(v) for k, v in self.dependencies_by_hash[d].items()
            },
            "dependents": {
                k: list(v) for k, v in self.dependents_by_hash[d].items()
            },
            "max_op": self.max_op[d],
            "counter_ops": set(self.counter_ops[d]),
            "inc_max": dict(self.inc_max[d]),
            "starved": set(self.starved[d]),
            "num_elems": int(self.num_elems[d]),
            "elem_index": dict(self.elem_index[d]),
            "elem_ids": list(self.elem_ids[d]),
            "elem_object": list(self.elem_object[d]),
            # paged op storage: the doc's slab pages + live row count, so
            # rollback returns any since-acquired pages to the allocator
            # instead of leaking them
            "pages": tuple(self.engine.page_table[d]),
            "page_rows": int(self.engine.lengths[d]),
        }

    def _restore_doc(self, d: int, snap: dict,
                     stale_slots=None) -> None:
        """Rolls doc `d` back to its snapshot (quarantine path). Shared
        interner entries created by the rolled-back transcode are left
        behind deliberately: they are append-only lookup tables, never
        document state.

        `stale_slots` scopes the visibility invalidation to the slots the
        failed delivery actually touched: the delivery never reached the
        mirror or the device (both commit only after every doc's gate), so
        the rest of the doc's cached spans are still exact. None keeps the
        conservative whole-doc invalidation for callers without span
        knowledge."""
        self.object_meta[d] = snap["object_meta"]
        self.clock[d] = snap["clock"]
        self.heads[d] = snap["heads"]
        self.queue[d] = snap["queue"]
        del self.changes[d][snap["changes_len"]:]
        self.change_index_by_hash[d] = snap["change_index"]
        self.hashes_by_actor[d] = snap["hashes_by_actor"]
        self.dependencies_by_hash[d] = snap["deps_by_hash"]
        self.dependents_by_hash[d] = snap["dependents"]
        self.max_op[d] = snap["max_op"]
        self.counter_ops[d] = snap["counter_ops"]
        self.inc_max[d] = snap["inc_max"]
        self.starved[d] = snap["starved"]
        self.num_elems[d] = snap["num_elems"]
        self.elem_index[d] = snap["elem_index"]
        self.elem_ids[d] = snap["elem_ids"]
        self.elem_object[d] = snap["elem_object"]
        self.engine.restore_doc(d, snap["pages"], snap["page_rows"])
        # a rolled-back delivery must never be served stale visibility
        if stale_slots is None:
            self._vis_all_stale[d] = True
            self._vis_stale[d].clear()
        elif not self._vis_all_stale[d]:
            self._vis_stale[d].update(int(s) for s in stale_slots)

    def _noop_patch(self, d: int) -> dict:
        """The patch of a delivery that changed nothing (quarantined/shed):
        current clock/heads, empty diffs."""
        return {
            "maxOp": self.max_op[d],
            "clock": self.clock[d],
            "deps": self.heads[d],
            "pendingChanges": len(self.queue[d]),
            "diffs": _empty_object_patch("_root", "map"),
        }

    def _pack_subset(self, per_doc_arrays, docs, width=None):
        """Packs the given docs' dense row column arrays ([n, 5] int64 of
        (slot, op, action, value, pred); None for empty docs) into a
        pow2-doc-padded ChangeOpsBatch [A_pad, width] by whole-column
        assignment. Returns (batch, per-doc real row counts) — the paged
        engine needs the counts to size page allocations host-side."""
        docs = list(docs)
        arrays = [per_doc_arrays[d] for d in docs]
        if width is None:
            width = max(
                (a.shape[0] for a in arrays if a is not None), default=0
            ) or 1
        a_pad = 1 << max(0, len(docs) - 1).bit_length()
        keys = np.full((a_pad, width), PAD_KEY, np.int32)
        ops = np.zeros((a_pad, width), np.int64)
        actions = np.zeros((a_pad, width), np.int32)
        values = np.zeros((a_pad, width), np.int64)
        preds = np.full((a_pad, width), -1, np.int64)
        counts = np.zeros(len(docs), np.int64)
        for k, arr in enumerate(arrays):
            if arr is None:
                continue
            n = arr.shape[0]
            counts[k] = n
            keys[k, :n] = arr[:, 0]
            ops[k, :n] = arr[:, 1]
            actions[k, :n] = arr[:, 2]
            values[k, :n] = arr[:, 3]
            preds[k, :n] = arr[:, 4]
        return changes_from_numpy(
            keys, ops, actions, values, preds, self.engine.device
        ), counts

    def _bisect_device_faults(self, per_doc_arrays, active):
        """Isolates the doc(s) whose rows crash the batched device program
        by bisection: each probe runs a subset's rows through the merge on
        the device on a throwaway basis (engine.probe_apply — no scatter,
        the slab is never advanced). Returns the poison doc set;
        `farm.bisect.rounds` counts probes."""

        def probe_ok(group):
            _M_BISECT.inc()
            try:
                _fault_point("farm.device_dispatch", docs=tuple(group))
                batch, counts = self._pack_subset(per_doc_arrays, group)
                self.engine.probe_apply(batch, group, counts)
                return True
            except Exception:
                return False

        poison = set()
        stack = [sorted(active)]
        while stack:
            group = stack.pop()
            if probe_ok(group):
                continue
            if len(group) == 1:
                poison.add(group[0])
                continue
            mid = len(group) // 2
            stack.append(group[:mid])
            stack.append(group[mid:])
        if poison == set(active):
            # every doc "poison" means the device itself is down, not the
            # data: blame nobody and serve the whole batch sequentially
            return set()
        return poison

    def _fallback_walk(self, d, snap, delivered_buffers, is_local):
        """Serves one device-failure survivor through the sequential
        reference walk: replays the doc's pre-call committed log and queue
        into a fresh OpSet, applies this call's delivery for the patch, and
        pins the doc to walk-served (degraded) mode from now on — its
        device rows are stale after the lost dispatch, so the embedded
        walk becomes authoritative for patches and whole-doc reads
        (get_patch)."""
        committed = (
            self.changes[d][: snap["changes_len"]]
            if snap is not None
            else self.changes[d]
        )
        queued = snap["queue"] if snap is not None else self.queue[d]
        opset = replay_walk(committed, queued)
        patch = opset.apply_changes(list(delivered_buffers), is_local)
        self.exact[d] = opset
        self.degraded.add(d)
        return patch

    def release_quarantine(self, doc: int | None = None):
        """Returns quarantined doc(s) to service (all of them when `doc` is
        None) and resets their failure streaks. Returns the released doc
        indexes."""
        docs = list(self.quarantine) if doc is None else [doc]
        released = []
        for d in docs:
            if d in self.quarantine:
                del self.quarantine[d]
                self.fault_counts[d] = 0
                released.append(d)
                _M_Q_RELEASED.inc()
        _M_Q_ACTIVE.set(len(self.quarantine))
        if released and _FLIGHT.enabled:
            _FLIGHT.record("farm.quarantine.release", docs=released)
        if released and self.store is not None:
            self.store.save_quarantine(self._store_quarantine_snapshot())
        return released

    # ------------------------------------------------------------------ #
    # cross-farm migration (parallel/meshfarm.py): a document moves between
    # farms as whole pages. Interner id spaces are farm-local, so the
    # export carries the source tables and adopt translates every id —
    # actors by whole-table remap (the same union a reconcile pass
    # produces), slots/values only where the doc references them (their
    # tables are packing ranges / unbounded payload tables that must not
    # import other docs' entries).

    def export_doc(self, d: int) -> dict:
        """Self-contained snapshot of doc `d` for migration to another
        farm. Row columns and packed-opid host state are in THIS farm's id
        space; the interner tables ride along by reference (they are
        append-only and the importer only reads them). Mutable host
        containers are copied, so the export stays valid after
        ``evict_doc``."""
        keys, ops, actions, values, preds, overs = self.engine.dense_view([d])
        n = int(self.engine.lengths[d])
        return {
            "rows": {
                "key": np.asarray(keys[0][:n], np.int64),
                "op": np.asarray(ops[0][:n], np.int64),
                "action": np.asarray(actions[0][:n], np.int64),
                "value": np.asarray(values[0][:n], np.int64),
                "pred": np.asarray(preds[0][:n], np.int64),
                "overwritten": np.asarray(overs[0][:n], bool),
            },
            "actor_table": list(self.actors.table),
            "slot_table": list(self.slots.table),
            "value_table": list(self.values.table),
            "object_meta": dict(self.object_meta[d]),
            "clock": dict(self.clock[d]),
            "heads": list(self.heads[d]),
            "queue": list(self.queue[d]),
            "changes": list(self.changes[d]),
            "change_index": dict(self.change_index_by_hash[d]),
            "hashes_by_actor": {
                k: list(v) for k, v in self.hashes_by_actor[d].items()
            },
            "deps_by_hash": {
                k: list(v) for k, v in self.dependencies_by_hash[d].items()
            },
            "dependents": {
                k: list(v) for k, v in self.dependents_by_hash[d].items()
            },
            "max_op": self.max_op[d],
            "counter_ops": set(self.counter_ops[d]),
            "inc_max": dict(self.inc_max[d]),
            "starved": set(self.starved[d]),
            # children re-keyed symbolically: slot ids are farm-local but
            # the interned (objectId, key) tuples are globally meaningful
            "children": {
                self.slots.lookup(s): dict(v)
                for s, v in self.children[d].items()
            },
            "num_elems": int(self.num_elems[d]),
            "elem_opid": self.elem_opid[d, : int(self.num_elems[d])].copy(),
            "elem_parent": self.elem_parent[d, : int(self.num_elems[d])].copy(),
            "elem_index": dict(self.elem_index[d]),
            "elem_ids": list(self.elem_ids[d]),
            "elem_object": list(self.elem_object[d]),
            "exact": self.exact[d],
            "degraded": d in self.degraded,
            "fault_count": self.fault_counts[d],
            "quarantine": self.quarantine.get(d),
        }

    def adopt_doc(self, d: int, export: dict) -> None:
        """Installs an exported document as doc `d` (which must be empty):
        translates every interner id into this farm's tables, re-sorts the
        rows by the destination merge key (stable, so multi-pred marker
        rows keep sorting directly after their primary), scatters them
        into freshly allocated pages, and rebuilds the host mirror. The
        visible/total cache starts stale and refreshes on the next read."""
        assert not self.changes[d] and not self.engine.page_table[d], (
            "adopt_doc target must be an empty doc slot"
        )
        rows = export["rows"]
        n = int(rows["key"].shape[0])
        src_actors = export["actor_table"]
        amap = np.fromiter(
            (self.actors.intern(a) for a in src_actors),
            np.int64, count=len(src_actors),
        )
        slot_table = export["slot_table"]
        used_s = np.unique(rows["key"]) if n else np.zeros(0, np.int64)
        smap = np.zeros(
            int(used_s.max()) + 1 if used_s.size else 1, np.int64
        )
        smap[used_s] = np.fromiter(
            (self.slots.intern(slot_table[s]) for s in used_s.tolist()),
            np.int64, count=used_s.size,
        )
        # value ids live only in non-counter SET primaries — markers carry
        # zero, counter SET/INC rows carry raw integers (see _op_rows)
        value_table = export["value_table"]
        op_col = np.asarray(rows["op"], np.int64)
        action = np.asarray(rows["action"], np.int64)
        ctr_ops = export["counter_ops"]
        if ctr_ops and n:
            is_ctr = np.isin(
                op_col, np.fromiter(ctr_ops, np.int64, count=len(ctr_ops))
            )
        else:
            is_ctr = np.zeros(n, bool)
        val_mask = (action == ACTION_SET) & ~is_ctr
        value = np.asarray(rows["value"], np.int64).copy()
        used_v = (
            np.unique(value[val_mask]) if val_mask.any()
            else np.zeros(0, np.int64)
        )
        vmap = np.zeros(
            int(used_v.max()) + 1 if used_v.size else 1, np.int64
        )
        for v in used_v.tolist():
            cell = value_table[v]
            nid = self.values.intern(cell)
            if isinstance(cell, ChildObj):
                self._child_value_ids.add(nid)
            vmap[v] = nid
        value[val_mask] = vmap[value[val_mask]]
        key = smap[np.asarray(rows["key"], np.int64)]
        op = _remap_packed(op_col, amap)
        pred = _remap_packed(np.asarray(rows["pred"], np.int64), amap)
        over = np.asarray(rows["overwritten"], bool)
        mkey = (key << _MKEY_OP_BITS) | op
        order = np.argsort(mkey, kind="stable")
        self.engine.adopt_rows(
            d, key[order].astype(np.int32), op[order],
            action[order].astype(np.int32), value[order], pred[order],
            over[order],
        )
        # symbolic host state moves as-is; packed-opid fields ride the
        # actor remap; children re-key to this farm's slot ids
        self.object_meta[d] = export["object_meta"]
        self.clock[d] = export["clock"]
        self.heads[d] = export["heads"]
        self.queue[d] = export["queue"]
        self.changes[d] = export["changes"]
        self.change_index_by_hash[d] = export["change_index"]
        self.hashes_by_actor[d] = export["hashes_by_actor"]
        self.dependencies_by_hash[d] = export["deps_by_hash"]
        self.dependents_by_hash[d] = export["dependents"]
        self.max_op[d] = export["max_op"]
        if ctr_ops:
            ctr_arr = _remap_packed(
                np.fromiter(ctr_ops, np.int64, count=len(ctr_ops)), amap
            )
            self.counter_ops[d] = set(ctr_arr.tolist())
        else:
            self.counter_ops[d] = set()
        self.inc_max[d] = {
            _remap_packed_one(k, amap): v
            for k, v in export["inc_max"].items()
        }
        self.starved[d] = {
            _remap_packed_one(k, amap) for k in export["starved"]
        }
        self.children[d] = {
            self.slots.intern(sk): dict(v)
            for sk, v in export["children"].items()
        }
        ne = export["num_elems"]
        self._grow_elems(ne)
        self.num_elems[d] = ne
        self.elem_opid[d, :ne] = _remap_packed(export["elem_opid"], amap)
        self.elem_parent[d, :ne] = export["elem_parent"]
        self.elem_index[d] = export["elem_index"]
        self.elem_ids[d] = export["elem_ids"]
        self.elem_object[d] = export["elem_object"]
        self.exact[d] = export["exact"]
        if export["degraded"]:
            self.degraded.add(d)
        else:
            self.degraded.discard(d)
        self.fault_counts[d] = export["fault_count"]
        if export["quarantine"] is not None:
            self.quarantine[d] = export["quarantine"]
        else:
            self.quarantine.pop(d, None)
        # host mirror: static columns from the translated rows, the
        # visible/total cache conservatively marked whole-doc stale
        self._vis_mkey[d] = mkey[order]
        self._vis_key[d] = key[order].astype(np.int32)
        self._vis_op[d] = op[order]
        self._vis_action[d] = action[order].astype(np.int32)
        self._vis_visible[d] = np.zeros(n, bool)
        self._vis_total[d] = np.zeros(n, np.int64)
        self._vis_all_stale[d] = bool(n)
        self._vis_stale[d] = set()

    def evict_doc(self, d: int) -> None:
        """Resets doc `d` to the fresh-document state and returns its slab
        pages to the allocator (the source half of migration; the export
        was taken first). Interner entries stay — they are append-only
        shared lookup tables, never document state."""
        self.engine.evict_doc(d)
        self.object_meta[d] = {"_root": dict(_ROOT_META)}
        self.clock[d] = {}
        self.heads[d] = []
        self.queue[d] = []
        self.changes[d] = []
        self.change_index_by_hash[d] = {}
        self.hashes_by_actor[d] = {}
        self.dependencies_by_hash[d] = {}
        self.dependents_by_hash[d] = {}
        self.max_op[d] = 0
        self.counter_ops[d] = set()
        self.inc_max[d] = {}
        self.starved[d] = set()
        self.children[d] = {}
        self.num_elems[d] = 0
        self.elem_index[d] = {}
        self.elem_ids[d] = []
        self.elem_object[d] = []
        self.exact[d] = None
        self.fault_counts[d] = 0
        self.quarantine.pop(d, None)
        self.degraded.discard(d)
        self._vis_mkey[d] = np.empty(0, np.int64)
        self._vis_key[d] = np.empty(0, np.int32)
        self._vis_op[d] = np.empty(0, np.int64)
        self._vis_action[d] = np.empty(0, np.int32)
        self._vis_visible[d] = np.empty(0, bool)
        self._vis_total[d] = np.empty(0, np.int64)
        self._vis_stale[d] = set()
        self._vis_all_stale[d] = False

    # ------------------------------------------------------------------ #
    # incremental visibility: host row mirror + scoped device readback
    #
    # The host transcoded every dispatched row and the device merge insert
    # position is a pure function of the sorted merge keys
    # (engine._merge_one_doc: left-searchsorted + stable order), so the
    # static row columns (key, packed opId, action) are replicated on the
    # host with zero device traffic. Only the merge-DEPENDENT columns —
    # per-row visibility and counter totals — come from the device, and
    # only for the (doc, slot) spans invalidated since they were last read:
    # a delivery touching 3 objects in 2 documents reads back a handful of
    # rows, not the whole farm state.

    def _merge_mirror(self, d, arr, pre=None):
        """Replays a committed device merge on doc `d`'s host mirror.
        `arr` is the [n, 5] (slot, op, action, value, pred) column array
        this call dispatched; rows land at exactly the device's insert
        positions (stable sort + left-searchsorted, so multi-pred marker
        rows keep sorting directly after their primary).

        `pre` optionally carries the change's cached merge-key-sorted
        columns (_ChangeCols.sorted_cols) so the sort and column casts are
        amortised across every doc the change was gossiped to; the weave
        itself is two whole-column fills per column instead of six
        np.inserts."""
        if pre is None:
            mkey = (arr[:, 0] << _MKEY_OP_BITS) | arr[:, 1]
            order = np.argsort(mkey, kind="stable")
            pre = (
                mkey[order],
                arr[order, 0].astype(np.int32),
                arr[order, 1],
                arr[order, 2].astype(np.int32),
                np.unique(arr[:, 0]),
            )
        mkey_s, key32, opcol, act32, uniq = pre
        old = self._vis_mkey[d]
        m = mkey_s.shape[0]
        if old.shape[0] == 0:
            # fresh doc: the cached sorted columns ARE the mirror (shared
            # across docs; mirror columns are only ever replaced wholesale
            # or scatter-written into visible/total, which are fresh here)
            self._vis_mkey[d] = mkey_s
            self._vis_key[d] = key32
            self._vis_op[d] = opcol
            self._vis_action[d] = act32
            self._vis_visible[d] = np.zeros(m, bool)
            self._vis_total[d] = np.zeros(m, np.int64)
        else:
            pos = np.searchsorted(old, mkey_s)
            total = old.shape[0] + m
            new_pos = pos + np.arange(m, dtype=np.int64)
            keep = np.ones(total, bool)
            keep[new_pos] = False

            def weave(old_col, new_col, dtype):
                out = np.empty(total, dtype)
                out[keep] = old_col
                out[new_pos] = new_col
                return out

            self._vis_mkey[d] = weave(old, mkey_s, np.int64)
            self._vis_key[d] = weave(self._vis_key[d], key32, np.int32)
            self._vis_op[d] = weave(self._vis_op[d], opcol, np.int64)
            self._vis_action[d] = weave(self._vis_action[d], act32, np.int32)
            # placeholders until the scoped readback refreshes these spans
            self._vis_visible[d] = weave(self._vis_visible[d], False, bool)
            self._vis_total[d] = weave(self._vis_total[d], 0, np.int64)
        if not self._vis_all_stale[d]:
            self._vis_stale[d].update(uniq.tolist())

    def _refresh_visibility(self, docs):
        """Brings the visibility cache of `docs` up to date: ONE batched
        device gather covering exactly the stale (doc, slot) spans. Fresh
        docs cost nothing; in the steady state only the rows a delivery
        touched cross the device boundary."""
        plan = []
        gathered = 0
        live = 0
        for d in docs:
            mkey = self._vis_mkey[d]
            if mkey.shape[0] == 0:
                self._vis_all_stale[d] = False
                self._vis_stale[d].clear()
                continue
            live += mkey.shape[0]
            if self._vis_all_stale[d]:
                idx = np.arange(mkey.shape[0], dtype=np.int64)
            elif self._vis_stale[d]:
                slots = np.fromiter(
                    self._vis_stale[d], np.int64, len(self._vis_stale[d])
                )
                slots.sort()
                _, _, idx, _ = ragged_spans(mkey, slots)
            else:
                if _METRICS.enabled:
                    _M_RB_HITS.inc(self._live_slot_count(d))
                continue
            if _METRICS.enabled:
                fresh = self._live_slot_count(d) - (
                    0 if self._vis_all_stale[d] else len(self._vis_stale[d])
                )
                _M_RB_HITS.inc(max(fresh, 0))
            plan.append((d, idx))
            gathered += idx.shape[0]
        if _METRICS.enabled:
            _M_RB_ROWS.inc(gathered)
            _M_RB_SKIPPED.inc(live - gathered)
        if not plan:
            return
        rank = self._actor_rank() if self.actors.table else None
        readback_t0 = time.perf_counter()
        visible, totals = self.engine.read_visibility_rows(
            plan, actor_rank=rank
        )
        if _METRICS.enabled:
            _M_READBACK_MS.observe(
                (time.perf_counter() - readback_t0) * 1000.0,
                exemplar=current_exemplar(),
            )
        offset = 0
        for d, idx in plan:
            n = idx.shape[0]
            self._vis_visible[d][idx] = visible[offset:offset + n]
            self._vis_total[d][idx] = totals[offset:offset + n]
            offset += n
            self._vis_all_stale[d] = False
            self._vis_stale[d].clear()

    def _refresh_patch_columns(self, docs, col_cuts):
        """The fused fast path of `_refresh_visibility`: one device program
        (engine.read_patch_columns) refreshes the stale spans AND emits the
        patch mask for this delivery's cutoff slots, so patch assembly
        needs no host-side walk-order sort or visibility filter. Per
        refreshed row the walk cutoff rides along as a rank-packed int64
        (-1 = the row's slot is outside the delivery's cutoff set; int64
        max = walk to the end of the key run). Returns {doc: (idx, emit)}
        for the docs actually refreshed."""
        plan = []
        gathered = 0
        live = 0
        rank = self._actor_rank()
        inf = np.iinfo(np.int64).max
        for d in docs:
            mkey = self._vis_mkey[d]
            if mkey.shape[0] == 0:
                self._vis_all_stale[d] = False
                self._vis_stale[d].clear()
                continue
            live += mkey.shape[0]
            if self._vis_all_stale[d]:
                idx = np.arange(mkey.shape[0], dtype=np.int64)
            elif self._vis_stale[d]:
                slots = np.fromiter(
                    self._vis_stale[d], np.int64, len(self._vis_stale[d])
                )
                slots.sort()
                _, _, idx, _ = ragged_spans(mkey, slots)
            else:
                # unreachable in practice (_merge_mirror just marked this
                # delivery's slots stale), kept for interface symmetry
                if _METRICS.enabled:
                    _M_RB_HITS.inc(self._live_slot_count(d))
                continue
            if _METRICS.enabled:
                fresh = self._live_slot_count(d) - (
                    0 if self._vis_all_stale[d] else len(self._vis_stale[d])
                )
                _M_RB_HITS.inc(max(fresh, 0))
            cut_slots, cut_packed = col_cuts[d]
            keys = self._vis_key[d][idx].astype(np.int64)
            pos = np.minimum(
                np.searchsorted(cut_slots, keys), len(cut_slots) - 1
            )
            matched = cut_slots[pos] == keys
            cp = cut_packed[pos]
            # cached cutoffs pack the actor INDEX; the device compares
            # lamport keys with actor RANK low bits — translate, keeping
            # the walk-to-end sentinel intact (its index bits are clipped:
            # np.where evaluates both branches)
            ai = np.minimum(cp & ACTOR_MASK, len(rank) - 1)
            cp = np.where(cp == inf, cp, (cp & ~ACTOR_MASK) | rank[ai])
            cut = np.where(matched, cp, -1)
            plan.append((d, idx, cut))
            gathered += idx.shape[0]
        if _METRICS.enabled:
            _M_RB_ROWS.inc(gathered)
            _M_RB_SKIPPED.inc(live - gathered)
        if not plan:
            return {}
        readback_t0 = time.perf_counter()
        visible, totals, emit = self.engine.read_patch_columns(
            plan, actor_rank=rank
        )
        if _METRICS.enabled:
            _M_READBACK_MS.observe(
                (time.perf_counter() - readback_t0) * 1000.0,
                exemplar=current_exemplar(),
            )
        out = {}
        offset = 0
        for d, idx, _cut in plan:
            n = idx.shape[0]
            self._vis_visible[d][idx] = visible[offset:offset + n]
            self._vis_total[d][idx] = totals[offset:offset + n]
            out[d] = (idx, emit[offset:offset + n])
            offset += n
            self._vis_all_stale[d] = False
            self._vis_stale[d].clear()
        if _METRICS.enabled:
            _M_DEV_COLS.inc(int(emit.sum()))
        return out

    def _live_slot_count(self, d):
        keys = self._vis_key[d]
        if keys.shape[0] == 0:
            return 0
        return int((keys[1:] != keys[:-1]).sum()) + 1

    # ------------------------------------------------------------------ #
    # patch assembly from the visibility mirror

    def _read_visibility(self):
        """Full-state readback — the reference path the incremental mirror
        is verified against (tests/test_torch_readback.py): one readback of
        the engine's whole visibility state plus a dense gather of the
        action column from the paged slab, as numpy. Production paths use
        the mirror; this exists for whole-state debugging and the parity
        suite."""
        keys, ops, visible, _winners, totals = self.engine.visible_state(
            actor_rank=self._actor_rank() if self.actors.table else None
        )
        keys, ops, visible, totals = _to_host(keys, ops, visible, totals)
        actions = self.engine.dense_view()[2]
        return keys, ops, visible, totals, actions

    def _slot_span(self, d, slot):
        mkey = self._vis_mkey[d]
        lo = np.searchsorted(mkey, np.int64(slot) << _MKEY_OP_BITS)
        hi = np.searchsorted(mkey, (np.int64(slot) + 1) << _MKEY_OP_BITS)
        return int(lo), int(hi)

    def _slot_rows(self, d, slot):
        """All walkable rows of one slot in reference walk order:
        [(packed, action, visible, total)], served from the host mirror
        (callers refresh first). Deletion rows and multi-pred marker rows
        are dropped as a column mask BEFORE any per-row materialisation —
        the reference stores deletions only as succ entries, so its walk
        never visits them. Walk order ties same-counter ops on the actor id
        STRING via the precomputed rank table, not a per-row sort key."""
        lo, hi = self._slot_span(d, slot)
        if lo == hi:
            return []
        span = slice(lo, hi)
        act = self._vis_action[d][span]
        keep = act != ACTION_DEL
        ops = self._vis_op[d][span][keep]
        if ops.shape[0] == 0:
            return []
        act = act[keep]
        vis = self._vis_visible[d][span][keep]
        tot = self._vis_total[d][span][keep]
        order = np.argsort(
            lamport_keys(ops, self._actor_rank()), kind="stable"
        )
        return [
            (int(o), int(a), bool(v), int(t))
            for o, a, v, t in zip(ops[order], act[order], vis[order], tot[order])
        ]

    def _visible_rows(self, d, slot):
        """[(packed_opid, value_total)] of visible set rows for one slot —
        the visible/action filters run as column masks before any rows are
        materialised into Python tuples."""
        lo, hi = self._slot_span(d, slot)
        if lo == hi:
            return []
        span = slice(lo, hi)
        mask = self._vis_visible[d][span] & (
            self._vis_action[d][span] == ACTION_SET
        )
        if not mask.any():
            return []
        ops = self._vis_op[d][span][mask]
        tot = self._vis_total[d][span][mask]
        order = np.argsort(
            lamport_keys(ops, self._actor_rank()), kind="stable"
        )
        return [(int(o), int(t)) for o, t in zip(ops[order], tot[order])]

    def _value_diff(self, d, patches, packed, total):
        """The valueDiff for one visible row (updatePatchProperty's values,
        new.js:884-1033)."""
        if packed in self.counter_ops[d]:
            return {"type": "value", "datatype": "counter", "value": total}
        cell = self.values.lookup(total)
        if isinstance(cell, ChildObj):
            child = cell.object_id
            if child not in patches:
                patches[child] = _empty_object_patch(
                    child, self.object_meta[d][child]["type"]
                )
            return patches[child]
        diff = {"type": "value", "value": cell.value}
        if cell.datatype is not None:
            diff["datatype"] = cell.datatype
        return diff

    def _ensure_patch(self, d, patches, object_id):
        if object_id not in patches:
            patches[object_id] = _empty_object_patch(
                object_id, self.object_meta[d][object_id]["type"]
            )
        return patches[object_id]

    def _counter_emits(self, d, packed, cutoff):
        """A counter emits only when its succ list drains during the walk:
        every inc targeting it must be walked (<= cutoff) and actually
        registered to it (not to a higher-opId conflicting counter)."""
        if packed in self.starved[d]:
            return False
        max_inc = self.inc_max[d].get(packed)
        return max_inc is None or max_inc <= cutoff

    def _cache_spec(self, d, packed, total):
        """Children-cache entry for one emitted row: the reference caches
        raw decoded values (counters with inc successors are filtered out by
        the caller, so `total` here is the raw value) and object stubs
        (new.js:426, updatePatchProperty's `values`)."""
        if packed in self.counter_ops[d]:
            return {"type": "value", "value": total, "datatype": "counter"}
        cell = self.values.lookup(total)
        if isinstance(cell, ChildObj):
            return ("child", cell.object_id)
        diff = {"type": "value", "value": cell.value}
        if cell.datatype is not None:
            diff["datatype"] = cell.datatype
        return diff

    def _children_cache_segment(self, d, slot, seg, ops, tot, spec, walked,
                                is_ctr):
        """Replays the walk's per-op children-cache updates for one slot
        from the assembly column masks.

        The reference re-evaluates `hasChild or prev_children` at EVERY
        walked op, reading the cache live (new.js:923-935): once a walk
        shrinks the cache to empty, later ops of the same walk can no
        longer update it (the gate reads the now-empty cache), so the final
        cache is order-dependent. Because the cached spec set only ever
        GROWS during one walk, the whole state machine collapses to three
        outcomes: a walked child spec anywhere re-opens the gate for good
        (cache := all walked specs); otherwise a truthy pre-existing cache
        updates to all walked specs when the FIRST walked op produced a
        spec, and sticks shut at {} when it did not; an absent/empty cache
        with no child stays untouched. Counters with inc successors never
        enter visibleOps (their succNum > 0) and inc ops enter visibleOps
        but not the cached values — both already excluded from `spec`."""
        s, e = seg
        if e == s or not walked[s]:
            return  # walked is a prefix of the lamport-ordered segment
        spec_idx = np.nonzero(spec[s:e])[0] + s
        has_child = False
        for j in spec_idx:
            if (is_ctr is None or not is_ctr[j]) and (
                int(tot[j]) in self._child_value_ids
            ):
                has_child = True
                break
        cache = self.children[d].get(slot)
        if has_child or (cache and spec[s]):
            self.children[d][slot] = {
                self._opid_str(int(ops[j])): self._cache_spec(
                    d, int(ops[j]), int(tot[j])
                )
                for j in spec_idx
            }
        elif cache:
            self.children[d][slot] = {}

    def _pack_lamport(self, cutoff, rank):
        """A (counter, actorId) lamport cutoff as an int64 comparable
        against the remapped lamport key column; _INF maps to int64 max."""
        ctr, actor = cutoff
        if ctr == float("inf"):
            return np.iinfo(np.int64).max
        idx = self.actors.find(actor)
        assert idx is not None, f"cutoff actor {actor!r} never interned"
        return (int(ctr) << ACTOR_BITS) | int(rank[idx])

    def _build_diffs(self, d, cutoffs, touched_objects):
        """Patch assembly for map-family docs from the visibility mirror.
        Docs that touch list/text objects never reach this path (they are
        served by the embedded reference walk; see apply_changes).

        The old per-slot inner loops are column operations here: slot spans
        come from one batched searchsorted pair (ragged_spans), walk order
        from a precomputed lamport sort-key column (lamport_keys — actor
        bits remapped to lexicographic ranks, replacing the per-row
        ``sort(key=...)`` callback), and the action/visibility/cutoff
        filters are boolean masks — per-row Python runs only for the rows
        that actually land in the patch."""
        patches = {"_root": _empty_object_patch("_root", "map")}

        if cutoffs:
            slot_list = sorted(cutoffs)
            slots = np.asarray(slot_list, np.int64)
            _, _, idx, grp = ragged_spans(self._vis_mkey[d], slots)
            act = self._vis_action[d][idx]
            # the reference walk never visits deletion/marker rows
            keep = act != ACTION_DEL
            idx = idx[keep]
            grp = grp[keep]
            act = act[keep]
            ops = self._vis_op[d][idx]
            vis = self._vis_visible[d][idx]
            tot = self._vis_total[d][idx]
            rank = self._actor_rank()
            lam = lamport_keys(ops, rank)
            order = np.argsort(
                (grp.astype(np.int64) << _MKEY_OP_BITS) | lam, kind="stable"
            )
            grp = grp[order]
            ops = ops[order]
            act = act[order]
            vis = vis[order]
            tot = tot[order]
            lam = lam[order]
            if _METRICS.enabled:
                _M_VECTOR_ROWS.inc(int(ops.shape[0]))

            cut = np.empty(len(slot_list), np.int64)
            for i, slot in enumerate(slot_list):
                cut[i] = self._pack_lamport(cutoffs[slot], rank)
            walked = lam <= cut[grp]
            emit = vis & (act == ACTION_SET) & walked
            spec = emit.copy()
            is_ctr = None
            if self.counter_ops[d]:
                ctr_arr = np.fromiter(
                    self.counter_ops[d], np.int64, len(self.counter_ops[d])
                )
                is_ctr = np.isin(ops, ctr_arr)
                # counters emit only once their succ list drains; the
                # children cache drops counters with ANY registered inc
                for j in np.nonzero(is_ctr & emit)[0]:
                    if not self._counter_emits(
                        d, int(ops[j]), cutoffs[slot_list[int(grp[j])]]
                    ):
                        emit[j] = False
                for j in np.nonzero(is_ctr & spec)[0]:
                    if int(ops[j]) in self.inc_max[d]:
                        spec[j] = False

            bounds = np.searchsorted(
                grp, np.arange(slots.shape[0] + 1, dtype=np.int64)
            )
            # with no ChildObj ever interned the cache gate can never open
            # (has_child is impossible and no truthy cache can exist), so
            # the per-slot replay is skipped wholesale
            track_children = bool(self._child_value_ids) or bool(
                self.children[d]
            )
            for i, slot in enumerate(slot_list):
                obj, key = self.slots.lookup(slot)
                if obj not in self.object_meta[d]:
                    continue
                patch = self._ensure_patch(d, patches, obj)
                # each walk resets the key's conflict map (new.js:1000)
                props = patch["props"][key] = {}
                s, e = int(bounds[i]), int(bounds[i + 1])
                for j in np.nonzero(emit[s:e])[0] + s:
                    packed = int(ops[j])
                    props[self._opid_str(packed)] = self._value_diff(
                        d, patches, packed, int(tot[j])
                    )
                if track_children:
                    self._children_cache_segment(
                        d, slot, (s, e), ops, tot, spec, walked, is_ctr
                    )

        self._link_ancestors(d, patches, touched_objects)
        return patches["_root"]

    def _link_ancestors(self, d, patches, touched_objects):
        """Links touched objects up to the root (setupPatches, new.js:1461)
        — shared tail of `_build_diffs` and `_build_diffs_columns`."""
        for object_id in sorted(touched_objects):
            meta = self.object_meta[d].get(object_id)
            if meta is None:
                continue
            child_meta = None
            patch_exists = False
            while True:
                values = None
                if child_meta is not None:
                    slot = self.slots.intern((object_id, child_meta["parentKey"]))
                    values = self.children[d].get(slot) or {}
                has_children = child_meta is not None and len(values) > 0
                self._ensure_patch(d, patches, object_id)
                if child_meta is not None and has_children:
                    props = patches[object_id]["props"].setdefault(
                        child_meta["parentKey"], {}
                    )
                    for op_id, spec in values.items():
                        if op_id in props:
                            patch_exists = True
                        elif isinstance(spec, tuple):  # ("child", id)
                            child = spec[1]
                            if child not in patches:
                                patches[child] = _empty_object_patch(
                                    child, self.object_meta[d][child]["type"]
                                )
                            props[op_id] = patches[child]
                        else:
                            props[op_id] = spec
                if (
                    patch_exists
                    or not meta["parentObj"]
                    or (child_meta is not None and not has_children)
                ):
                    break
                child_meta = dict(meta, opId=object_id)
                object_id = meta["parentObj"]
                meta = self.object_meta[d][object_id]

    def _opid_str_cached(self, packed):
        s = self._opid_strs.get(packed)
        if s is None:
            s = f"{packed >> ACTOR_BITS}@{self.actors.lookup(packed & ACTOR_MASK)}"
            if len(self._opid_strs) < (1 << 16):
                self._opid_strs[packed] = s
        return s

    def _leaf_diff(self, value_id):
        """valueDiff for a plain (non-counter, non-ChildObj) interned value
        — the only kind the device-column path can emit (its eligibility
        gate excludes counter docs and farms with child values, making
        this equivalent to `_value_diff`). Templates are cached per value
        id and copied per emission (patch consumers may mutate them)."""
        tpl = self._leaf_tpls.get(value_id)
        if tpl is None:
            cell = self.values.lookup(value_id)
            tpl = {"type": "value", "value": cell.value}
            if cell.datatype is not None:
                tpl["datatype"] = cell.datatype
            if len(self._leaf_tpls) < (1 << 16):
                self._leaf_tpls[value_id] = tpl
        return dict(tpl)

    def _build_diffs_columns(self, d, idx, emit, cut_slots, touched_objects):
        """Patch assembly from DEVICE-emitted patch columns — the fast path
        for single-change columnar commits on counter-free, child-free
        state. The emit mask arrived with the fused visibility readback
        (engine.read_patch_columns), so the walk-order sort and the
        visibility/action/cutoff filters of `_build_diffs` have already
        happened on device; what remains is column -> JSON
        materialisation."""
        patches = {"_root": _empty_object_patch("_root", "map")}
        eidx = idx[emit]
        # mirror rows are merge-key (slot-major) ordered, so the emitted
        # keys arrive pre-grouped for the span searchsorted below
        keys = self._vis_key[d][eidx].astype(np.int64)
        ops = self._vis_op[d][eidx]
        tot = self._vis_total[d][eidx]
        if _METRICS.enabled:
            _M_VECTOR_ROWS.inc(int(idx.shape[0]))
        lo = np.searchsorted(keys, cut_slots).tolist()
        hi = np.searchsorted(keys, cut_slots + 1).tolist()
        ops_l = ops.tolist()
        tot_l = tot.tolist()
        meta = self.object_meta[d]
        opid_str = self._opid_str_cached
        leaf = self._leaf_diff
        for i, slot in enumerate(cut_slots.tolist()):
            obj, key = self.slots.lookup(slot)
            if obj not in meta:
                continue
            patch = self._ensure_patch(d, patches, obj)
            # each walk resets the key's conflict map (new.js:1000)
            props = patch["props"][key] = {}
            for j in range(lo[i], hi[i]):
                props[opid_str(ops_l[j])] = leaf(tot_l[j])
        self._link_ancestors(d, patches, touched_objects)
        return patches["_root"]

    def _visible_sequence(self, d, ranks, obj):
        """One list object's visible elements in document order:
        [(elemId, winner_packed, total)] — device ranks (`ranks`, per
        element index of doc `d`) give the order, the visibility mirror
        gives each element's surviving value."""
        n = int(self.num_elems[d])
        if n == 0:
            return []
        order = np.argsort(ranks[:n], kind="stable")
        seq = []
        for idx in order.tolist():
            if self.elem_object[d][idx] != obj:
                continue
            elem_id = self.elem_ids[d][idx]
            slot = self.slots.intern((obj, elem_id))
            best = None
            for packed, action, visible, total in self._slot_rows(d, slot):
                if not visible or action != ACTION_SET:
                    continue
                if packed in self.counter_ops[d] and packed in self.starved[d]:
                    continue
                if best is None or self._lamport(packed) > self._lamport(best[0]):
                    best = (packed, total)
            if best is not None:
                seq.append((elem_id, best[0], best[1]))
        return seq

    # ------------------------------------------------------------------ #
    # whole-document patch (getPatch, new.js:2052)

    def get_patch(self, d: int):
        """Doc `d`'s whole-document patch, recorded on the ambient
        PhaseProfile as the phase ``whole_patch``, with the device RGA
        rank of its list elements inside it as ``rga_rank``."""
        from ..profiling import get_profile

        prof = get_profile()
        with prof.phase("whole_patch"):
            return self._whole_patch(d, prof)

    def _whole_patch(self, d: int, prof):
        # degraded docs lost device rows to a failed dispatch; their
        # embedded walk is authoritative for whole-doc reads too
        if d in self.degraded and self.exact[d] is not None:
            return self.exact[d].get_patch()
        # whole-doc reads ride the same mirror: only this doc's stale
        # spans (if any) cross the device boundary
        self._refresh_visibility([d])
        ranks = None
        if int(self.num_elems[d]) > 0:
            with prof.span("rga_rank"):
                ranks = self._element_ranks(d)
        patches = {"_root": _empty_object_patch("_root", "map")}
        list_objects = set()
        slots_here = np.unique(self._vis_key[d]).tolist()
        for slot in slots_here:
            obj, key = self.slots.lookup(slot)
            if obj not in self.object_meta[d]:
                continue
            if self.object_meta[d][obj]["type"] in ("list", "text"):
                list_objects.add(obj)
                continue
            rows = [
                (packed, total)
                for packed, total in self._visible_rows(d, slot)
                if packed not in self.counter_ops[d]
                or self._counter_emits(d, packed, self._INF)
            ]
            if not rows:
                continue  # whole-doc patches omit empty props (new.js:1604)
            patch = self._ensure_patch(d, patches, obj)
            props = patch["props"].setdefault(key, {})
            for packed, total in rows:
                props[self._opid_str(packed)] = self._value_diff(
                    d, patches, packed, total
                )
        # list objects materialise as a full insert script in document
        # order (the whole-doc scan's edits, new.js:1604)
        for obj in sorted(list_objects):
            patch = self._ensure_patch(d, patches, obj)
            for index, (elem_id, packed, total) in enumerate(
                self._visible_sequence(d, ranks, obj)
            ):
                append_edit(patch["edits"], {
                    "action": "insert", "index": index, "elemId": elem_id,
                    "opId": self._opid_str(packed),
                    "value": self._value_diff(d, patches, packed, total),
                })
        return {
            "maxOp": self.max_op[d],
            "clock": self.clock[d],
            "deps": self.heads[d],
            "pendingChanges": len(self.queue[d]),
            "diffs": patches["_root"],
        }

    # ------------------------------------------------------------------ #
    # hash-graph queries (backend.js facade parity)

    def get_heads(self, d: int):
        return list(self.heads[d])

    def get_all_changes(self, d: int):
        return list(self.changes[d])

    def get_change_by_hash(self, d: int, hash_: str):
        index = self.change_index_by_hash[d].get(hash_)
        return self.changes[d][index] if index is not None else None

    def get_changes(self, d: int, have_deps):
        """Changes a replica holding `have_deps` is missing (getChanges,
        new.js:1913): walk forward from have_deps through the dependents
        graph; if that cannot reach all heads, fall back to everything not
        in have_deps' ancestor closure."""
        if not have_deps:
            return list(self.changes[d])
        stack, seen, to_return = [], set(), []
        for h in have_deps:
            seen.add(h)
            successors = self.dependents_by_hash[d].get(h)
            if successors is None:
                raise CausalityError(f"hash not found: {h}")
            stack.extend(successors)
        while stack:
            h = stack.pop()
            seen.add(h)
            to_return.append(h)
            if not all(dep in seen for dep in self.dependencies_by_hash[d][h]):
                break
            stack.extend(self.dependents_by_hash[d][h])
        if not stack and all(head in seen for head in self.heads[d]):
            return [self.changes[d][self.change_index_by_hash[d][h]] for h in to_return]
        stack, seen = list(have_deps), set()
        while stack:
            h = stack.pop()
            if h not in seen:
                deps = self.dependencies_by_hash[d].get(h)
                if deps is None:
                    raise CausalityError(f"hash not found: {h}")
                stack.extend(deps)
                seen.add(h)
        return [
            change for change in self.changes[d]
            if decode_change_meta_cached(change)["hash"] not in seen
        ]

    def get_missing_deps(self, d: int, heads=()):
        """Dependencies needed before queued changes can apply, plus any
        requested heads we lack (getMissingDeps, new.js:2006)."""
        missing = set()
        in_queue = {change["hash"] for change in self.queue[d]}
        # amlint: disable=AM107 — sync-protocol API over the (small)
        # undeliverable queue, not a throughput phase
        for change in self.queue[d]:
            for dep in change["deps"]:
                if dep not in self.change_index_by_hash[d] and dep not in in_queue:
                    missing.add(dep)
        for head in heads:
            if head not in self.change_index_by_hash[d] and head not in in_queue:
                missing.add(head)
        return sorted(missing)

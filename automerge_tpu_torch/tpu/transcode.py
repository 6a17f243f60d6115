"""Host-side transcoding between Automerge change ops and dense op tensors.

NumPy counterpart of the JAX package's ``tpu/transcode.py``: the interners,
the actor-rank table, the column helpers of patch assembly and the
columnar causal-gate verdicts, which the farm (tpu/farm.py) builds its
device batches from, and ``BatchTranscoder``, the engine-level entry point
that packs frontend op dicts into ``ChangeOpsBatch`` tensors for
``BatchedMapEngine`` or the dense state (``batched_apply_ops``) and
decodes their visible rows back into document trees.

The variable-length columnar encodings (LEB128/RLE, backend/encoding.js) are
hostile to fixed-width SIMD, so the TPU engine works on dense interned
tensors: actors, keys and values are interned into per-batch tables on the
host, and ops become int32/int64 rows (SURVEY.md §7 'Architecture mapping').

Nested objects (maps inside maps, tables of rows — reference semantics in
frontend/context.js createNestedObjects:230 and backend/new.js objectMeta)
need no new device kernels: the engine's sort key is an opaque int32, so the
transcoder interns the *(objectId, key)* pair into one "slot" id. Rows of one
(object, key) stay contiguous under the sort, succ/visibility/conflict
resolution are per-slot and therefore per-(object, key), exactly like the
reference's (objectId, key) op grouping (new.js:1153-1224). makeMap/makeTable
ops become set-ops whose value is a child reference; the host rebuilds the
tree from the flat winner rows."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .engine import (
    ACTION_DEL,
    ACTION_INC,
    ACTION_SET,
    ACTOR_BITS,
    ACTOR_MASK,
    PAD_KEY,
    _MKEY_OP_BITS as _SLOT_SHIFT,
    ChangeOpsBatch,
    _require_device,
    changes_from_numpy,
)
from ..common import parse_op_id
from ..errors import EncodeError, PackingLimitError
from ..obs.metrics import get_metrics

_M_ROWS = get_metrics().counter(
    "transcode.rows", "ops packed into dense rows by BatchTranscoder"
)
_M_GATE_ROUNDS = get_metrics().counter(
    "farm.gate.rounds",
    "sweeps of the columnar gate's fixpoint loop (gate_verdicts), the last "
    "one the sweep that found nothing to change",
)

# Slot ids ride the high bits of the engine's packed int64 merge key
# (slot << 44 | opid): 63 value bits - 44 opid bits = 19 bits of slot before
# the sign bit flips and the sorted-table invariant silently breaks. The
# opid field itself is (counter << 20 | actor), so counters are capped at
# 2^24 and actor intern indexes at 2^20.
_MAX_SLOTS = 1 << 19
_MAX_COUNTER = 1 << 24


class ChildRef(NamedTuple):
    """Interned value marking 'this key holds the object with this id'."""

    object_id: str


def actor_rank_table(actors, pad_to=None):
    """int32 table: actor intern index -> lexicographic rank of the actor id
    string, so packed-opId comparisons tie-break like the reference
    (new.js:146, apply_patch.js:33). `pad_to` pads the table (ranks repeat
    the identity for unused slots) so jitted kernels see fewer shapes."""
    n = len(actors)
    size = max(pad_to or n, n, 1)
    ranks = np.arange(size, dtype=np.int32)  # identity for unused slots
    # amlint: disable=AM105 — actor-table-sized and cached per interner
    # size by the farm (not per row, not per call): the callback sort is
    # off the hot path by construction
    order = sorted(range(n), key=lambda i: actors[i])
    for rank, i in enumerate(order):
        ranks[i] = rank
    return ranks


class _Interner:
    """Append-only value->int table. `max_size` guards packing ranges: slot
    ids ride the high bits of the engine's int64 merge key, so an unchecked
    table would silently corrupt the sorted-table invariant past 2^19."""

    def __init__(self, max_size=None, name="intern"):
        self.table = []
        self.index = {}
        self.max_size = max_size
        self.name = name

    def intern(self, value) -> int:
        # Key by (class, value): Python equates 1 == True and
        # tuple == NamedTuple (so a user tuple could collide with a ChildRef
        # under plain value keying), but distinct classes must intern apart.
        try:
            key = (value.__class__, value)
            idx = self.index.get(key)
        except TypeError:  # unhashable (lists/dicts) — identity-intern
            key = id(value)
            idx = self.index.get(key)
        if idx is None:
            idx = len(self.table)
            if self.max_size is not None and idx >= self.max_size:
                raise PackingLimitError(
                    f"{self.name} table overflow: more than {self.max_size} "
                    "distinct entries in batch"
                )
            self.table.append(value)
            self.index[key] = idx
        return idx

    def lookup(self, idx: int):
        return self.table[idx]

    def find(self, value):
        """Index of an already-interned value (None if absent): a pure
        lookup that never grows the table, for hot paths that must not
        perturb packed-id assignment."""
        try:
            return self.index.get((value.__class__, value))
        except TypeError:  # unhashable — identity-interned
            return self.index.get(id(value))


# ---------------------------------------------------------------------- #
# column helpers for vectorized patch assembly (tpu/farm._build_diffs):
# per-slot work expressed as array operations over the host row mirror.

def lamport_keys(ops, actor_rank):
    """int64 column of reference-comparable lamport keys for packed opIds:
    the actor intern index is replaced by its lexicographic rank
    (actor_rank_table), so int64 comparison == (counter, actorId-string)
    comparison — the walk's tie-break — without a per-row sort callback."""
    return (ops >> ACTOR_BITS << ACTOR_BITS) | actor_rank[ops & ACTOR_MASK]


def ragged_spans(sorted_mkey, slots):
    """Row spans of `slots` (ascending int64 slot ids) in a merge-key-sorted
    row table: returns (starts, counts, idx, grp) where `idx` flat-indexes
    every row of every requested slot and ``grp[i]`` is the position in
    `slots` that ``idx[i]`` belongs to. One batched searchsorted pair
    replaces a per-slot binary-search loop."""
    lo = np.searchsorted(sorted_mkey, slots << _SLOT_SHIFT)
    hi = np.searchsorted(sorted_mkey, (slots + 1) << _SLOT_SHIFT)
    counts = hi - lo
    total = int(counts.sum())
    idx = np.repeat(
        lo - np.concatenate(([0], counts.cumsum()[:-1])), counts
    ) + np.arange(total, dtype=np.int64)
    grp = np.repeat(np.arange(slots.shape[0], dtype=np.int64), counts)
    return lo, counts, idx, grp


#: gate_verdicts dep-column sentinels: a dep that is already committed in
#: the doc, and a dep that is neither committed nor in this delivery.
DEP_COMMITTED = -1
DEP_UNKNOWN = -2


def gate_verdicts(dep_idx, dep_counts):
    """Causal-gate verdicts for a whole delivery as one column program.

    ``dep_counts[i]`` is the number of deps of delivery entry ``i`` (entries
    are one doc's pending changes in arrival order); ``dep_idx`` is the flat
    int64 dep column — for each dep either the global entry index of the
    in-delivery change it names, ``DEP_COMMITTED`` for a dep already in the
    doc's change index, or ``DEP_UNKNOWN`` for a dep nobody has seen.

    Returns the int64 ``batch`` column: 0 = deferred (some dep chain ends in
    an unknown hash), else the 1-based gate round the entry commits in —
    exactly the round ``_gate_round`` would admit it, because the scalar
    gate scans pending in order and counts a same-round *earlier* entry as
    satisfied: ``batch[c] = max(1, max over deps d of
    (batch[d] + (d > c)))`` with committed deps contributing 1.

    The relaxation is a fixpoint sweep: batches only grow and the deferred
    set only grows among reachable entries, so ``n + 1`` sweeps always
    converge (each sweep settles at least one more entry of the longest
    dep chain)."""
    dep_idx = np.asarray(dep_idx, dtype=np.int64)
    dep_counts = np.asarray(dep_counts, dtype=np.int64)
    n = dep_counts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    owner = np.repeat(np.arange(n, dtype=np.int64), dep_counts)
    in_delivery = dep_idx >= 0
    unknown = dep_idx == DEP_UNKNOWN
    same_round_ok = dep_idx < owner  # earlier entry satisfies in-round
    batch = np.ones(n, dtype=np.int64)
    for rounds in range(1, n + 2):
        target = batch[np.maximum(dep_idx, 0)]
        dep_batch = np.where(
            in_delivery,
            target + np.where(same_round_ok, 0, 1),
            1,  # DEP_COMMITTED; DEP_UNKNOWN is masked out via `bad` below
        )
        bad_dep = unknown | (in_delivery & (target == 0))
        new = np.ones(n, dtype=np.int64)
        np.maximum.at(new, owner, dep_batch)
        bad = np.zeros(n, dtype=bool)
        np.logical_or.at(bad, owner, bad_dep)
        new[bad] = 0
        if np.array_equal(new, batch):
            break
        batch = new
    _M_GATE_ROUNDS.inc(rounds)
    return batch


def _host(a) -> np.ndarray:
    """A host array of `a`: a tensor is copied off its device."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


class BatchTranscoder:
    """Interns actors/(object, key) slots/values for one document batch and
    packs change ops into ChangeOpsBatch tensors."""

    def __init__(self):
        self.actors = _Interner(max_size=1 << ACTOR_BITS, name="actor")
        self.slots = _Interner(max_size=_MAX_SLOTS, name="slot")
        # amlint: disable=AM103 — value ids are payloads, never packed into
        # merge keys, so the table has no bit-field cap
        self.values = _Interner()
        self.object_types = {"_root": "map"}  # objectId -> map | table

    def pack_opid_str(self, op_id: str) -> int:
        p = parse_op_id(op_id)
        if p.counter >= _MAX_COUNTER:
            raise PackingLimitError(
                f"op counter {p.counter} exceeds the merge-key packing range"
            )
        return (p.counter << ACTOR_BITS) | self.actors.intern(p.actor_id)

    def slot_id(self, obj: str, key: str) -> int:
        return self.slots.intern((obj, key))

    def op_row(self, op: dict, op_counter: int, actor: str):
        """Converts one map-family change op dict (frontend format) into a
        dense row (slot, op, action, value, pred). Supports set/inc/del on
        maps and table rows, plus makeMap/makeTable child creation."""
        if op_counter >= _MAX_COUNTER:
            raise PackingLimitError(
                f"op counter {op_counter} exceeds the merge-key packing range"
            )
        packed_id = (op_counter << ACTOR_BITS) | self.actors.intern(actor)
        slot = self.slot_id(op.get("obj", "_root"), op["key"])
        pred = self.pack_opid_str(op["pred"][0]) if op.get("pred") else -1
        action = op["action"]
        if action == "set":
            if op.get("datatype") == "counter":
                return slot, packed_id, ACTION_SET, int(op["value"]), pred
            return slot, packed_id, ACTION_SET, self.values.intern(op.get("value")), pred
        if action in ("makeMap", "makeTable"):
            child_id = f"{op_counter}@{actor}"
            self.object_types[child_id] = "map" if action == "makeMap" else "table"
            value = self.values.intern(ChildRef(child_id))
            return slot, packed_id, ACTION_SET, value, pred
        if action == "inc":
            return slot, packed_id, ACTION_INC, int(op["value"]), pred
        if action == "del":
            return slot, packed_id, ACTION_DEL, 0, pred
        raise EncodeError(f"Unsupported op action for the dense engine: {action}")

    def changes_to_batch(self, per_doc_ops, width=None,
                         device="cuda") -> ChangeOpsBatch:
        """`per_doc_ops` is a list (one entry per document) of lists of
        (op_dict, op_counter, actor) tuples. Returns a padded ChangeOpsBatch
        on `device`: the card unless the caller asks for the CPU."""
        device = _require_device(device, "changes_to_batch")
        num_docs = len(per_doc_ops)
        if _M_ROWS.enabled:
            _M_ROWS.inc(sum(len(ops) for ops in per_doc_ops))
        m = width or max((len(ops) for ops in per_doc_ops), default=1) or 1
        keys = np.full((num_docs, m), PAD_KEY, np.int32)
        ops = np.zeros((num_docs, m), np.int64)
        actions = np.zeros((num_docs, m), np.int32)
        values = np.zeros((num_docs, m), np.int64)
        preds = np.full((num_docs, m), -1, np.int64)
        for d, doc_ops in enumerate(per_doc_ops):
            for i, (op, ctr, actor) in enumerate(doc_ops):
                keys[d, i], ops[d, i], actions[d, i], values[d, i], preds[d, i] = (
                    self.op_row(op, ctr, actor)
                )
        return changes_from_numpy(keys, ops, actions, values, preds, device)

    def decode_visible(self, keys, ops, winners, values, counter_slots=()):
        """Converts one document's per-row visibility rows (from
        batched_visible_state or ``BatchedMapEngine.visible_state``: tensors
        on any device, or host arrays) back into the document's Python
        tree, rooted at `_root`. `counter_slots` is the set of slot ids
        whose winning value is a raw counter total rather than an interned
        ref. Nested maps/table rows appear as nested dicts, reconstructed by
        following ChildRef winner values — the host-side analogue of the
        reference's objectMeta tree walk (new.js:1461, setupPatches)."""
        counter_slots = set(counter_slots)
        keys = _host(keys)
        winners = _host(winners)
        values = _host(values)
        # flat winner table: objectId -> {key: scalar | ChildRef}
        objects = {}
        for i in np.nonzero(winners)[0]:
            slot = int(keys[i])
            if slot == PAD_KEY:
                continue
            obj, key = self.slots.lookup(slot)
            if slot in counter_slots:
                value = int(values[i])
            else:
                value = self.values.lookup(int(values[i]))
            objects.setdefault(obj, {})[key] = value

        def build(object_id):
            out = {}
            for key, value in objects.get(object_id, {}).items():
                out[key] = build(value.object_id) if isinstance(value, ChildRef) else value
            return out

        return build("_root")

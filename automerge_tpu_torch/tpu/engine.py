"""Batched merge programs: the device half of the map/counter merge farm.

PyTorch counterpart of the JAX package's ``tpu/engine.py``. The reference
merge (mergeDocChangeOps, backend/new.js:1052) is a sequential two-pointer
walk per document; here the same result is a data-parallel tensor program
over a batch of documents:

  1. the small change batch of each document is sorted into canonical op
     order (key, opId counter, opId actor) and woven into the document's
     already-sorted op table by insertion position;
  2. succ/overwrite relationships resolve by a sorted lookup: an op is
     overwritten when a non-increment op names it in ``pred``;
  3. visibility = no non-increment successor; the winning value per key is
     the visible op with the greatest Lamport opId (segmented max over the
     sorted keys); counter increments accumulate onto their target set op
     instead of hiding it (new.js:937-965).

The JAX package writes each program for one document and vmaps it; here the
``[docs, width]`` batch dimension is written out and every op works along
dim 1. Padded rows carry ``key = PAD_KEY`` and sort to the end.

Two front ends share these programs: ``BatchedMapEngine`` keeps each
document's rows in pages of one slab (paging.py), and the dense
whole-state form (``BatchedDocState``, ``make_empty_state``,
``batched_apply_ops``, ``batched_visible_state``) keeps a fixed
``[docs, capacity]`` table, the engine-level API ``bench.py`` times.

These programs are plain XLA in the JAX package (no Pallas kernel), so
plain PyTorch ops are their port: stable argsort, ``searchsorted``,
``gather``, ``cummax``/``cummin`` and an int64 ``scatter_add_``. Where JAX
semantics differ from torch's they are reproduced explicitly (stable sorts,
clamped gathers, ``side="right"`` searches). One exception: on the card
the dense merge (``batched_apply_ops``) is one hand-written CUDA kernel,
``csrc/dense_merge.cu`` (``merge_kernels.py``), held bit for bit to
``merge_docs``, which stays the plain version, the CPU path and the paged
path's merge.

Lamport opIds are packed into one int64 as ``counter << 20 | actor_num``,
which preserves (counter, actor) order for up to 2^20 actors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs.flight import get_flight
from ..obs.metrics import get_metrics
from ..obs.prof import get_observatory
from ..testing.faults import fire as _fault_point
from .jitprof import profiled_program
from .merge_kernels import dense_merge

PAD_KEY = 2**31 - 1  # int32 max
ACTOR_BITS = 20
ACTOR_MASK = (1 << ACTOR_BITS) - 1

ACTION_SET = 0
ACTION_INC = 1
ACTION_DEL = 2

# Merge keys pack (key, opId) into one int64: key in the top 20 bits, the
# packed opId (counter << 20 | actor) in the low 44. Requires counter < 2^24.
_MKEY_OP_BITS = 44
_I64_MAX = 2**63 - 1
_I32_MAX = 2**31 - 1

_METRICS = get_metrics()
_M_DISPATCHES = _METRICS.counter(
    "engine.device.dispatches",
    "batched device programs dispatched (merge + visibility)",
)
_M_JIT_HITS = _METRICS.counter(
    "engine.jit.cache_hits",
    "dispatches at a shape bucket the program has dispatched before",
)
_M_JIT_RECOMPILES = _METRICS.counter(
    "engine.jit.recompiles",
    "dispatches at a shape bucket new to the program (obs/prof.py)",
)
_M_STATE_GROWS = _METRICS.counter(
    "engine.state.grows",
    "capacity doublings of the device op slab",
)

# flight-recorder hook (obs/flight.py): recompiles and slab growth are the
# two engine events worth a postmortem timeline entry — a steady-state
# recompile storm or a surprise slab doubling explains a latency cliff.
_FLIGHT = get_flight()

# amprof observatory (obs/prof.py): every program below registers a named
# ProfiledProgram via tpu/jitprof.py, so new shape buckets carry program
# identity and dispatches get per-program latency attribution.
_OBSERVATORY = get_observatory()


def _dispatch(prog, *args, **kwargs):
    """Runs a named profiled program (tpu/jitprof.py), classifying the
    call as a cache hit or a recompile by whether its shape bucket is new
    to the program (the torch meaning of a compile, obs/prof.py). This is
    the single device-dispatch funnel for the engine, so the
    recompile-storm and dispatch-count metrics cover every merge and
    visibility program. Per-program attribution (dispatch tallies, shape
    buckets, the ``engine.recompile`` flight event with program identity)
    lives in ``ProfiledProgram.call_profiled``; with both metrics and the
    observatory disabled this degrades to a plain call."""
    if not _METRICS.enabled and not _OBSERVATORY.enabled:
        return prog.fn(*args, **kwargs)
    out, grew, _dt = prog.call_profiled(args, kwargs)
    if _METRICS.enabled:
        _M_DISPATCHES.inc()
        if grew > 0:
            _M_JIT_RECOMPILES.inc(grew)
        else:
            _M_JIT_HITS.inc()
    return out


def pack_opid(counter, actor):
    """Packs (counter, actorNum) into one int64 preserving Lamport order."""
    counter = torch.as_tensor(counter, dtype=torch.int64)
    actor = torch.as_tensor(actor, dtype=torch.int64)
    return (counter << ACTOR_BITS) | actor


def unpack_opid(opid):
    return opid >> ACTOR_BITS, opid & ACTOR_MASK


def remap_opid_actors(opid, actor_rank):
    """Rebuilds packed opIds with the actor index replaced by its
    lexicographic rank, so int64 comparison == (counter, actorId-string)
    comparison (the reference's tie-break, new.js:146, apply_patch.js:33).
    Actor indexes past the table clamp to its last entry, as JAX's gather
    clamps."""
    counter = opid >> ACTOR_BITS
    actor = (opid & ACTOR_MASK).clamp(max=actor_rank.shape[0] - 1)
    rank = actor_rank.long()[actor]
    return (counter << ACTOR_BITS) | rank


def _require_device(device, entry: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry} runs on the card by default and CUDA is not "
            "available here; pass device='cpu' to run on the CPU"
        )
    return device


class BatchedDocState(NamedTuple):
    """Dense op storage for a batch of map documents: the whole-state
    form of the engine, without pages (``BatchedMapEngine`` pages it).

    All row tensors have shape [docs, capacity], sorted by (key, opId);
    padded slots have key == PAD_KEY and sort last. `overwritten` marks ops
    with at least one non-increment successor (the dense analogue of
    succNum > 0); `pred` is the packed opId each op overwrites/increments
    (-1 if none).
    """

    key: torch.Tensor          # int32 interned key id
    op: torch.Tensor           # int64 packed opId
    action: torch.Tensor       # int32 (ACTION_SET / ACTION_INC / ACTION_DEL)
    value: torch.Tensor        # int64 value payload (interned ref or small int)
    pred: torch.Tensor         # int64 packed opId, -1 if none
    overwritten: torch.Tensor  # bool
    num_ops: torch.Tensor      # int32 [docs] op rows merged so far


def make_empty_state(num_docs: int, capacity: int,
                     device="cuda") -> BatchedDocState:
    """An empty dense state of `num_docs` documents × `capacity` rows, on
    the card unless the caller asks for the CPU."""
    device = _require_device(device, "make_empty_state")
    shape = (num_docs, capacity)
    return BatchedDocState(
        key=torch.full(shape, PAD_KEY, dtype=torch.int32, device=device),
        op=torch.zeros(shape, dtype=torch.int64, device=device),
        action=torch.zeros(shape, dtype=torch.int32, device=device),
        value=torch.zeros(shape, dtype=torch.int64, device=device),
        pred=torch.full(shape, -1, dtype=torch.int64, device=device),
        overwritten=torch.zeros(shape, dtype=torch.bool, device=device),
        num_ops=torch.zeros((num_docs,), dtype=torch.int32, device=device),
    )


class ChangeOpsBatch(NamedTuple):
    """One batch of incoming change ops per document, shape [docs, m]."""

    key: torch.Tensor     # int32
    op: torch.Tensor      # int64
    action: torch.Tensor  # int32
    value: torch.Tensor   # int64
    pred: torch.Tensor    # int64, -1 if none


def changes_from_numpy(keys, ops, actions, values, preds,
                       device) -> ChangeOpsBatch:
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return ChangeOpsBatch(
        key=put(keys, torch.int32),
        op=put(ops, torch.int64),
        action=put(actions, torch.int32),
        value=put(values, torch.int64),
        pred=put(preds, torch.int64),
    )


def _merge_key(key, op):
    return torch.where(
        key == PAD_KEY,
        torch.full_like(op, _I64_MAX),
        (key.long() << _MKEY_OP_BITS) | op,
    )


def merge_docs(s_key, s_op, s_action, s_value, s_pred, s_over,
               c_key, c_op, c_action, c_value, c_pred):
    """Merges each document's change ops into its sorted op table: the
    batched form of the JAX package's ``_merge_one_doc`` (engine.py:181).
    State columns are ``[A, n]``, change columns ``[A, m]``; returns the six
    merged ``[A, n]`` columns.

    The state is invariant-sorted by (key, opId), so only the change batch
    is sorted: ``searchsorted`` gives each change op's slot, and every
    output row is built by a gather (output slot t holds new row k-1 if its
    insert position is t, else old row t - k, where k counts the new rows
    at or before t)."""
    a, n = s_key.shape
    m = c_key.shape[1]
    dev = s_key.device
    s_mkey = _merge_key(s_key, s_op)

    # sort the change ops into canonical order (jnp.argsort is stable)
    c_mkey = _merge_key(c_key, c_op)
    c_order = torch.argsort(c_mkey, dim=1, stable=True)
    c_mkey = c_mkey.gather(1, c_order)
    c_key = c_key.gather(1, c_order)
    c_op = c_op.gather(1, c_order)
    c_action = c_action.gather(1, c_order)
    c_value = c_value.gather(1, c_order)
    c_pred = c_pred.gather(1, c_order)

    pos = torch.searchsorted(s_mkey, c_mkey)
    new_pos = pos + torch.arange(m, dtype=torch.int64, device=dev)
    t = torch.arange(n, dtype=torch.int64, device=dev).expand(a, n).contiguous()
    k = torch.searchsorted(new_pos, t, right=True)
    new_idx = (k - 1).clamp(min=0)
    is_new = (k > 0) & (new_pos.gather(1, new_idx) == t)
    # JAX clamps out-of-range gathers; the discarded t - k = -1 lanes are
    # clamped here explicitly
    old_idx = (t - k).clamp(0, n - 1)

    def place(s_arr, c_arr):
        return torch.where(is_new, c_arr.gather(1, new_idx),
                           s_arr.gather(1, old_idx))

    out_key = place(s_key, c_key)
    out_op = place(s_op, c_op)
    out_action = place(s_action, c_action)
    out_value = place(s_value, c_value)
    out_pred = place(s_pred, c_pred)
    out_over = is_new.logical_not() & s_over.gather(1, old_idx)

    # succ resolution: a non-increment change op overwrites its pred
    # (increments keep the counter visible, new.js:937-965); the pred
    # shares the change op's key, so its row is found by merge key
    hides = (c_action != ACTION_INC) & (c_pred >= 0)
    hide_mkey = torch.where(
        hides,
        (c_key.long() << _MKEY_OP_BITS) | c_pred.clamp(min=0),
        torch.full_like(c_pred, _I64_MAX),
    ).sort(dim=1).values
    out_mkey = _merge_key(out_key, out_op)
    p = torch.searchsorted(hide_mkey, out_mkey).clamp(max=m - 1)
    out_over = out_over | (
        (hide_mkey.gather(1, p) == out_mkey) & (out_mkey != _I64_MAX)
    )
    return out_key, out_op, out_action, out_value, out_pred, out_over


def apply_ops_plain(state: BatchedDocState,
                    changes: ChangeOpsBatch) -> BatchedDocState:
    """The plain version of the dense merge: ``merge_docs`` over the whole
    table, then the merged columns copied into the state and the real
    change rows added to ``num_ops``. ``batched_apply_ops`` runs it for a
    state on the CPU; on the card it is what the kernel is held to."""
    merged = merge_docs(*state[:6], *changes)
    # JAX donates the state (donate_argnums=(0,)): here the merged
    # columns are written into the state's own tensors in place
    for column, out in zip(state[:6], merged):
        column.copy_(out)
    state.num_ops.add_((changes.key != PAD_KEY).sum(1, dtype=torch.int32))
    return state


@profiled_program("engine.apply_ops")
def _apply_ops(state: BatchedDocState,
               changes: ChangeOpsBatch) -> BatchedDocState:
    if state.key.device.type == "cpu":
        return apply_ops_plain(state, changes)
    return dense_merge(state, changes)


def batched_apply_ops(state: BatchedDocState,
                      changes: ChangeOpsBatch) -> BatchedDocState:
    """applyChanges over a whole document batch, one ``engine.apply_ops``
    dispatch: on the card one launch of the dense merge kernel
    (``merge_kernels.dense_merge``, which raises on what it does not
    take), on the CPU the plain version (``apply_ops_plain``). Updates
    `state` in place and returns it. Change rows that land past the
    capacity are dropped, as the JAX program drops them, and still count
    in ``num_ops``."""
    return _dispatch(_apply_ops, state, changes)


@profiled_program("engine.visible_cmp")
def visible_docs(key, op, action, value, pred, over, cmp):
    """Per-row visibility of each document: the batched form of the JAX
    package's ``_visible_state_one_doc`` (engine.py:260). All columns are
    ``[A, n]``; returns (key, op, visible, winner, value_total).

    - ``visible``: a set op with no non-increment successor;
    - ``winner``: the visible set op with the greatest ``cmp`` in its key;
    - ``value_total`` at a visible row: its value plus the live increments
      that target that row.

    A key run ends where the key differs from its right neighbour; each
    row's run end is a reversed cumulative min (flip/cummin/flip), and the
    per-run max rides one cummax by packing the ascending key into the
    high bits."""
    a, n = key.shape
    dev = key.device
    is_real = key != PAD_KEY
    is_set = is_real & (action == ACTION_SET)
    is_inc = is_real & (action == ACTION_INC)
    visible_set = is_set & over.logical_not()

    iota = torch.arange(n, dtype=torch.int64, device=dev).expand(a, n)
    is_end = torch.ones_like(is_real)
    is_end[:, :-1] = key[:, :-1] != key[:, 1:]
    ends = torch.where(is_end, iota, torch.full_like(iota, _I32_MAX))
    run_end = ends.flip(1).cummin(1).values.flip(1)

    packed = torch.where(
        visible_set, (key.long() << _MKEY_OP_BITS) | cmp,
        torch.full_like(cmp, -1),
    )
    run_max = packed.cummax(1).values.gather(1, run_end)
    winner = visible_set & (packed == run_max)

    # live increments: an inc is live iff its target set op (same key,
    # found by merge key) is not overwritten
    mkey = _merge_key(key, op)
    target_mkey = torch.where(
        is_inc & (pred >= 0),
        (key.long() << _MKEY_OP_BITS) | pred.clamp(min=0),
        torch.full_like(pred, _I64_MAX),
    )
    tpos = torch.searchsorted(mkey, target_mkey).clamp(max=n - 1)
    target_live = (mkey.gather(1, tpos) == target_mkey) & over.gather(
        1, tpos
    ).logical_not()
    inc_live = is_inc & target_live

    # per-target accumulation: jax.ops.segment_sum over target positions
    inc_vals = torch.where(inc_live, value, torch.zeros_like(value))
    row_inc = torch.zeros_like(value).scatter_add_(1, tpos, inc_vals)
    value_total = torch.where(visible_set, value + row_inc,
                              torch.zeros_like(value))
    return key, op, visible_set, winner, value_total


def batched_visible_state(state: BatchedDocState, actor_rank=None):
    """Materialises the visible state of every document: the device-side
    equivalent of documentPatch (new.js:1604). Returns per-row
    (key, op, visible, winner, value_total) tensors of shape
    [docs, capacity].

    `actor_rank` (int32[A], actor intern index -> lexicographic rank) makes
    counter-tied conflicts resolve on the actor id string exactly like the
    reference; without it, ties break on actor intern order."""
    if actor_rank is None:
        cmp = state.op
    else:
        rank = torch.as_tensor(actor_rank, dtype=torch.int32,
                               device=state.op.device)
        cmp = remap_opid_actors(state.op, rank)
    return _dispatch(visible_docs, *state[:6], cmp)


@profiled_program("engine.gather_rows")
def gather_rows(visible, totals, idx):
    """Row gather for the incremental readback path: `idx` is a flat
    tensor of ``doc * width + row`` indices."""
    return visible.reshape(-1)[idx], totals.reshape(-1)[idx]


_M_PAGES_ALLOC = _METRICS.gauge(
    "farm.pages.allocated", "slab pages currently owned by documents"
)
_M_PAGES_FREE = _METRICS.gauge(
    "farm.pages.free", "slab pages on the allocator free list"
)
_M_PAGES_OCC = _METRICS.gauge(
    "farm.pages.occupancy", "live op rows / allocated page cells"
)

# imported mid-module: paging.py needs the programs above, the engine class below
# needs paging's slab programs
from .paging import (  # noqa: E402
    PageAllocator,
    grow_slab,
    make_empty_slab,
    paged_adopt_rows,
    paged_apply_ops,
    paged_dense_view,
    paged_probe_ops,
    paged_visible_plain,
    paged_visible_ranked,
    patch_column_rows,
)


def _to_host(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


class BatchedMapEngine:
    """Host-side front end of the batched map/counter engine over ragged
    paged op storage (paging.py).

    Documents' op rows live in fixed-size pages of one shared device slab
    (per-doc page table + length on the host). A merge gathers only the
    ACTIVE documents' rows into a pow2-bucketed dense working view, runs
    the merge program, and writes the result back through the new page
    map. ``version`` counts committed merges; visibility results are
    memoised per (version, doc subset, actor rank) so repeated reads
    between merges cost one dispatch each."""

    def __init__(self, num_docs: int, capacity: int = 1024,
                 page_size: int | None = None, device="cuda"):
        import os

        self.device = torch.device(device)
        self.num_docs = num_docs
        self.capacity = capacity  # sizing hint; storage is paged
        # the dense working width never shrinks below the sizing hint and
        # ratchets up with the largest doc (stable pow2 shapes)
        self._width_floor = self._pow2(min(capacity, 1 << 13))
        page_size = page_size or int(os.environ.get("AM_PAGE_SIZE", "64"))
        hint_pages = (num_docs * min(capacity, 1 << 13)) // page_size
        self.pages = PageAllocator(
            page_size, initial_pages=max(4, min(hint_pages, 1 << 17))
        )
        self.slab = make_empty_slab(self.pages.num_pages * page_size,
                                    self.device)
        self.page_table: list[list] = [[] for _ in range(num_docs)]
        self.lengths = np.zeros(num_docs, np.int64)
        self.version = 0
        self._vis_memo: dict = {}

    @staticmethod
    def _pow2(n) -> int:
        return 1 << max(0, int(n) - 1).bit_length()

    def _width(self, needed: int) -> int:
        """Dense working width for `needed` rows: pow2-bucketed (never
        below one page) with the never-shrinking floor."""
        width = max(self._pow2(needed), self._width_floor,
                    self.pages.page_size)
        self._width_floor = width
        return width

    def _page_map(self, tables, width, a_pad, fill):
        """[a_pad, width / P] PAGE indices on the device: slot j of doc k
        names the slab page holding its rows [j*P, (j+1)*P), else `fill`
        (0 = the PAD page for gathers, num_pages = dropped for writes)."""
        npg = width // self.pages.page_size
        mat = np.full((a_pad, npg), fill, np.int64)
        for k, pt in enumerate(tables):
            n = min(len(pt), npg)
            if n:
                mat[k, :n] = pt[:n]
        return torch.from_numpy(mat).to(self.device)

    def _grow(self):
        self.slab = grow_slab(
            self.slab, self.pages.num_pages * self.pages.page_size
        )
        _M_STATE_GROWS.inc()

    def apply_batch(self, changes: ChangeOpsBatch, docs=None, counts=None):
        """Merges `changes` into the slab. `docs` names the documents the
        batch rows belong to (None = all docs); rows past ``len(docs)`` are
        pow2 padding. `counts` gives each doc's real (non-pad) row count —
        passed by the farm, derived from the batch otherwise."""
        _fault_point("engine.apply_batch", changes=changes)
        docs = (
            list(range(self.num_docs)) if docs is None
            else [int(d) for d in docs]
        )
        if not docs:
            return
        a_pad, m = changes.key.shape
        assert a_pad >= len(docs)
        if counts is None:
            counts = (changes.key != PAD_KEY).sum(1)[: len(docs)].cpu().numpy()
        counts = np.asarray(counts, np.int64)
        old_lens = self.lengths[docs]
        new_lens = old_lens + counts
        width = self._width(int(old_lens.max()) + m)

        old_tables = [self.page_table[d] for d in docs]
        gidx = self._page_map(old_tables, width, a_pad, fill=0)
        extra = [
            self.pages.pages_for(int(n)) - len(t)
            for n, t in zip(new_lens, old_tables)
        ]
        if self.pages.ensure(sum(e for e in extra if e > 0)):
            self._grow()
            # the merge path's event, as in the JAX engine (adopt_rows
            # grows the slab without one there too)
            if _FLIGHT.enabled:
                _FLIGHT.record("engine.slab.grow",
                               pages=self.pages.num_pages,
                               rows=self.pages.num_pages * self.pages.page_size)
        fresh: list = []
        new_tables = []
        for t, e in zip(old_tables, extra):
            if e > 0:
                pages = self.pages.alloc(e)
                fresh.extend(pages)
                new_tables.append(list(t) + pages)
            else:
                new_tables.append(list(t))
        dest = self._page_map(new_tables, width, a_pad,
                              fill=self.pages.num_pages)
        try:
            _dispatch(paged_apply_ops, self.slab, gidx, changes, dest,
                      page_size=self.pages.page_size)
        except Exception:
            # nothing committed: hand the delta pages back so a failed
            # dispatch leaks no slab capacity
            self.pages.free(fresh)
            raise
        for d, t, n in zip(docs, new_tables, new_lens):
            self.page_table[d] = t
            self.lengths[d] = int(n)
        self.version += 1
        self._vis_memo.clear()
        self._update_page_metrics()

    def probe_apply(self, changes: ChangeOpsBatch, docs, counts=None):
        """Runs the merge for `docs` on a throwaway basis (no write-back,
        no state advance): the probe for device-fault isolation."""
        docs = [int(d) for d in docs]
        a_pad, m = changes.key.shape
        lens = self.lengths[docs] if docs else np.zeros(0, np.int64)
        width = self._width((int(lens.max()) if docs else 0) + m)
        gidx = self._page_map([self.page_table[d] for d in docs], width,
                              a_pad, fill=0)
        out = paged_probe_ops(self.slab, gidx, changes,
                              page_size=self.pages.page_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def visible_state(self, actor_rank=None, docs=None):
        """Device-resident visibility for `docs` (None = every document):
        per-row (key, op, visible, winner, value_total) tensors of shape
        [len(docs), W], W = pow2 bucket of the largest requested doc.
        Memoised per (state version, doc subset, actor-rank table)."""
        _fault_point("engine.visible_state")
        docs_t = (
            tuple(range(self.num_docs)) if docs is None
            else tuple(int(d) for d in docs)
        )
        rank_key = (
            None if actor_rank is None else np.asarray(actor_rank).tobytes()
        )
        key = (docs_t, rank_key)
        hit = self._vis_memo.get(key)
        if hit is not None:
            return hit
        lens = (
            self.lengths[list(docs_t)] if docs_t else np.zeros(0, np.int64)
        )
        width = self._width(int(lens.max()) if len(lens) else 1)
        a_pad = self._pow2(len(docs_t))
        gidx = self._page_map([self.page_table[d] for d in docs_t], width,
                              a_pad, fill=0)
        if actor_rank is None:
            out = _dispatch(paged_visible_plain, self.slab, gidx,
                            page_size=self.pages.page_size)
        else:
            rank = torch.as_tensor(np.asarray(actor_rank),
                                   dtype=torch.int32).to(self.device)
            out = _dispatch(paged_visible_ranked, self.slab, gidx, rank,
                            page_size=self.pages.page_size)
        out = tuple(a[: len(docs_t)] for a in out)
        if len(self._vis_memo) > 16:
            self._vis_memo.clear()
        self._vis_memo[key] = out
        return out

    def _flat_index(self, plan, width):
        """Flat ``doc_position * width + row`` indices of a readback plan,
        pow2-padded; returns (device index tensor, real length)."""
        docs_t = tuple(sorted({p[0] for p in plan}))
        pos = {d: i for i, d in enumerate(docs_t)}
        flat = np.concatenate([pos[p[0]] * width + p[1] for p in plan])
        n = int(flat.shape[0])
        idx = np.zeros(self._pow2(n), np.int64)
        idx[:n] = flat
        return torch.from_numpy(idx).to(self.device), n

    def read_visibility_rows(self, plan, actor_rank=None):
        """Scoped device→host visibility readback: `plan` is a list of
        ``(doc, row_idx array)`` pairs; returns (visible, value_total)
        numpy arrays concatenated in plan order. Visibility is computed
        for ONLY the planned docs' rows, and one gather plus one copy move
        exactly the requested rows to the host."""
        plan = [
            (int(d), np.asarray(idx, np.int64))
            for d, idx in plan if len(idx)
        ]
        if not plan:
            return np.zeros(0, bool), np.zeros(0, np.int64)
        docs_t = tuple(sorted({d for d, _ in plan}))
        _k, _o, visible, _w, totals = self.visible_state(
            actor_rank, docs=docs_t
        )
        idx, n = self._flat_index(plan, visible.shape[1])
        v, t = _to_host(*_dispatch(gather_rows, visible, totals, idx))
        return v[:n], t[:n]

    def read_patch_columns(self, plan, actor_rank):
        """Scoped readback + device patch-column emission: `plan` is a
        list of ``(doc, row_idx array, cut array)`` triples, where `cut`
        holds each requested row's walk cutoff as a rank-packed int64
        (``-1`` = the row's slot is outside the delivery's cutoff set,
        int64 max = walk to the end of the key run). Returns
        (visible, value_total, emit) numpy arrays in plan order."""
        plan = [
            (int(d), np.asarray(idx, np.int64), np.asarray(cut, np.int64))
            for d, idx, cut in plan if len(idx)
        ]
        if not plan:
            return (
                np.zeros(0, bool), np.zeros(0, np.int64), np.zeros(0, bool)
            )
        docs_t = tuple(sorted({d for d, _, _ in plan}))
        _k, op, visible, _w, totals = self.visible_state(
            actor_rank, docs=docs_t
        )
        idx, n = self._flat_index(plan, visible.shape[1])
        cut = np.full(self._pow2(n), -1, np.int64)  # pad rows never emit
        cut[:n] = np.concatenate([c for _, _, c in plan])
        rank = torch.as_tensor(np.asarray(actor_rank),
                               dtype=torch.int32).to(self.device)
        v, t, e = _to_host(*_dispatch(
            patch_column_rows, visible, totals, op, rank, idx,
            torch.from_numpy(cut).to(self.device),
        ))
        return v[:n], t[:n], e[:n]

    def dense_view(self, docs=None):
        """Host copies of the six op columns as dense [D, W] arrays (the
        whole-state readback for export and parity checks)."""
        docs_t = (
            tuple(range(self.num_docs)) if docs is None
            else tuple(int(d) for d in docs)
        )
        lens = self.lengths[list(docs_t)] if docs_t else np.zeros(0, np.int64)
        width = self._width(int(lens.max()) if len(lens) else 1)
        gidx = self._page_map(
            [self.page_table[d] for d in docs_t], width,
            self._pow2(len(docs_t)), fill=0,
        )
        out = paged_dense_view(self.slab, gidx,
                               page_size=self.pages.page_size)
        return _to_host(*(a[: len(docs_t)] for a in out))

    def restore_doc(self, d: int, pages, length: int) -> None:
        """Rolls doc `d`'s page allocation back to a snapshot, returning
        pages acquired since to the free list. No device rows are
        rewritten: rollback always precedes the commit that would have
        used them."""
        keep = set(pages)
        self.pages.free([p for p in self.page_table[d] if p not in keep])
        self.page_table[d] = list(pages)
        self.lengths[d] = int(length)
        self._update_page_metrics()

    def adopt_rows(self, d: int, key, op, action, value, pred, over) -> None:
        """Installs a migrated document's op rows as doc `d`'s pages. Doc
        `d` must be empty; rows arrive as host arrays already translated
        into THIS engine's id space and sorted by merge key. Pages are
        allocated fresh and written whole; host padding keeps the
        page-tail invariant."""
        assert not self.page_table[d], "adopt_rows into an occupied doc"
        n = int(np.asarray(key).shape[0])
        self.lengths[d] = n
        self.version += 1
        self._vis_memo.clear()
        if n == 0:
            self._update_page_metrics()
            return
        P = self.pages.page_size
        npg = self.pages.pages_for(n)
        if self.pages.ensure(npg):
            self._grow()
        pages = self.pages.alloc(npg)
        npg_pad = self._pow2(npg)
        dest = np.full(npg_pad, self.pages.num_pages, np.int64)
        dest[:npg] = pages
        w = npg_pad * P

        def pad(col, fill, dtype):
            out = np.full(w, fill, dtype)
            out[:n] = col
            return torch.from_numpy(out).to(self.device)

        _dispatch(
            paged_adopt_rows, self.slab, torch.from_numpy(dest).to(self.device),
            pad(key, PAD_KEY, np.int32), pad(op, 0, np.int64),
            pad(action, 0, np.int32), pad(value, 0, np.int64),
            pad(pred, -1, np.int64), pad(over, False, np.bool_),
            page_size=P,
        )
        self.page_table[d] = pages
        self._update_page_metrics()

    def evict_doc(self, d: int) -> None:
        """Releases doc `d`'s pages to the free list and zeroes its length.
        No device rows are wiped: every write covers whole pages, so freed
        pages are fully overwritten at their next allocation."""
        self.pages.free(self.page_table[d])
        self.page_table[d] = []
        self.lengths[d] = 0
        self.version += 1
        self._vis_memo.clear()
        self._update_page_metrics()

    def _update_page_metrics(self) -> None:
        if not _METRICS.enabled:
            return
        allocated = self.pages.allocated
        _M_PAGES_ALLOC.set(allocated)
        _M_PAGES_FREE.set(self.pages.free_count)
        if allocated:
            _M_PAGES_OCC.set(
                float(self.lengths.sum()) / (allocated * self.pages.page_size)
            )

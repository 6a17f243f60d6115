"""Batched RGA ordering: document order as a parallel rank computation.

PyTorch counterpart of the JAX package's ``tpu/rga.py``. The reference
places a list element by a sequential scan: insert after the reference
element, skipping over existing elements with a greater opId
(backend/new.js:144-163). Because every element's opId exceeds its
parent's (causal delivery), that skip rule yields the depth-first preorder
of the insertion forest with each node's children in descending opId
order, which is computed here batched over documents with O(log E) depth:

  1. one stable sort groups siblings contiguously in descending-opId order
     (a packed (parent, ~opId) key);
  2. next sibling / first child come from neighbours and a left
     ``searchsorted`` in the sorted order;
  3. the next sibling of the nearest ancestor resolves by pointer doubling
     up the parent chain (``bit_length(E - 1)`` gather rounds);
  4. each node's DFS successor is its first child, else that ancestor
     sibling, giving the order as a linked list ranked by Wyllie's pointer
     doubling (one round more).

The JAX package writes the program for one document and vmaps it; here the
``[docs, E]`` axis is written out and every gather runs along dim 1
(``torch.gather`` in place of ``vmap``), with a sentinel column appended at
index E. These programs are plain XLA in the JAX package (no Pallas
kernel), so plain torch ops are their port.

Ties between equal counters break on the actor id string (new.js:146):
callers pass an ``actor_rank`` table and opIds are compared after
``remap_opid_actors``.
"""
from __future__ import annotations

import torch

from ..errors import PackingLimitError
from .engine import remap_opid_actors
from .jitprof import profiled_program

# Packed opIds are (counter << 20 | actor), 44 significant bits. The
# sibling-sort composite packs (parent+1) above them, so documents are
# limited to MAX_ELEMS elements (tombstones included) and op counters to
# 2^24; callers must guard (text_engine._grow_elems does).
_OP_BITS = 44
_OP_MASK = (1 << _OP_BITS) - 1
_I64_MAX = 2**63 - 1
MAX_ELEMS = 1 << 19
MAX_COUNTER = 1 << 24


def _rga_rank_docs(parent, opid, valid):
    """Ranks each document's elements in RGA document order: the batched
    form of the JAX package's ``_rga_rank_one_doc``.

    parent: int32[D, E] slot index of the insertion reference (-1 = head).
    opid:   int64[D, E] packed opId, already actor-rank-remapped for ties.
    valid:  bool[D, E].
    Returns int32[D, E]: 0-based document order; invalid slots get E.
    """
    docs, e = parent.shape
    dev = parent.device
    rounds = max(int(e - 1).bit_length(), 1)
    sent = e  # sentinel node: end of list / the virtual root's "no next"
    iota = torch.arange(e, dtype=torch.int64, device=dev).expand(docs, e)

    def with_sentinel(t):
        return torch.cat([t, t.new_full((docs, 1), sent)], dim=1)

    # 1. sibling sort: (parent asc, opId desc); pads share _I64_MAX, so the
    # sort must be stable (jnp.argsort is)
    comp = torch.where(
        valid,
        ((parent.long() + 1) << _OP_BITS) | (_OP_MASK - (opid & _OP_MASK)),
        torch.full_like(opid, _I64_MAX),
    )
    order = torch.argsort(comp, dim=1, stable=True)   # sorted pos -> slot
    comp_sorted = comp.gather(1, order)
    valid_row = valid.gather(1, order)
    parent_sorted = torch.where(
        valid_row, parent.long().gather(1, order), torch.full_like(order, -2)
    )
    inv_order = torch.empty_like(order).scatter_(1, order, iota.contiguous())

    # 2. neighbours in sorted space: the next sibling is the following row
    # when it shares the parent
    nxt_parent = torch.roll(parent_sorted, -1, dims=1)
    has_next_sib = (iota + 1 < e) & (nxt_parent == parent_sorted) & (
        parent_sorted != -2
    )
    next_sib = torch.where(has_next_sib, iota + 1, torch.full_like(iota, sent))

    # first child of slot s: leftmost sorted row whose parent key is s + 1
    pc = (comp_sorted >> _OP_BITS).contiguous()  # huge for pads
    want = (iota + 1).contiguous()
    fc_pos = torch.searchsorted(pc, want)  # side="left", as jnp's default
    has_child = (fc_pos < e) & (pc.gather(1, fc_pos.clamp(max=e - 1)) == want)
    first_child = torch.where(has_child, fc_pos, torch.full_like(fc_pos, sent))

    # 3. next sibling of the nearest ancestor by pointer doubling; res =
    # resolved successor (-1 = not yet), up = sorted pos of the parent
    parent_pos = torch.where(
        parent_sorted >= 0, inv_order.gather(1, parent_sorted.clamp(min=0)),
        torch.full_like(parent_sorted, sent),
    )
    res = torch.where(
        has_next_sib, next_sib,
        torch.where(parent_pos == sent, torch.full_like(parent_pos, sent),
                    torch.full_like(parent_pos, -1)),
    )
    res = with_sentinel(res)
    up = with_sentinel(parent_pos)
    for _ in range(rounds):
        res = torch.where(res == -1, res.gather(1, up), res)
        # res[up] may itself be -1: keep climbing
        up = torch.where(res == -1, up.gather(1, up), up)
    anc_next = res[:, :e]
    anc_next = torch.where(anc_next == -1, torch.full_like(anc_next, sent),
                           anc_next)

    # 4. DFS successor, then Wyllie list ranking
    fc_of_row = first_child.gather(1, order)
    succ = torch.where(fc_of_row != sent, fc_of_row, anc_next)
    succ = with_sentinel(
        torch.where(valid_row, succ, torch.full_like(succ, sent))
    )
    dist = torch.cat(
        [valid_row.to(torch.int32), torch.zeros(docs, 1, dtype=torch.int32,
                                                device=dev)], dim=1,
    )
    for _ in range(rounds + 1):
        dist, succ = dist + dist.gather(1, succ), succ.gather(1, succ)

    # dist[row] = number of elements from this row (inclusive) to the end
    n_valid = valid.sum(1, keepdim=True, dtype=torch.int32)
    rank_sorted = torch.where(
        valid_row, n_valid - dist[:, :e], torch.full_like(n_valid, e)
    )
    return rank_sorted.gather(1, inv_order).to(torch.int32)


@profiled_program("rga.rank")
def batched_rga_rank(parent, opid, valid, actor_rank):
    """Document-order ranks for a batch of list objects.

    parent: int32[docs, E] insertion-reference slot (-1 = head).
    opid:   int64[docs, E] packed opIds (counter << 20 | actor intern index).
    valid:  bool[docs, E].
    actor_rank: int32[A] lexicographic rank per actor intern index.
    All four on one device. Returns int32[docs, E] ranks; invalid slots
    get E."""
    if parent.shape[-1] > MAX_ELEMS:
        raise PackingLimitError(
            f"document element table exceeds the rank kernel's "
            f"MAX_ELEMS={MAX_ELEMS}; the sibling-sort key packing would "
            "overflow int64"
        )
    remapped = remap_opid_actors(opid.long(), actor_rank)
    return _rga_rank_docs(parent, remapped, valid)


def patch_emit_columns(visible, lam, cut):
    """Patch-emit mask: a gathered row lands in the patch iff it is visible
    (visibility implies a live SET row — DEL/INC rows never win) and its
    rank-remapped lamport key is within its slot's walk cutoff. ``cut``
    carries the cutoff per gathered row as an int64: ``-1`` = the row's
    slot is outside this delivery's cutoff set, int64 max = walk to the
    end of the key run."""
    return visible & (lam <= cut) & (cut >= 0)

"""Ragged paged op storage for the merge farm.

PyTorch counterpart of the JAX package's ``tpu/paging.py``. Op rows live
in fixed-size pages of one shared slab; each document owns a page list and
a row count, and the programs address the slab through host-built page
maps:

    page_map[a, j] = page_table[doc_a][j]    (j < pages of doc a)
                   = 0                       (gather: the PAD page)
                   = num_pages               (write: dropped)

Page 0 is the reserved PAD page: its rows hold PAD values forever, so
gathers of dead pages produce pad rows without branching, and writes never
target it.

Gathers and writes move whole pages. Correctness rests on the page-tail
invariant: rows of a page beyond its document's length always hold PAD
values. Fresh pages start PAD (make_empty_slab/grow_slab), and every write
covers full pages whose tail rows carry the merge program's PAD output, so
gathering a doc's pages yields exactly the dense ``[len | PAD...]`` view the
programs expect.

Where the JAX package donates the slab to a program and scatters with
``mode="drop"``, the port writes the slab's columns in place and masks the
dropped page ids (``dest == num_pages``) out of the write.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .engine import PAD_KEY, merge_docs, remap_opid_actors, visible_docs
from .jitprof import profiled_program


class SlabState(NamedTuple):
    """One shared op slab: flat ``[num_pages * page_size]`` columns."""

    key: torch.Tensor          # int32 interned key id (PAD_KEY when dead)
    op: torch.Tensor           # int64 packed opId
    action: torch.Tensor       # int32
    value: torch.Tensor        # int64
    pred: torch.Tensor         # int64 (-1 none)
    overwritten: torch.Tensor  # bool


_FILLS = (
    (PAD_KEY, torch.int32),
    (0, torch.int64),
    (0, torch.int32),
    (0, torch.int64),
    (-1, torch.int64),
    (False, torch.bool),
)


def make_empty_slab(rows: int, device) -> SlabState:
    return SlabState(*(
        torch.full((rows,), fill, dtype=dtype, device=device)
        for fill, dtype in _FILLS
    ))


def grow_slab(slab: SlabState, rows: int) -> SlabState:
    """Extends the slab to `rows` total rows (new rows are PAD)."""
    pad = rows - slab.key.shape[0]
    if pad <= 0:
        return slab
    return SlabState(*(
        torch.cat([col, torch.full((pad,), fill, dtype=dtype,
                                   device=col.device)])
        for col, (fill, dtype) in zip(slab, _FILLS)
    ))


class PageAllocator:
    """Host-side free list of fixed-size pages. Page 0 is the reserved PAD
    page and is never handed out. Doubling `num_pages` signals the caller
    to grow the device slab (ensure() returns True when that happened)."""

    __slots__ = ("page_size", "num_pages", "_free")

    def __init__(self, page_size: int = 64, initial_pages: int = 64):
        assert page_size > 0 and (page_size & (page_size - 1)) == 0, (
            "page_size must be a power of two (working widths are pow2-"
            "bucketed and page-aligned)"
        )
        self.page_size = page_size
        self.num_pages = max(2, initial_pages)
        self._free = list(range(self.num_pages - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        """Pages currently owned by documents (PAD page excluded)."""
        return self.num_pages - 1 - len(self._free)

    def pages_for(self, rows: int) -> int:
        return -(-rows // self.page_size)

    def ensure(self, n: int) -> bool:
        """Guarantees `n` free pages, growing the slab in ONE pow2 jump (at
        least a doubling) when short, so growth events stay logarithmic.
        Returns True when `num_pages` changed (caller grows the slab)."""
        if len(self._free) >= n:
            return False
        needed_total = self.num_pages + n - len(self._free)
        old = self.num_pages
        self.num_pages = max(
            1 << (needed_total - 1).bit_length(), old * 2
        )
        self._free.extend(range(self.num_pages - 1, old - 1, -1))
        return True

    def alloc(self, n: int) -> list:
        assert len(self._free) >= n, "alloc without ensure"
        taken = self._free[len(self._free) - n:]
        del self._free[len(self._free) - n:]
        return taken[::-1]

    def free(self, pages) -> None:
        self._free.extend(pages)


def _gather_pages(slab: SlabState, page_idx, page_size: int):
    a = page_idx.shape[0]
    return tuple(
        col.view(-1, page_size)[page_idx].reshape(a, -1) for col in slab
    )


def _write_pages(slab: SlabState, dest_pages, cols, page_size: int) -> None:
    """Writes whole pages of `cols` (each ``[..., page_size]``-divisible)
    to the slab pages named by `dest_pages`, in place. Ids equal to the
    slab's page count are dropped, as JAX's ``.at[].set(mode="drop")``
    drops out-of-range scatters."""
    dest = dest_pages.reshape(-1)
    num_pages = slab.key.shape[0] // page_size
    keep = dest < num_pages
    dest = dest[keep]
    for col, vals in zip(slab, cols):
        col.view(-1, page_size)[dest] = vals.reshape(-1, page_size)[keep]


@profiled_program("paging.apply_ops")
def paged_apply_ops(slab: SlabState, gather_pages, changes, dest_pages, *,
                    page_size: int) -> SlabState:
    """applyChanges over the active documents: gather their pages, merge
    the change batch, and write every merged page to its new slot. The
    slab is updated in place (the JAX program donates it instead); the
    gather copies first, so sources may be overwritten."""
    merged = merge_docs(*_gather_pages(slab, gather_pages, page_size),
                        *changes)
    _write_pages(slab, dest_pages, merged, page_size)
    return slab


@profiled_program("paging.probe_ops")
def paged_probe_ops(slab: SlabState, gather_pages, changes, *,
                    page_size: int):
    """The merge WITHOUT the write-back: probes run a suspect subset
    against the live slab on a throwaway basis — the slab never changes."""
    return merge_docs(*_gather_pages(slab, gather_pages, page_size),
                      *changes)


@profiled_program("paging.visible_plain")
def paged_visible_plain(slab: SlabState, gather_pages, *, page_size: int):
    key, op, action, value, pred, over = _gather_pages(
        slab, gather_pages, page_size
    )
    # the bare function: the JAX paged programs run the per-doc visibility
    # unprofiled, so a paged dispatch is no engine.visible_cmp dispatch
    return visible_docs.fn(key, op, action, value, pred, over, op)


@profiled_program("paging.visible_ranked")
def paged_visible_ranked(slab: SlabState, gather_pages, actor_rank, *,
                         page_size: int):
    key, op, action, value, pred, over = _gather_pages(
        slab, gather_pages, page_size
    )
    cmp = remap_opid_actors(op, actor_rank)
    return visible_docs.fn(key, op, action, value, pred, over, cmp)


@profiled_program("paging.patch_column_rows")
def patch_column_rows(visible, totals, op, actor_rank, idx, cut):
    """Row gather + patch emission for the scoped readback: `visible`,
    `totals`, `op` are the paged visibility outputs (``[A_pad, W]``), `idx`
    flat ``doc * W + row`` indices, `cut` each row's walk cutoff as a
    rank-packed int64 (``-1`` = never emit, int64 max = walk to the end
    of the key run). Returns (visible, totals, emit) rows."""
    from .rga import patch_emit_columns  # rga imports engine: bind lazily

    v = visible.reshape(-1)[idx]
    t = totals.reshape(-1)[idx]
    lam = remap_opid_actors(op.reshape(-1)[idx], actor_rank)
    return v, t, patch_emit_columns(v, lam, cut)


@profiled_program("paging.dense_view")
def paged_dense_view(slab: SlabState, gather_pages, *, page_size: int):
    """Dense [D, W] gather of all six columns."""
    return _gather_pages(slab, gather_pages, page_size)


@profiled_program("paging.adopt_rows")
def paged_adopt_rows(slab: SlabState, dest_pages, key, op, action, value,
                     pred, over, *, page_size: int) -> SlabState:
    """Installs externally prepared rows (a migrated document) into freshly
    allocated pages, in place. The row columns arrive host-padded to
    ``len(dest_pages) * page_size`` with PAD fills, so every written page
    keeps the page-tail invariant."""
    _write_pages(slab, dest_pages, (key, op, action, value, pred, over),
                 page_size)
    return slab

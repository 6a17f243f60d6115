"""List-order helpers of the device engine.

PyTorch counterpart of the part of the JAX package's ``tpu/rga.py`` that
the map/counter path needs: the patch-emit mask used by the scoped
readback. The batched RGA rank program (``batched_rga_rank``) belongs to
the list/text slice and is not ported yet.
"""
from __future__ import annotations


def patch_emit_columns(visible, lam, cut):
    """Patch-emit mask: a gathered row lands in the patch iff it is visible
    (visibility implies a live SET row — DEL/INC rows never win) and its
    rank-remapped lamport key is within its slot's walk cutoff. ``cut``
    carries the cutoff per gathered row as an int64: ``-1`` = the row's
    slot is outside this delivery's cutoff set, int64 max = walk to the
    end of the key run."""
    return visible & (lam <= cut) & (cut >= 0)

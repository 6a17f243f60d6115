"""The bytes the port's device RGA rank (``tpu/rga.py``'s
``batched_rga_rank``, which orders one document's list elements for a
whole-document read) must move, for ``metrics/text.rga_rank_roofline``.

A ranked element's parent index (int32) and packed op id (int64) are read
once and its rank (int32) written once: 16 bytes. Padding (the rank runs
over a power-of-two width) is not counted."""
from __future__ import annotations

RGA_ELEM_BYTES = 16


def rga_rank_bytes(elems: int) -> int:
    """Ranks of `elems` list elements (tombstones included), summed over
    the documents ranked."""
    return elems * RGA_ELEM_BYTES

"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W
power limit), the least time of the two Bloom kernels, frozen copies of
``chip_smoke.build_bound`` and ``query_bound``, and the bytes the dense
engine's merge and visibility pass must move.

A bound counts each input byte read once and each output byte written
once, and the operations the probes need, for the live entries only;
the least time is the larger of bytes over the memory rate and operations
over the rate outside the tensor cores."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
NUM_PROBES = 7                 # backend/sync.js
PROBE_OPS_BUILD = 5            # per probe: two adds, two modulos, one OR
PROBE_OPS_QUERY = 6            # per probe: adds, modulos, shift, AND


def _least_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / NON_TENSOR_OPS_PER_S) * 1e3


def build_bound_ms(batch: int, entries: int, num_words: int, counts) -> float:
    """``bloom_build`` over xyz [batch, entries, 3] with `counts` (a
    sequence of ints) live entries per filter of `num_words` words."""
    live = sum(min(max(int(c), 0), entries) for c in counts)
    nbytes = live * 12 + batch * 4 + batch * num_words * 4 + batch * 4
    return _least_ms(nbytes, live * NUM_PROBES * PROBE_OPS_BUILD)


def query_bound_ms(batch: int, num_words: int, cands: int, counts) -> float:
    """``bloom_query`` of [batch, cands] candidates against filters of
    `num_words` words, `counts` entries each (a filter with none answers
    without a read)."""
    live = sum(1 for c in counts if int(c) > 0)
    nbytes = batch * 8 + live * (num_words * 4 + cands * 12) + batch * cands
    return _least_ms(nbytes, live * cands * NUM_PROBES * PROBE_OPS_QUERY)


# the dense engine's rows (tpu/engine.py's BatchedDocState): key 4, op 8,
# action 4, value 8, pred 8, overwritten 1; a change row: the first five
DENSE_ROW_BYTES = 33
DENSE_CHANGE_BYTES = 32
# a visibility pass reads key, op, action, value and overwritten of a row
# (a pred only for an increment, which the dense traffic has none of) and
# writes visible 1, winner 1 and value_total 8; it hands back the state's
# own key and op
VISIBLE_READ_BYTES = 25
VISIBLE_WRITE_BYTES = 10


def least_ms(nbytes) -> float:
    """The least time to move `nbytes` through the card's memory."""
    return _least_ms(nbytes, 0)


def dense_merge_bytes(held: int, new: int) -> int:
    """One ``batched_apply_ops`` of `new` change rows into documents that
    hold `held` rows (both summed over the documents): the live rows read,
    the live rows after it written (the table stays sorted, so the rows
    behind an insert move), the change rows read. Padding is not
    counted."""
    return (2 * held + new) * DENSE_ROW_BYTES + new * DENSE_CHANGE_BYTES


def dense_visibility_bytes(rows: int) -> int:
    """One ``batched_visible_state`` over documents holding `rows` live
    rows (summed over the documents)."""
    return rows * (VISIBLE_READ_BYTES + VISIBLE_WRITE_BYTES)

"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W
power limit) and the least time of the two Bloom kernels, frozen copies of
``chip_smoke.build_bound`` and ``query_bound``.

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

"""profiled_program — names a device program on the port's observatory.

The counterpart of the JAX package's ``tpu/jitprof.py`` (``profiled_jit``).
PyTorch runs these programs eagerly, so nothing is jitted here: the
decorator only registers the plain function on the observatory
(``obs/prof.py``) under a stable name, which gives every dispatch a
program identity, a per-program dispatch count and latency, and the
shape buckets that count as its compiles (``obs/prof.py`` says what a
compile means here). With the observatory disabled a call costs one
attribute read and a branch more than the bare function.

Names follow the JAX program each function stands for, so that
``obs/export.program_table`` sets the two packages side by side; the CUDA
kernel wrappers take ``kernel.*`` where the JAX package has ``pallas.*``.
The farm's Bloom filter programs are those kernels, so each ``sync.*``
filter name is bound to its kernel's program: one set of tallies, listed
under both names, and each launch is counted once. Its count is the JAX
package's ``sync.*`` and ``pallas.*`` counts together.

=====================================  ==========================================
JAX program (``automerge_tpu/``)       port (``automerge_tpu_torch/``)
=====================================  ==========================================
``engine.apply_ops`` (engine.py:248)   ``engine.batched_apply_ops`` (the dense
                                       whole-state merge: on the card the
                                       kernel of ``csrc/dense_merge.cu``,
                                       which has no ``kernel.*`` program of
                                       its own; ``engine.merge_docs``,
                                       the batched merge, also runs inside
                                       ``paging.apply_ops`` and
                                       ``paging.probe_ops``). The JAX
                                       ``_grow_state`` has no caller there and
                                       no port
``engine.visible_cmp`` (:324)          ``engine.visible_docs``
``engine.gather_rows`` (:350)          ``engine.gather_rows``
``paging.apply_ops`` (paging.py:160)   ``paging.paged_apply_ops``
``paging.probe_ops`` (:194)            ``paging.paged_probe_ops``
``paging.visible_plain`` (:209)        ``paging.paged_visible_plain``
``paging.visible_ranked`` (:217)       ``paging.paged_visible_ranked``
``paging.patch_column_rows`` (:227)    ``paging.patch_column_rows``
``paging.dense_view`` (:247)           ``paging.paged_dense_view``
``paging.adopt_rows`` (:253)           ``paging.paged_adopt_rows``
``sync.build_filters``                 ``sync_batch.build_filters``: the
(sync_batch.py:91)                     ``kernel.bloom_build`` program under a
                                       second name (``Observatory.alias``)
``sync.query_filters`` (:118)          ``sync_batch.query_filters``: the
                                       ``kernel.bloom_query`` program, aliased
``sync.fingerprint_ranges``            ``fingerprint.reduce_ranges``
(fingerprint.py:51)
``rga.rank`` (rga.py:152)              ``rga.batched_rga_rank``
``pallas.bloom_build``                 ``kernel.bloom_build``:
(pallas_kernels.py:257)                ``bloom_kernels.bloom_build``
``pallas.bloom_query`` (:112)          ``kernel.bloom_query``:
                                       ``bloom_kernels.bloom_query``
``pallas.leb128_segment_sum`` (:220)   ``kernel.leb128_segment_sum``:
                                       ``leb_kernels.leb128_segment_sum``
=====================================  ==========================================

Usage::

    @profiled_program("paging.apply_ops")
    def paged_apply_ops(slab, ...):
        ...
"""
from __future__ import annotations

from ..obs.prof import ProfiledProgram, get_observatory


def profiled_program(name: str):
    """Decorator: registers ``fn`` on the process observatory under
    ``name``. Returns the :class:`ProfiledProgram` wrapper (calls fall
    through to ``fn`` while the observatory is disabled; ``.fn`` is the
    bare function)."""

    def wrap(fn) -> ProfiledProgram:
        return get_observatory().register(name, fn)

    return wrap

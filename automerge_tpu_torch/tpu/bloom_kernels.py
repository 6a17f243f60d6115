"""Bloom filter build and query kernels for batched sync.

Hopper counterparts of the JAX package's Pallas kernels
(``tpu/pallas_kernels.py``: ``bloom_build`` and ``bloom_query``), written in
CUDA C++ in ``csrc/bloom.cu`` (see the note there for the design and what
bounds them). Each wrapper here checks its inputs, allocates its outputs
and launches the kernel on the current stream when the tensors lie on the
card; for tensors on the CPU it runs the plain PyTorch version beside it,
which the CPU tests hold against the JAX package.

Hash words are uint32 bit patterns carried in int32 tensors (torch's
uint32 lacks add, shift and modulo on the CPU): ``np.uint32`` arrays enter
with ``.view(np.int32)``, the kernels read them as uint32, and the plain
versions widen to int64 and wrap each add at 2^32 before the modulo,
exactly as JAX's uint32 arithmetic does.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import check_tensor as _check
from ..kernels import load, stream_ptr
from ..sync import BITS_PER_ENTRY, NUM_PROBES
from .jitprof import profiled_program

WORD_BITS = 32
_U32 = 0xFFFFFFFF

#: launches of each kernel on the card (the CPU path never counts)
LAUNCHES = {"bloom_build": 0, "bloom_query": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def filter_modulo(counts):
    """Bit size of a filter with the given entry count (sync.js:45):
    ``8 * ceil(counts * 10 / 8)``, int32."""
    c = counts.long()
    return (8 * ((c * BITS_PER_ENTRY + 7) // 8)).to(torch.int32)


def _to_i32_bits(v):
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def _probes(xyz, modulo):
    """[NUM_PROBES, B, N] int64 probe positions; xyz [B, N, 3] int32 bits,
    modulo [B] int32 read as uint32 (JAX's ``maximum(modulo.astype(uint32),
    1)``, sync_batch.py:73)."""
    m = (modulo.long() & _U32).clamp(min=1)[:, None]
    u = xyz.long() & _U32
    x, y, z = u[..., 0] % m, u[..., 1] % m, u[..., 2] % m
    out = [x]
    for _ in range(NUM_PROBES - 1):
        x = ((x + y) & _U32) % m
        y = ((y + z) & _U32) % m
        out.append(x)
    return torch.stack(out)


def bloom_build_plain(xyz, counts, num_words: int):
    """Plain version of the build kernel. xyz [B, E, 3] int32 (uint32
    bits), counts [B] int32 -> (words [B, num_words] int32 bits,
    modulo [B] int32)."""
    batch, width, _ = xyz.shape
    modulo = filter_modulo(counts)
    p = _probes(xyz, modulo)  # [P, B, E]
    live = torch.arange(width, dtype=torch.int64, device=xyz.device)[None, :] < counts.long()[:, None]
    keep = live[None] & (p < num_words * WORD_BITS)
    b_idx = torch.arange(batch, dtype=torch.int64, device=xyz.device)[None, :, None].expand_as(p)
    bits = torch.zeros(batch, num_words * WORD_BITS, dtype=torch.bool,
                       device=xyz.device)
    bits[b_idx[keep], p[keep]] = True
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=xyz.device)
    weights = weights << torch.arange(WORD_BITS, dtype=torch.int64,
                                     device=xyz.device)
    words = (bits.view(batch, num_words, WORD_BITS).long() * weights).sum(-1)
    return _to_i32_bits(words), modulo


def bloom_query_plain(words, modulo, counts, query_xyz):
    """Plain version of the query kernel. words [B, W] int32 bits, modulo
    and counts [B] int32, query_xyz [B, C, 3] int32 bits -> [B, C] bool."""
    batch, num_words = words.shape
    p = _probes(query_xyz, modulo)  # [P, B, C]
    w_idx = (p // WORD_BITS).clamp(max=num_words - 1)
    row = (words.long() & _U32)[None].expand(NUM_PROBES, batch, num_words)
    got = torch.gather(row, 2, w_idx)
    bit = (got >> (p % WORD_BITS)) & 1
    return (bit == 1).all(0) & (counts[:, None] > 0)


def _lib():
    lib = load("bloom")
    if not getattr(lib, "_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bloom_build_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, vp]
        lib.bloom_build_launch.restype = ci
        lib.bloom_query_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.bloom_query_launch.restype = ci
        for fn in (lib.bloom_smem_limit, lib.bloom_sm_count):
            fn.argtypes = [ci]
            fn.restype = ci
        lib.bloom_build_plan.argtypes = [ci] * 5
        lib.bloom_build_plan.restype = ci
        lib._bound = True
    return lib


#: device index -> (shared-memory opt-in limit per block, SM count), read
#: once per device per process
_DEVICE_LIMITS: dict[int, tuple[int, int]] = {}


def _device_limits(lib, device: int) -> tuple[int, int]:
    limits = _DEVICE_LIMITS.get(device)
    if limits is None:
        limits = _DEVICE_LIMITS[device] = (lib.bloom_smem_limit(device),
                                           lib.bloom_sm_count(device))
    return limits


def build_plan(batch: int, num_entries: int, num_words: int,
               device: int = 0) -> int:
    """How ``bloom_build`` launches on card `device` at this shape: 0 =
    the packed kernel; k >= 1 = the split kernel on clusters of k blocks
    (1 = one block per filter, no cluster). The rule is the launcher's
    own (``bloom_build_plan`` in ``csrc/bloom.cu``)."""
    lib = _lib()
    return lib.bloom_build_plan(batch, num_entries, num_words,
                                *_device_limits(lib, device))


@profiled_program("kernel.bloom_build")
def bloom_build(xyz, counts, num_words: int):
    """Builds B Bloom filters: xyz [B, E, 3] int32 (uint32 bits), counts
    [B] int32 -> (words [B, num_words] int32 bits, modulo [B] int32; two
    views of one buffer). Launches ``bloom_build_packed_kernel`` or
    ``bloom_build_split_kernel`` for card tensors, the plain version for
    CPU tensors."""
    if xyz.device.type == "cpu":
        return bloom_build_plain(xyz, counts, num_words)
    batch, width, _ = xyz.shape
    _check("xyz", xyz, torch.int32, (batch, width, 3))
    _check("counts", counts, torch.int32, (batch,))
    if counts.device != xyz.device:
        raise ValueError("xyz and counts must be on one device")
    if num_words < 1:
        raise ValueError("num_words must be positive")
    lib, dev = _lib(), xyz.get_device()
    smem_limit, num_sms = _device_limits(lib, dev)
    if num_words * 4 > smem_limit:
        raise ValueError(
            f"a {num_words}-word filter row ({num_words * 4} bytes) does not "
            "fit in one block's shared memory"
        )
    out = torch.empty(batch * (num_words + 1), dtype=torch.int32,
                      device=xyz.device)
    words = out[: batch * num_words].view(batch, num_words)
    modulo = out[batch * num_words:]
    if batch == 0:
        return words, modulo
    err = lib.bloom_build_launch(
        xyz.data_ptr(), counts.data_ptr(), words.data_ptr(),
        modulo.data_ptr(), batch, width, num_words, smem_limit, num_sms,
        stream_ptr(dev),
    )
    if err:
        raise RuntimeError(f"bloom_build launch failed: CUDA error {err}")
    LAUNCHES["bloom_build"] += 1
    return words, modulo


@profiled_program("kernel.bloom_query")
def bloom_query(words, modulo, counts, query_xyz):
    """Tests C candidate hashes against each of B filters: words [B, W]
    int32 bits, modulo and counts [B] int32, query_xyz [B, C, 3] int32
    bits -> contained [B, C] bool (False for empty filters). Launches
    ``bloom_query_kernel`` for card tensors, the plain version for CPU
    tensors."""
    if words.device.type == "cpu":
        return bloom_query_plain(words, modulo, counts, query_xyz)
    batch, num_words = words.shape
    cand = query_xyz.shape[1]
    _check("words", words, torch.int32, (batch, num_words))
    _check("modulo", modulo, torch.int32, (batch,))
    _check("counts", counts, torch.int32, (batch,))
    _check("query_xyz", query_xyz, torch.int32, (batch, cand, 3))
    if len({t.device for t in (words, modulo, counts, query_xyz)}) != 1:
        raise ValueError("bloom_query inputs must be on one device")
    if num_words < 1:
        raise ValueError("filters need at least one word")
    out = torch.empty(batch, cand, dtype=torch.bool, device=words.device)
    if batch * cand == 0:
        return out
    err = _lib().bloom_query_launch(
        words.data_ptr(), modulo.data_ptr(), counts.data_ptr(),
        query_xyz.data_ptr(), out.data_ptr(), batch, cand, num_words,
        stream_ptr(words.get_device()),
    )
    if err:
        raise RuntimeError(f"bloom_query_kernel launch failed: CUDA error {err}")
    LAUNCHES["bloom_query"] += 1
    return out

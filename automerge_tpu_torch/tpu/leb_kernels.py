"""Segmented payload-plane sum of the device LEB128 scan.

Hopper counterpart of the JAX package's Pallas kernel
``tpu/pallas_kernels.py: leb128_segment_sum``, written in CUDA C++ in
``csrc/leb128.cu`` (see the note there for the design and what bounds it).
The wrapper checks its inputs, allocates the output and a flag word and
launches the kernels (a sorted pass, then a general pass that runs only
when the sorted pass found a descending pair of ids) on the current
stream when the tensors lie on the card; for tensors
on the CPU it runs the plain PyTorch version beside it, which the CPU tests
hold against the Pallas kernel in interpret mode.
"""
from __future__ import annotations

import ctypes
import itertools

import torch

from ..kernels import check_tensor, load, stream_ptr
from .jitprof import profiled_program

#: launches of the kernel on the card (the CPU path never counts)
LAUNCHES = {"leb128_segment_sum": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def leb128_segment_sum_plain(planes, seg_ids, num_segments: int):
    """Plain version of the kernel: planes [N, P] float32, seg_ids [N]
    int32 -> out [num_segments, P] float32 with ``out[v, p] = sum of
    planes[i, p] over seg_ids[i] == v``; ids outside [0, num_segments)
    are dropped."""
    out = torch.zeros(num_segments, planes.shape[1], dtype=torch.float32,
                      device=planes.device)
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    return out.index_add_(0, seg_ids[keep].long(), planes[keep])


def _lib():
    lib = load("leb128")
    if not getattr(lib, "_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.leb128_segment_sum_launch.argtypes = [
            vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp,
        ]
        lib.leb128_segment_sum_launch.restype = ci
        lib._bound = True
    return lib


_CALLS = itertools.count()


def _next_gen() -> int:
    """This call's flag generation: an int32 quiet-NaN bit pattern
    (0x7FC00000 and up), which no id, plane or sum of the scan holds;
    see the note in ``csrc/leb128.cu``."""
    return 0x7FC00000 | (next(_CALLS) & 0x3FFFFF)


def _segment_sum(planes, seg_ids, num_segments: int):
    """(out, flag, gen): the kernel's output, its flag word and this call's
    generation (``flag == gen`` after the call when the ids were not
    sorted and the general pass ran); (plain output, None, None) for CPU
    tensors."""
    if planes.device.type == "cpu":
        return leb128_segment_sum_plain(planes, seg_ids, num_segments), \
            None, None
    n, p = planes.shape
    check_tensor("planes", planes, torch.float32, (n, p))
    check_tensor("seg_ids", seg_ids, torch.int32, (n,))
    if seg_ids.device != planes.device:
        raise ValueError("planes and seg_ids must be on one device")
    if num_segments < 0:
        raise ValueError("num_segments must not be negative")
    out = torch.empty(num_segments, p, dtype=torch.float32,
                      device=planes.device)
    flag = torch.empty(1, dtype=torch.int32, device=planes.device)
    gen = _next_gen()
    if num_segments * p == 0:
        return out, flag, gen
    # amlint: unprofiled-jit — the launch helper of the
    # kernel.leb128_segment_sum program; its one other caller,
    # leb128_segment_sum_path, reads the pass flag back for checks and
    # logs only, and stays off the observatory on purpose
    err = _lib().leb128_segment_sum_launch(
        planes.data_ptr(), seg_ids.data_ptr(), out.data_ptr(),
        flag.data_ptr(), n, p, num_segments, gen,
        stream_ptr(planes.get_device()),
    )
    if err:
        raise RuntimeError(
            f"leb128_segment_sum kernels launch failed: CUDA error {err}"
        )
    LAUNCHES["leb128_segment_sum"] += 1
    return out, flag, gen


@profiled_program("kernel.leb128_segment_sum")
def leb128_segment_sum(planes, seg_ids, num_segments: int):
    """Per-varint payload-plane sums (see ``leb128_segment_sum_plain`` for
    the function). The planes must hold integers below 2^14 and every
    segment's sum must stay below 2^24, so that float32 sums are exact in
    any order. The ids may come in any order; sorted ids (as the scan
    makes them) take the sorted pass alone. Launches the kernels of
    ``csrc/leb128.cu`` on the current stream for card tensors, without
    synchronising; runs the plain version for CPU tensors."""
    return _segment_sum(planes, seg_ids, num_segments)[0]


def leb128_segment_sum_path(planes, seg_ids, num_segments: int):
    """``leb128_segment_sum`` and the pass that produced its result, for
    logs and checks: "sorted", "general" (the flag was set), or "plain"
    for CPU tensors. Reads the flag back, so it synchronises."""
    out, flag, gen = _segment_sum(planes, seg_ids, num_segments)
    if flag is None:
        return out, "plain"
    return out, "general" if int(flag.item()) == gen else "sorted"

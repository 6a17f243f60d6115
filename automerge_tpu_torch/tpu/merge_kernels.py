"""The dense whole-state merge on the card: one launch of
``csrc/dense_merge.cu`` a round.

The kernel replaces no Pallas kernel: the JAX package's merge is the XLA
program ``engine.apply_ops`` (its ``_merge_one_doc``, engine.py:181), and
the port's plain version of it is ``engine.merge_docs`` followed by the
copies back into the state (``engine.apply_ops_plain``). For a state on
the card ``engine.batched_apply_ops`` launches the kernel through
``dense_merge`` and for one on the CPU it runs the plain version; the
kernel's note says what bounds it and how it is laid out.

The contract ``dense_merge`` checks or relies on:

- the state's six row columns are ``[docs, n]`` and ``num_ops`` is
  ``[docs]``, the five change columns ``[docs, m]``, each of the dtype
  ``BatchedDocState`` and ``ChangeOpsBatch`` name, contiguous, all on one
  card, with ``1 <= m <= MAX_CHANGE_ROWS``;
- padding rows, in the state and in the changes, hold what
  ``engine.make_empty_state`` writes (``PAD_KEY``, 0, SET, 0, -1, false),
  and each document's rows are sorted by merge key with its padding last;
  every producer of dense batches pads so. The kernel then leaves the rows
  past a document's live rows and this round's untouched, and its result
  equals the plain version's bit for bit on all ``n`` rows;
- the state is updated in place, as the plain version copies into it.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import check_tensor, load, stream_ptr
from ..obs.metrics import get_metrics

#: launches of the kernel on the card (the CPU path never counts)
LAUNCHES = {"dense_merge": 0}

#: the most change rows a document the kernel takes in one launch: its
#: shared memory holds 40 B a row, within the 48 KiB a block has without
#: opting in; the main path hands 64 (bench.py, chip_smoke.py phase 20)
#: or 80 (the dense-100k cell)
SMEM_BYTES_PER_ROW = 40
MAX_CHANGE_ROWS = 48 * 1024 // SMEM_BYTES_PER_ROW

_M_LAUNCHES = get_metrics().counter(
    "engine.dense_merge.launches",
    "launches of the dense merge kernel (csrc/dense_merge.cu)",
)

_STATE_DTYPES = (torch.int32, torch.int64, torch.int32, torch.int64,
                 torch.int64, torch.bool)
_CHANGE_DTYPES = _STATE_DTYPES[:5]
_STATE_NAMES = ("key", "op", "action", "value", "pred", "overwritten")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    lib = load("dense_merge")
    if not getattr(lib, "_bound", False):
        vp = ctypes.c_void_p
        lib.dense_merge_launch.argtypes = [vp] * 12 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp,
        ]
        lib.dense_merge_launch.restype = ctypes.c_int
        lib._bound = True
    return lib


def check_dense_merge_args(state, changes) -> None:
    """Raises TypeError or ValueError on a dtype, shape, contiguity,
    device or ``m`` the kernel does not take."""
    if state.key.dim() != 2:
        raise ValueError(f"dense_merge: state.key must be [docs, n], got "
                         f"{tuple(state.key.shape)}")
    docs, n = state.key.shape
    m = changes.key.shape[1] if changes.key.dim() == 2 else -1
    device = state.key.device
    columns = [(f"state.{name}", t, dtype, (docs, n)) for name, t, dtype
               in zip(_STATE_NAMES, state[:6], _STATE_DTYPES)]
    columns.append(("state.num_ops", state.num_ops, torch.int32, (docs,)))
    columns += [(f"changes.{name}", t, dtype, (docs, m)) for name, t, dtype
                in zip(_STATE_NAMES, changes, _CHANGE_DTYPES)]
    for name, t, dtype, shape in columns:
        check_tensor(name, t, dtype, shape)
        if t.device != device:
            raise ValueError(f"dense_merge: {name} on {t.device}, the "
                             f"state on {device}: all on one card")
    if not 1 <= m <= MAX_CHANGE_ROWS:
        raise ValueError(f"dense_merge: {m} change rows a document, the "
                         f"kernel takes 1 to {MAX_CHANGE_ROWS}")
    if n >= 2**30:
        raise ValueError(f"dense_merge: capacity {n} is 2^30 or more")
    if device.type != "cuda":
        raise ValueError(f"dense_merge: tensors on {device}, the kernel "
                         "runs on the card")


def dense_merge(state, changes):
    """Merges each document's change rows into its sorted op table and
    adds its real rows to ``num_ops``, in place, with one launch of
    ``csrc/dense_merge.cu`` on the current stream (no synchronize).
    Returns `state`. Raises on what the kernel does not take (see
    ``check_dense_merge_args``) and on a refused launch; there is no
    fallback."""
    check_dense_merge_args(state, changes)
    docs, n = state.key.shape
    m = changes.key.shape[1]
    if docs == 0:
        return state
    # amlint: unprofiled-jit — runs inside the engine.apply_ops program,
    # batched_apply_ops' one dispatch on both packages' observatories (the
    # JAX merge is XLA, no pallas.* program to mirror)
    err = _lib().dense_merge_launch(
        *(t.data_ptr() for t in state), *(t.data_ptr() for t in changes),
        docs, n, m, stream_ptr(state.key.get_device()),
    )
    if err:
        raise RuntimeError(f"dense_merge kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["dense_merge"] += 1
    _M_LAUNCHES.inc()
    return state

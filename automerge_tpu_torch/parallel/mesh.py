"""The ('dp', 'sp') device grid of the doc-sharded farm.

The batch-of-documents axis is embarrassingly parallel (each document's
state is self-contained), so the distribution strategy is doc sharding
over `dp`: meshfarm.py routes whole documents to shard-local farms, each
on one torch device. `sp` (sequence parallelism over the op-capacity
axis) keeps the JAX package's validation, so a caller's layout means the
same in both packages.

Torch has no ``jax.sharding.Mesh``: the grid is a ``(dp, sp)`` numpy
array of ``torch.device``s. The JAX module's ``_apply_ops_impl`` (the
donation-free vmapped merge its compile contract exercises) has no
counterpart: torch has no jit, and the farm's merge programs are the
engine's own.
"""
from __future__ import annotations

import numpy as np
import torch


def make_mesh(devices=None, sp: int = 1) -> np.ndarray:
    """Builds a ('dp', 'sp') grid over the given devices (by default every
    visible card): a ``(len(devices) // sp, sp)`` object array of
    ``torch.device``.

    `sp` must divide the device count exactly — a remainder would have to
    silently fall back to (n, 1), handing the caller a grid with a
    different data-parallel degree than the one their layout assumes."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if n % sp != 0:
        raise ValueError(
            f"sp={sp} does not divide the device count {n}: an uneven "
            "sequence-parallel split cannot be laid out as a ('dp', 'sp') "
            "mesh (pass an sp that divides len(devices))"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return grid.reshape((n // sp, sp))

"""AM701 clean fixture: the length is rounded to a pow2 bucket first."""
import torch

from automerge_tpu_torch.tpu.jitprof import profiled_program


def _pow2(n):
    return 1 << max(0, n - 1).bit_length()


@profiled_program("fixture.shape.bucketed")
def _embed(xs):
    return xs * 2


def drive(batches):
    outs = []
    for rows in batches:
        n = _pow2(len(rows))
        outs.append(_embed(torch.zeros((n,), dtype=torch.int32)))
    return outs

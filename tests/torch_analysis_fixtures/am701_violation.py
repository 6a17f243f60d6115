"""AM701 violating fixture: a raw ``len()`` sizes the tensor a device
program is dispatched on.

Deliberately executable: tests/test_torch_analysis.py drives ``drive``
under an enabled observatory and flight recorder and holds the runtime
twin (``prof.recompile.storm``) to the same dispatch the static rule
flags: four distinct batch lengths are four new shape buckets, four
compiles inside the storm window.
"""
import torch

from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.shape.raw")
def _embed(xs):
    return xs * 2


def drive(batches):
    outs = []
    for rows in batches:
        n = len(rows)
        outs.append(_embed(torch.zeros((n,), dtype=torch.int32)))
    return outs

"""AM701 suppressed fixture: a shape-dynamic dispatch, justified."""
import torch

from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.shape.dynamic")
def _embed(xs):
    return xs * 2


def drive(rows):
    n = len(rows)
    # amlint: disable=AM701 — one call per process at start-up; its
    # length is the deployment's doc count, fixed for the run
    return _embed(torch.zeros((n,), dtype=torch.int32))

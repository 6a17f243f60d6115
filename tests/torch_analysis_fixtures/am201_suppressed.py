"""AM201 suppressed fixture: a deliberate sync, justified."""
import torch

from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.am201")
def relu_rows(x):
    # amlint: disable=AM201 — the one check this program pays for, before
    # any launch: an empty batch has nothing to merge
    if x.sum() > 0:
        return x
    return torch.zeros_like(x)

"""AM201 violating fixture: a Python branch on a tensor inside a device
program (an implicit ``bool()``: a hidden sync on the card)."""
import torch

from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.am201")
def relu_rows(x):
    if x.sum() > 0:
        return x
    return torch.zeros_like(x)

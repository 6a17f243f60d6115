"""AM201 clean fixture: the branch is a tensor op; branching on shapes
and host ints is legal."""
import torch

from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.am201")
def relu_rows(x, limit: int):
    if x.shape[0] > limit and x.device.type == "cuda":
        x = x[:limit]
    return torch.where(x > 0, x, torch.zeros_like(x))

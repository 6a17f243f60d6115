"""AM202 violating fixture: host reads of a tensor inside a device
program (each waits for the card and copies the value back)."""
import numpy as np

from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.am202")
def total_rows(x, y):
    n = int(x.sum())
    first = y.max().item()
    host = np.asarray(y)
    return n, first, host, x.cpu()

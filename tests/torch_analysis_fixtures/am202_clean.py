"""AM202 clean fixture: only host metadata of the tensors is read."""
from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.am202")
def total_rows(x, y):
    rows = int(x.shape[0]) + y.numel()
    return x.sum(), y.max(), rows, x.data_ptr() != 0

"""AM306 clean fixture: the launch sits inside the kernel's wrapper."""
from automerge_tpu_torch.kernels import load
from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("kernel.rows")
def launch_rows(x, out):
    lib = load("rows")
    return lib.rows_launch(x.data_ptr(), out.data_ptr(), x.shape[0])

"""AM306 suppressed fixture: a launch off the observatory, justified."""
from automerge_tpu_torch.kernels import load


def launch_rows(x, out):
    lib = load("rows")
    # amlint: unprofiled-jit — a check-only path that reads the kernel's
    # flag back; it stays off the observatory on purpose
    return lib.rows_launch(x.data_ptr(), out.data_ptr(), x.shape[0])

"""AM306 violating fixture: a kernel launched outside its kernel.*
wrapper program, where the observatory cannot see it."""
from automerge_tpu_torch.kernels import load


def launch_rows(x, out):
    lib = load("rows")
    return lib.rows_launch(x.data_ptr(), out.data_ptr(), x.shape[0])

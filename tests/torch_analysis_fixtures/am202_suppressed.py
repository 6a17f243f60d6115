"""AM202 suppressed fixture: a deliberate readback, justified."""
from automerge_tpu_torch.tpu.jitprof import profiled_program


@profiled_program("fixture.am202")
def total_rows(x):
    # amlint: disable=AM202 — the caller needs the host count to size the
    # next batch, and this program ends the dispatch anyway
    return int(x.sum())

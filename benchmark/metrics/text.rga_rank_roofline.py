"""The device RGA rank's share of its roofline in the traced part of the
window: the least time of the elements the traced opens ranked
(``harness/text_bounds.py``: 16 bytes an element, no padding, at
``harness/roofline.py``'s memory rate) over the device time of what the
host launched inside the farm's ``rga_rank`` span (the profiler range
``farm.rga_rank``)."""
from harness import roofline, text_bounds


def read(r):
    t, loop = r["trace"], r.get("loop")
    if t is None or not loop or not loop.get("traced_elems"):
        return None
    device_s = t["ops_by_range"].get("farm.rga_rank", 0.0)
    if not device_s:
        return None
    nbytes = text_bounds.rga_rank_bytes(loop["traced_elems"])
    return 100.0 * roofline.least_ms(nbytes) / (device_s * 1e3)

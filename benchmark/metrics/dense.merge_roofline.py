"""The dense merge's share of its roofline in the traced part of the
window: the least time of the traced merges (``harness/roofline.py``'s
``dense_merge_bytes`` at the card's memory rate: live rows only) over the
device time of what the host launched inside the dense loop's
``dense.merge`` ranges."""
from harness import roofline


def read(r):
    t, loop = r["trace"], r.get("loop")
    if t is None or loop is None:
        return None
    device_s = t["ops_by_range"].get("dense.merge", 0.0)
    if not loop["merges"] or not device_s:
        return None
    return 100.0 * roofline.least_ms(loop["merge_bytes"]) / (device_s * 1e3)

"""The dense visibility pass's share of its roofline in the traced part
of the window: the least time of the traced passes (``harness/roofline.py``'s
``dense_visibility_bytes`` over the rows then live, at the card's memory
rate) over the device time of what the host launched inside the dense
loop's ``dense.visibility`` ranges."""
from harness import roofline


def read(r):
    t, loop = r["trace"], r.get("loop")
    if t is None or loop is None:
        return None
    device_s = t["ops_by_range"].get("dense.visibility", 0.0)
    if not loop["passes"] or not device_s:
        return None
    return (100.0 * roofline.least_ms(loop["visibility_bytes"])
            / (device_s * 1e3))

"""``bloom_build``'s share of its roofline in the traced part of the
window: the least time of every launch recorded there (a frozen copy of
``chip_smoke.build_bound``, ``harness/roofline.py``) over the device time
of the kernels whose names hold ``bloom_build`` in the profiler's trace."""


def read(r):
    t = r["trace"]
    if t is None:
        return None
    device_s = sum(s for name, s in t["ops"].items()
                   if "bloom_build" in name)
    bound_ms = t["bloom_bounds_ms"]["build"]
    if not device_s or bound_ms is None:
        return None
    return 100.0 * bound_ms / (device_s * 1e3)

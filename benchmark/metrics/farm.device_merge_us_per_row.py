"""Device microseconds per committed op row of what the farm launched
inside its ``device_dispatch`` phase (the profiler range
``farm.device_dispatch``: the merge program), over the traced part of the
window and the rows committed there."""


def read(r):
    t = r["trace"]
    if t is None or not t["rows"]:
        return None
    device_s = t["ops_by_range"].get("farm.device_dispatch", 0.0)
    if not device_s:
        return None
    return device_s * 1e6 / t["rows"]

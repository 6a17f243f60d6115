"""Device operations (kernels, copies, sets) the host launched inside the
dense loop's ``dense.merge`` ranges, per merge traced."""


def read(r):
    t, loop = r["trace"], r.get("loop")
    if t is None or loop is None:
        return None
    launches = t["launches_by_range"].get("dense.merge", 0)
    if not loop["merges"] or not launches:
        return None
    return launches / loop["merges"]

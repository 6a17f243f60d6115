"""Device milliseconds per round of what the host launched inside the
dense loop's ``dense.upload`` ranges: the copies of the round's change
rows from pinned host memory to the card."""


def read(r):
    t, loop = r["trace"], r.get("loop")
    if t is None or loop is None:
        return None
    device_s = t["ops_by_range"].get("dense.upload", 0.0)
    if not loop["merges"] or not device_s:
        return None
    return device_s * 1e3 / loop["merges"]

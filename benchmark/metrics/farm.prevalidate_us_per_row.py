"""Host microseconds per committed op row in the farm's prevalidation of
the delivery's limits (program span: prevalidate), over every farm of
the cell and the whole window."""

PHASES = ("prevalidate",)


def read(r):
    if not r["rows"] or not any(p in r["phases"] for p in PHASES):
        return None
    return sum(r["phases"].get(p, 0.0) for p in PHASES) * 1e6 / r["rows"]

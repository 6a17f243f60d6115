"""Host microseconds per committed op row in the embedded reference walk
that serves every text document (program span: walk_apply, the embedded
OpSet's apply inside the farm's walk phase), over the whole window."""

PHASES = ("walk_apply",)


def read(r):
    if not r["rows"] or not any(p in r["phases"] for p in PHASES):
        return None
    return sum(r["phases"].get(p, 0.0) for p in PHASES) * 1e6 / r["rows"]

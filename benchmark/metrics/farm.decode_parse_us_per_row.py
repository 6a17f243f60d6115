"""Host microseconds per committed op row in the batched parse of a
delivery's decode-cache misses (program span: decode_parse, inside
decode), over every farm of the cell and the whole window."""

PHASES = ("decode_parse",)


def read(r):
    if not r["rows"] or not any(p in r["phases"] for p in PHASES):
        return None
    return sum(r["phases"].get(p, 0.0) for p in PHASES) * 1e6 / r["rows"]

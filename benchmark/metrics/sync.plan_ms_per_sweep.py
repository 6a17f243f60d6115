"""Host milliseconds per sync sweep in ``SyncFarm.generate_messages``'
channel walk (program span: sync.plan), over every farm of the cell and
the whole window."""

PHASES = ("sync.plan",)


def read(r):
    if not r["sweeps"] or not any(p in r["phases"] for p in PHASES):
        return None
    return sum(r["phases"].get(p, 0.0) for p in PHASES) * 1e3 / r["sweeps"]

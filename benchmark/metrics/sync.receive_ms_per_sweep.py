"""Host milliseconds per sync sweep in two parts of
``SyncFarm.receive_messages`` outside the farm's apply: the messages'
decode and the per-channel bookkeeping after it (program spans:
sync.receive_decode, sync.receive_post), over every farm of the cell and
the whole window."""

PHASES = ("sync.receive_decode", "sync.receive_post")


def read(r):
    if not r["sweeps"] or not any(p in r["phases"] for p in PHASES):
        return None
    return sum(r["phases"].get(p, 0.0) for p in PHASES) * 1e3 / r["sweeps"]

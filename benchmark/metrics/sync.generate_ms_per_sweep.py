"""Host milliseconds in ``SyncFarm.generate_messages`` per sync sweep
(the benchmark's own span around each call, summed over the window)."""


def read(r):
    if not r["sweeps"]:
        return None
    return r["generate_s"] * 1e3 / r["sweeps"]

"""Sync sweeps until no message moves, per epoch of the window."""


def read(r):
    if not r["epochs"]:
        return None
    return r["sweeps"] / r["epochs"]

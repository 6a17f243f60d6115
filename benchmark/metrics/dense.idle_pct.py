"""The share of the traced part of the dense loop's window in which no
operation ran on the device (torch.profiler's kernels, copies and sets):
``device.idle_pct`` for the cells that report ``dense_merged_ops_per_s``."""


def read(r):
    t = r["trace"]
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

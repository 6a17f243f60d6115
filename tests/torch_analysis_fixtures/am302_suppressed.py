"""AM302 suppressed fixture: a sync in a device phase, justified."""
import torch


def apply(prof, engine, batch):
    with prof.phase("device_dispatch"):
        out = engine.apply(batch)
        # amlint: disable=AM302 — the probe must surface a device fault
        # inside the phase that dispatched it
        torch.cuda.synchronize()
    return out

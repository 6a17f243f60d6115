"""AM302 violating fixture: hidden syncs inside a device phase."""
import torch


def apply(prof, engine, batch):
    with prof.phase("device_dispatch"):
        out = engine.apply(batch)
        torch.cuda.synchronize()
        rows = out.cpu()
    return rows

"""AM302 clean fixture: the readback sits in a host phase."""
def apply(prof, engine, batch):
    with prof.phase("device_dispatch"):
        out = engine.apply(batch)
    with prof.phase("readback"):
        rows = out.cpu()
    return rows

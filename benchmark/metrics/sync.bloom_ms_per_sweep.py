"""Host milliseconds per sync sweep in ``SyncFarm.generate_messages``'
Bloom filters: packing, the build and query launches and their readback
(program spans: sync.bloom_build, sync.bloom_query), over every farm of
the cell and the whole window."""

PHASES = ("sync.bloom_build", "sync.bloom_query")


def read(r):
    if not r["sweeps"] or not any(p in r["phases"] for p in PHASES):
        return None
    return sum(r["phases"].get(p, 0.0) for p in PHASES) * 1e3 / r["sweeps"]

"""Supervised sync channels, whole frame streams: with the same seeded
clock, RNG and lossy link, the port's ``SyncSession``s give the JAX
package's frame stream byte for byte — every frame, which were dropped,
the saved sessions of a mid-run save/restore, the final saves and stats —
for ``BackendDriver`` pairs and for farm channels (``FarmDriver``), v1
and v2, on the CPU; and ``chip_smoke.py``'s phase 13 checks at a small
size."""
import random
from types import SimpleNamespace

import pytest

from automerge_tpu import backend as JaxBackend
from automerge_tpu import sync_session as JaxSessions
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu.tpu.sync_farm import SyncFarm as JaxSyncFarm
from automerge_tpu_torch import SyncFarm, TorchDocFarm
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch import sync_session as Sessions

import chip_smoke

JAX = SimpleNamespace(
    backend=JaxBackend, sessions=JaxSessions,
    farm=lambda docs: TpuDocFarm(docs, capacity=256), sync_farm=JaxSyncFarm)
PORT = SimpleNamespace(
    backend=Backend, sessions=Sessions,
    farm=lambda docs: TorchDocFarm(docs, capacity=256, device="cpu"),
    sync_farm=SyncFarm)


# ---------------------------------------------------------------------- #
# frame streams under seeded loss


def backend_pairs(pkg, docs, seed, v2_docs):
    """Per doc, two single-document peers (phase 13's two edit streams)
    supervised by two sessions; docs below `v2_docs` enable v2."""
    farm_bufs, client_bufs = chip_smoke.session_edits(docs, seed)
    clock = chip_smoke.FakeClock()
    pairs = []
    for d in range(docs):
        config = pkg.sessions.SessionConfig(enable_v2=d < v2_docs)
        sides = []
        for k, bufs in enumerate((client_bufs[d], farm_bufs[d])):
            handle, _ = pkg.backend.apply_changes(pkg.backend.init(), bufs)
            sides.append(pkg.sessions.SyncSession(
                pkg.sessions.BackendDriver(handle), clock=clock,
                rng=random.Random(seed * 31 + 2 * d + k), config=config))
        pairs.append(sides)
    return clock, pairs


def farm_pairs(pkg, docs, seed, v2_docs):
    """Per doc, a single-document client against one farm's channel."""
    farm_bufs, client_bufs = chip_smoke.session_edits(docs, seed)
    farm = pkg.farm(docs)
    farm.apply_changes(farm_bufs)
    sync = pkg.sync_farm(farm)
    clock = chip_smoke.FakeClock()
    pairs = []
    for d in range(docs):
        config = pkg.sessions.SessionConfig(enable_v2=d < v2_docs)
        handle, _ = pkg.backend.apply_changes(pkg.backend.init(),
                                              client_bufs[d])
        pairs.append([
            pkg.sessions.SyncSession(
                pkg.sessions.BackendDriver(handle), clock=clock,
                rng=random.Random(seed * 31 + 2 * d), config=config),
            sync.make_session(d, clock=clock,
                              rng=random.Random(seed * 31 + 2 * d + 1),
                              config=config),
        ])
    return clock, pairs, sync


def resumer(pkg, clock, seed, v2_docs, sync=None):
    """`drive_sessions`' resume hook: saves both sessions of a pair and
    restores them (a farm channel through ``restore_session``)."""
    blobs = []

    def resume(d, pair):
        saved = [s.save() for s in pair]
        blobs.append(saved)
        config = pkg.sessions.SessionConfig(enable_v2=d < v2_docs)
        out = []
        for k, (s, blob) in enumerate(zip(pair, saved)):
            rng = random.Random(seed * 97 + 2 * d + k)
            if sync is not None and k == 1:
                out.append(sync.restore_session(d, blob, clock=clock, rng=rng,
                                                config=config))
            else:
                out.append(pkg.sessions.SyncSession.restore(
                    blob, pkg.sessions.BackendDriver(s.driver.backend),
                    clock=clock, rng=rng, config=config))
        return out

    return resume, blobs


def run(pkg, docs, seed, v2_docs, loss, farm):
    if farm:
        clock, pairs, sync = farm_pairs(pkg, docs, seed, v2_docs)
    else:
        (clock, pairs), sync = backend_pairs(pkg, docs, seed, v2_docs), None
    resume, blobs = resumer(pkg, clock, seed, v2_docs, sync)
    frames, steps = chip_smoke.drive_sessions(
        pairs, clock, random.Random(seed), loss, resume)
    saved = [s.save() for pair in pairs for s in pair]
    stats = [dict(s.stats) for pair in pairs for s in pair]
    heads = [[s.driver.heads() for s in pair] for pair in pairs]
    return frames, steps, blobs, saved, stats, heads, pairs


@pytest.mark.parametrize("farm", [False, True], ids=["backend", "farm"])
@pytest.mark.parametrize("docs,v2_docs,loss,seed", [
    (4, 2, 0.3, 0), (3, 3, 0.3, 1), (3, 0, 0.0, 2), (2, 1, 0.5, 3)])
def test_frame_streams_match_jax(farm, docs, v2_docs, loss, seed):
    want = run(JAX, docs, seed, v2_docs, loss, farm)
    got = run(PORT, docs, seed, v2_docs, loss, farm)
    assert got[0] == want[0]  # every frame, in order, and what was dropped
    assert got[1:6] == want[1:6]  # steps, restore blobs, saves, stats, heads
    for d, (a, b) in enumerate(got[6]):
        assert a.driver.heads() == b.driver.heads()
        assert a.v2_active == b.v2_active == (d < v2_docs)


def test_phase13_checks_pass_on_the_cpu():
    farm, clients, pairs, frames, stats = chip_smoke.run_sessions("cpu", 6, 4)
    totals = chip_smoke.check_sessions(farm, clients, pairs, frames)
    assert totals["v1"]["dropped"] + totals["v2"]["dropped"] > 0
    assert stats["steps"] > 3

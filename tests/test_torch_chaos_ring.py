"""The port's chaos transport around farms, twins of the JAX package's
tests/test_chaos_sync.py 4-peer ``SyncFarm`` gossip ring and its
fault-registry composition tests, on the CPU (``device="cpu"``); and the
transport against the JAX package's: for one seed, both packages'
``ChaosNetwork`` give the same frame schedule, and a chaos soak of the
same sessions moves the same frames byte for byte."""
import json
import random

import pytest

from automerge_tpu import backend as JaxBackend
from automerge_tpu.sync_session import BackendDriver as JaxBackendDriver
from automerge_tpu.sync_session import SessionConfig as JaxSessionConfig
from automerge_tpu.sync_session import SyncSession as JaxSyncSession
from automerge_tpu.testing import chaos as jax_chaos
from automerge_tpu.testing import faults as jax_faults
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch.sync_session import (BackendDriver, SessionConfig,
                                              SyncSession)
from automerge_tpu_torch.testing import chaos, faults
from automerge_tpu_torch.testing.chaos import (ChaosConfig, ChaosHarness,
                                               ChaosLink, ChaosNetwork,
                                               ManualClock)
from automerge_tpu_torch.tpu.farm import TorchDocFarm
from automerge_tpu_torch.tpu.sync_farm import SyncFarm


def soak_config(config_cls, p):
    cfg = config_cls.lossy(p)
    cfg.corrupt = p / 3
    cfg.truncate = p / 3
    return cfg


class FarmPeer:
    """One ring member: a 1-doc farm + its batched sync driver."""

    def __init__(self, name, actor):
        self.name = name
        self.actor = actor
        self.farm = TorchDocFarm(1, capacity=256, device="cpu")
        self.sync = SyncFarm(self.farm)
        self.seq = 0
        self.max_op = 0

    def edit(self, key, value):
        self.seq += 1
        start = self.max_op + 1
        buf = faults.make_change(
            self.actor, self.seq, start, self.farm.get_heads(0),
            [faults.set_op(key, value)],
        )
        self.max_op = start
        self.farm.apply_changes([[buf]])

    def heads(self):
        return self.farm.get_heads(0)

    def doc_json(self):
        return json.dumps(self.farm.get_patch(0), sort_keys=True)


def ring_harness(seed, p, n_edits, config=None, npeers=4):
    clock = ManualClock()
    network = ChaosNetwork(random.Random(seed), clock,
                           soak_config(ChaosConfig, p))
    harness = ChaosHarness(network, clock)
    peers = [FarmPeer(i, f"{i:02x}{'ab' * 3}") for i in range(npeers)]
    for i, peer in enumerate(peers):
        for k in range(n_edits):
            peer.edit(f"p{i}k{k}", i * 100 + k)
    config = config or SessionConfig()
    rng_base = seed * 1000
    for i in range(npeers):
        j = (i + 1) % npeers
        for src, dst in ((i, j), (j, i)):
            session = peers[src].sync.make_session(
                0, clock=clock,
                rng=random.Random(rng_base + src * npeers + dst),
                config=config,
            )
            harness.add_session(src, dst, session)
    return clock, network, harness, peers


def ring_converged(peers):
    h0 = peers[0].heads()
    return all(p.heads() == h0 for p in peers[1:])


class TestFarmRingSoak:
    def test_ring_converges_under_15pct_chaos(self):
        clock, _n, harness, peers = ring_harness(31, 0.15, n_edits=2)
        assert harness.run_until(lambda: ring_converged(peers),
                                 max_time=900.0)
        assert len({p.doc_json() for p in peers}) == 1

    def test_ring_peer_restart(self):
        """Peer 2 loses its farm and sessions mid-gossip; the ring heals
        around the restart."""
        clock, network, harness, peers = ring_harness(35, 0.1, n_edits=2)
        for _ in range(6):
            harness.step()
            clock.advance(0.1)
        network.drop_in_flight(2)
        peers[2] = FarmPeer(2, "02" + "ab" * 3)
        for src, dst in ((2, 1), (2, 3)):
            harness.add_session(src, dst, peers[src].sync.make_session(
                0, clock=clock, rng=random.Random(5000 + dst)))
        assert harness.run_until(lambda: ring_converged(peers),
                                 max_time=1200.0)
        assert len({p.doc_json() for p in peers}) == 1


class TestChaosFaultComposition:
    def test_chaos_send_failure_point_fires(self):
        clock = ManualClock()
        link = ChaosLink(random.Random(0), clock, ChaosConfig(), name="a->b")
        seen = []
        with faults.inject("chaos.send", lambda **ctx: seen.append(ctx)):
            link.send(b"frame-1")
        assert seen == [{"link": "a->b", "frame": b"frame-1"}]
        assert link.deliver() == [b"frame-1"]

    def test_injected_transport_fault_composes_with_chaos(self):
        """faults.inject can make a chaos link raise; the JAX package's
        registry never reaches the port's link."""
        clock = ManualClock()
        link = ChaosLink(random.Random(0), clock, ChaosConfig())
        with jax_faults.inject("chaos.send", jax_faults.fail_always()):
            link.send(b"other")  # the JAX package's hook: not ours
        with faults.inject("chaos.send", faults.fail_always()):
            with pytest.raises(RuntimeError):
                link.send(b"frame")
        link.send(b"frame")  # registry restored
        assert link.deliver() == [b"other", b"frame"]

    def test_quarantined_doc_sheds_sync_while_channel_stays_up(self):
        """A doc quarantined by the farm's per-doc isolation stops being
        offered over supervised sync; after release_quarantine the same
        channel converges. Merge fault + lossy network together."""
        clock = ManualClock()
        network = ChaosNetwork(random.Random(41), clock, ChaosConfig(drop=0.1))
        harness = ChaosHarness(network, clock)
        pa = FarmPeer("a", "aa" * 4)
        pb = FarmPeer("b", "bb" * 4)
        pa.edit("x", 1)
        sa = pa.sync.make_session(0, clock=clock, rng=random.Random(1))
        sb = pb.sync.make_session(0, clock=clock, rng=random.Random(2))
        harness.add_session("a", "b", sa)
        harness.add_session("b", "a", sb)
        for _ in range(pa.farm.quarantine_threshold):
            pa.farm.apply_changes([[faults.garbage(48)]])
        assert 0 in pa.farm.quarantine
        harness.run_until(lambda: False, max_time=10.0)
        assert sa.state["lastSentHeads"] == []  # nothing was generated
        assert pb.heads() == []
        pa.farm.release_quarantine(0)
        assert harness.run_until(lambda: pa.heads() == pb.heads(),
                                 max_time=600.0)
        assert pb.heads() != []


# ---------------------------------------------------------------------- #
# the port's transport against the JAX package's


@pytest.mark.parametrize("seed", [3, 4])
def test_same_seed_same_frame_schedule_as_jax(seed):
    """Frames of varied sizes pushed through both packages' networks on
    one seed, with clock steps between: every delivery (peer, bytes) and
    the per-link stats agree."""
    rng = random.Random(seed)
    sends = [(rng.choice("abc"), rng.choice("abc"),
              bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40))))
             for _ in range(200)]
    runs = []
    for mod in (jax_chaos, chaos):
        clock = mod.ManualClock()
        net = mod.ChaosNetwork(random.Random(seed), clock,
                               soak_config(mod.ChaosConfig, 0.3))
        net.set_latency("a", "b", 0.2)
        out = []
        for i, (src, dst, frame) in enumerate(sends):
            net.send(src, dst, frame)
            if i % 7 == 0:
                clock.advance(0.05)
                out.extend((peer, dst, f) for dst in "abc"
                           for peer, f in net.deliver(dst))
        clock.advance(10.0)
        out.extend((peer, dst, f) for dst in "abc"
                   for peer, f in net.deliver(dst))
        runs.append((out, net.stats()))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) > 100


def _soak(backend, driver_cls, session_cls, config_cls, mod, fault_mod):
    """A v1 and a v2 pair of single-document peers (three changes each)
    under 30 % chaos on one package's backend, sessions and transport.
    Returns (frames sent and delivered, the clock, every session's
    stats)."""
    frames = []

    def record(**ctx):
        frames.append((ctx["link"], bytes(ctx["frame"])))

    clock = mod.ManualClock()
    net = mod.ChaosNetwork(random.Random(5), clock,
                           soak_config(mod.ChaosConfig, 0.3))
    harness = mod.ChaosHarness(net, clock)
    drivers, sessions = [], []
    for p, (a, b) in enumerate((("a", "b"), ("c", "d"))):
        for k, (src, dst) in enumerate(((a, b), (b, a))):
            actor = f"{2 * p + k + 1:02x}" * 4
            state = backend.init()
            for i in range(3):
                buf = faults.make_change(actor, i + 1, i + 1,
                                         backend.get_heads(state),
                                         [faults.set_op(f"{src}{i}", i)])
                state, _ = backend.apply_changes(state, [buf])
            driver = driver_cls(state)
            session = session_cls(driver, clock=clock,
                                  rng=random.Random(17 * p + k),
                                  config=config_cls(enable_v2=p == 1))
            harness.add_session(src, dst, session)
            drivers.append(driver)
            sessions.append(session)
    with fault_mod.inject("chaos.send", record), \
            fault_mod.inject("chaos.deliver", record):
        assert harness.run_until(
            lambda: drivers[0].heads() == drivers[1].heads()
            and drivers[2].heads() == drivers[3].heads(),
            max_time=900.0)
    return frames, clock.now(), [s.stats for s in sessions]


def test_session_soak_moves_the_same_frames_as_jax():
    """The same soak on each package: the frames sent and delivered, the
    clock and every session's stats agree."""
    want = _soak(JaxBackend, JaxBackendDriver, JaxSyncSession,
                 JaxSessionConfig, jax_chaos, jax_faults)
    got = _soak(Backend, BackendDriver, SyncSession, SessionConfig, chaos,
                faults)
    assert got == want
    assert len(got[0]) > 20

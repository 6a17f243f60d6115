"""Chaos soak of the port's supervised sync, twins of the JAX package's
tests/test_chaos_sync.py (its non-slow two-peer, protocol-pairing and
asymmetric-link tests) over the port's chaos transport
(``automerge_tpu_torch.testing.chaos``): two peers must reach identical
heads and equal whole-document patches under seeded loss, duplication,
reordering, corruption and truncation up to 30 %, a peer restart, a
partition and its heal, all in simulated time. The port has no public
document API yet, so each peer is a ``backend`` replica behind a
``BackendDriver`` (the JAX suite's pairing tests' shape); the 4-peer farm
ring is in tests/test_torch_chaos_ring.py."""
import json
import random

import pytest

from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch.sync_session import (BackendDriver, SessionConfig,
                                              SyncSession)
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.testing.chaos import (ChaosConfig, ChaosHarness,
                                               ChaosNetwork, ManualClock)


class Peer(BackendDriver):
    """A backend replica that also edits: each edit sets one root key in
    a new change of this peer's actor."""

    def __init__(self, actor, keys_values=(), backend=None):
        super().__init__(backend if backend is not None else Backend.init())
        self.actor = actor
        self.seq = 0
        for key, value in keys_values:
            self.edit(key, value)

    def edit(self, key, value):
        self.seq += 1
        start = Backend.get_patch(self.backend)["maxOp"] + 1
        buf = faults.make_change(self.actor, self.seq, start,
                                 Backend.get_heads(self.backend),
                                 [faults.set_op(key, value)])
        self.backend, _ = Backend.apply_changes(self.backend, [buf])

    def keys(self):
        return set(Backend.get_patch(self.backend)["diffs"]["props"])


def canonical(peer) -> str:
    return json.dumps(Backend.get_patch(peer.backend), sort_keys=True)


def soak_config(p):
    cfg = ChaosConfig.lossy(p)
    cfg.corrupt = p / 3
    cfg.truncate = p / 3
    return cfg


def make_harness(seed, p):
    clock = ManualClock()
    network = ChaosNetwork(random.Random(seed), clock, soak_config(p))
    return clock, network, ChaosHarness(network, clock)


def pair_sessions(harness, clock, da, db, seed, config=None):
    config = config or SessionConfig()
    sa = SyncSession(da, clock=clock, rng=random.Random(seed * 31 + 1),
                     config=config)
    sb = SyncSession(db, clock=clock, rng=random.Random(seed * 31 + 2),
                     config=config)
    harness.add_session("a", "b", sa)
    harness.add_session("b", "a", sb)
    return sa, sb


def converged(da, db):
    return lambda: da.heads() == db.heads()


# ---------------------------------------------------------------------- #
# two peers


class TestTwoPeerSoak:
    @pytest.mark.parametrize("seed", range(3))
    def test_converges_under_30pct_chaos(self, seed):
        clock, _network, harness = make_harness(seed, 0.3)
        da = Peer("aaaaaaaa", [(f"a{i}", i) for i in range(6)])
        db = Peer("bbbbbbbb", [(f"b{i}", i) for i in range(6)])
        pair_sessions(harness, clock, da, db, seed)
        assert harness.run_until(converged(da, db), max_time=600.0)
        assert canonical(da) == canonical(db)

    def test_same_seed_same_failure_schedule(self):
        def run(seed):
            clock, network, harness = make_harness(seed, 0.3)
            da = Peer("aaaaaaaa", [("x", 1), ("y", 2)])
            db = Peer("bbbbbbbb", [("z", 3)])
            sa, sb = pair_sessions(harness, clock, da, db, seed)
            harness.run_until(converged(da, db), max_time=600.0)
            return (clock.now(), sa.stats, sb.stats, network.stats())

        assert run(7) == run(7)
        assert run(7) != run(8)

    def test_peer_restart_mid_sync(self):
        """b dies mid-exchange, loses its doc and session, and comes back
        with a fresh epoch; a detects the restart and re-converges."""
        clock, network, harness = make_harness(21, 0.15)
        da = Peer("aaaaaaaa", [(f"a{i}", i) for i in range(5)])
        db = Peer("bbbbbbbb", [("b", 0)])
        sa, sb = pair_sessions(harness, clock, da, db, 21)
        for _ in range(4):
            harness.step()
            clock.advance(0.1)
        network.drop_in_flight("b")
        db2 = Peer("bbbbbbbb", [("b", 0)])
        sb2 = SyncSession(db2, clock=clock, rng=random.Random(999))
        harness.add_session("b", "a", sb2)  # replaces the dead session
        assert harness.run_until(converged(da, db2), max_time=600.0)
        assert canonical(da) == canonical(db2)
        assert sa.stats["peer_restarts"] == 1

    def test_restart_with_persisted_session_resumes_seamlessly(self):
        clock, network, harness = make_harness(22, 0.1)
        da = Peer("aaaaaaaa", [(f"a{i}", i) for i in range(4)])
        db = Peer("bbbbbbbb")
        sa, sb = pair_sessions(harness, clock, da, db, 22)
        assert harness.run_until(converged(da, db), max_time=600.0)
        blob = sb.save()
        saved_doc = Backend.save(db.backend)
        # process restart: doc reloaded from disk, session restored
        db2 = Peer("bbbbbbbb", backend=Backend.load(saved_doc))
        sb2 = SyncSession.restore(blob, db2, clock=clock,
                                  rng=random.Random(1000))
        harness.add_session("b", "a", sb2)
        da.edit("late", 42)
        assert harness.run_until(converged(da, db2), max_time=600.0)
        assert canonical(da) == canonical(db2)
        assert sa.stats["peer_restarts"] == 0  # same epoch: no restart seen

    def test_partition_heal(self):
        clock, network, harness = make_harness(23, 0.2)
        da = Peer("aaaaaaaa", [("x", 1)])
        db = Peer("bbbbbbbb", [("y", 2)])
        sa, sb = pair_sessions(harness, clock, da, db, 23)
        assert harness.run_until(converged(da, db), max_time=600.0)
        network.partition("a", "b")
        da.edit("during_a", 1)
        db.edit("during_b", 2)
        assert not harness.run_until(converged(da, db), max_time=30.0)
        # heal, then release the channels that spent their retry budget
        network.heal("a", "b")
        for _ in range(5):
            sa.release()
            sb.release()
            if harness.run_until(converged(da, db), max_time=120.0):
                break
        assert da.heads() == db.heads()
        assert canonical(da) == canonical(db)
        assert {"during_a", "during_b"} <= da.keys()


# ---------------------------------------------------------------------- #
# protocol pairings: v1<->v1, v1<->v2, v2<->v2 under 30% chaos


def pairing_harness(seed, p, v2a, v2b):
    clock, network, harness = make_harness(seed, p)
    da = Peer("aaaaaaaa", [(f"a{i}", i) for i in range(6)])
    db = Peer("bbbbbbbb", [(f"b{i}", i) for i in range(6)])
    sa = SyncSession(da, clock=clock, rng=random.Random(seed * 31 + 1),
                     config=SessionConfig(enable_v2=v2a))
    sb = SyncSession(db, clock=clock, rng=random.Random(seed * 31 + 2),
                     config=SessionConfig(enable_v2=v2b))
    harness.add_session("a", "b", sa)
    harness.add_session("b", "a", sb)
    return clock, network, harness, da, db, sa, sb


class TestProtocolPairingSoak:
    @pytest.mark.parametrize("seed,v2a,v2b", [
        (51, False, False), (52, False, True),
        (53, True, False), (54, True, True),
    ])
    def test_pairing_converges_under_30pct_chaos(self, seed, v2a, v2b):
        clock, _n, harness, da, db, sa, sb = pairing_harness(seed, 0.3,
                                                             v2a, v2b)
        assert harness.run_until(converged(da, db), max_time=900.0)
        both = v2a and v2b
        assert sa.v2_active == both and sb.v2_active == both
        assert (sa.stats["v2_negotiated"] > 0) == both
        assert sa.stats["v2_fallbacks"] == 0 and sb.stats["v2_fallbacks"] == 0

    def test_v2_soak_never_trips_the_watchdog(self):
        clock, _n, harness, da, db, sa, sb = pairing_harness(55, 0.3,
                                                             True, True)
        assert harness.run_until(converged(da, db), max_time=900.0)
        for s in (sa, sb):
            assert s.stats["stalls"] == 0
            assert s.stats["escalations"] == 0
            assert s.stats["resets"] == 0


class TestAsymmetricChaos:
    def test_one_way_partition_blocks_and_heals(self):
        clock, network, harness = make_harness(61, 0.1)
        da = Peer("aaaaaaaa", [("x", 1)])
        db = Peer("bbbbbbbb", [("y", 2)])
        sa, sb = pair_sessions(harness, clock, da, db, 61)
        assert harness.run_until(converged(da, db), max_time=600.0)
        network.partition_one_way("a", "b")
        da.edit("during_a", 1)
        db.edit("during_b", 2)
        assert not harness.run_until(converged(da, db), max_time=30.0)
        # the live direction kept delivering
        assert network.link("b", "a").stats.frames_delivered > 0
        network.heal_one_way("a", "b")
        for _ in range(5):
            sa.release()
            sb.release()
            if harness.run_until(converged(da, db), max_time=120.0):
                break
        assert da.heads() == db.heads()
        assert canonical(da) == canonical(db)
        assert "during_a" in db.keys() and "during_b" in da.keys()

    @pytest.mark.parametrize("v2", [False, True])
    def test_latency_skew_converges(self, v2):
        clock, network, harness, da, db, sa, sb = pairing_harness(
            62, 0.1, v2, v2
        )
        network.set_latency("a", "b", 0.4)
        network.set_latency("b", "a", 0.05)
        assert harness.run_until(converged(da, db), max_time=900.0)
        assert sa.v2_active == v2 and sb.v2_active == v2

    def test_skewed_link_applies_base_delay(self):
        clock = ManualClock()
        network = ChaosNetwork(random.Random(0), clock, ChaosConfig())
        network.set_latency("a", "b", 0.3)
        network.send("a", "b", b"frame")
        assert network.deliver("b") == []          # still in flight
        clock.advance(0.2)
        assert network.deliver("b") == []          # 0.2 < 0.3
        clock.advance(0.2)
        assert network.deliver("b") == [("a", b"frame")]

"""The serving front door of the port (``automerge_tpu_torch.serve``):
``AmServer``, ``DynamicBatcher`` and ``LoadGen`` over the port's
``SyncFarm`` and ``TorchDocFarm`` on the CPU (``device="cpu"``), twins of
the JAX package's tests/test_serve.py, the asyncio adapter on loopback
included."""
import json
import random

import pytest

from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch.errors import (
    AdmissionRejectedError,
    AutomergeError,
    BackpressureError,
    DecodeError,
)
from automerge_tpu_torch.serve import AmServer, BatcherConfig, LoadConfig, LoadGen
from automerge_tpu_torch.sync_session import BackendDriver, SessionConfig, SyncSession
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.testing.chaos import ChaosConfig, ChaosNetwork, ManualClock
from automerge_tpu_torch.tpu.farm import TorchDocFarm


# ---------------------------------------------------------------------- #
# harness helpers


class Client:
    """One test client: a reference-backend replica + supervised session."""

    def __init__(self, actor, clock, seed, config=None):
        self.actor = actor
        self.driver = BackendDriver(Backend.init())
        self.session = SyncSession(
            self.driver, clock=clock, rng=random.Random(seed),
            config=config or SessionConfig(),
        )
        self.seq = 0
        self.max_op = 0

    def edit(self, key, value):
        self.seq += 1
        start = self.max_op + 1
        buf = faults.make_change(
            self.actor, self.seq, start,
            Backend.get_heads(self.driver.backend),
            [faults.set_op(key, value)],
        )
        self.max_op = start
        self.driver.backend, _ = Backend.apply_changes(
            self.driver.backend, [buf]
        )
        return buf

    def heads(self):
        return self.driver.heads()


def make_server(num_docs, clock, *, config=None, threshold=3):
    farm = TorchDocFarm(num_docs, capacity=256, quarantine_threshold=threshold, device="cpu")
    server = AmServer(
        farm, clock=clock, rng=random.Random(7),
        config=config or BatcherConfig(flush_interval=0.05, max_docs=64),
    )
    return farm, server


def drive(server, clients, clock, predicate, max_time=120.0):
    """Pumps frames client<->server directly (no network) until the
    predicate holds or simulated max_time elapses."""
    deadline = clock() + max_time
    while clock() < deadline:
        if predicate():
            return True
        moved = False
        for cid, client in clients.items():
            frame = client.session.poll()
            if frame is not None:
                moved = True
                try:
                    server.receive(cid, frame)
                except AutomergeError:
                    pass  # shed: the client's retransmission is the retry
        if server.tick() is not None:
            moved = True
        for cid, frame in server.pump():
            clients[cid].session.handle(frame)
            moved = True
        clock.advance(0.02 if moved else 0.06)
    return predicate()


# ---------------------------------------------------------------------- #
# session multiplexer


class TestMultiplexer:
    def test_clients_converge_through_the_batched_front_door(self):
        clock = ManualClock()
        farm, server = make_server(2, clock)
        clients = {}
        for i, doc in enumerate([0, 0, 1]):
            client = Client(f"{i:02x}" * 4, clock, seed=i + 1)
            client.edit(f"k{i}", i)
            clients[i] = client
            server.connect(i, doc)

        def converged():
            return (
                clients[0].heads() == farm.get_heads(0)
                and clients[1].heads() == farm.get_heads(0)
                and clients[2].heads() == farm.get_heads(1)
            )

        assert drive(server, clients, clock, converged)
        # co-editors of doc 0 merged each other's edits via the farm
        assert len(farm.get_heads(0)) == 1 or clients[0].heads() == clients[1].heads()

    def test_resume_continues_without_restart_exchange(self):
        clock = ManualClock()
        farm, server = make_server(1, clock)
        client = Client("aa" * 4, clock, seed=3)
        client.edit("x", 1)
        server.connect(0, 0)
        clients = {0: client}
        assert drive(server, clients, clock,
                     lambda: client.heads() == farm.get_heads(0))
        blob = server.save_session(0)
        # server restart: channel rebuilt from the persisted blob
        server.resume(0, 0, blob)
        client.edit("y", 2)
        assert drive(server, clients, clock,
                     lambda: client.heads() == farm.get_heads(0))
        assert client.session.stats["peer_restarts"] == 0  # same epoch

    def test_client_restart_detected_via_epoch_machinery(self):
        clock = ManualClock()
        farm, server = make_server(1, clock)
        client = Client("aa" * 4, clock, seed=4)
        client.edit("x", 1)
        server.connect(0, 0)
        clients = {0: client}
        assert drive(server, clients, clock,
                     lambda: client.heads() == farm.get_heads(0))
        # the client dies and reconnects with a fresh session (new epoch);
        # connect() keeps the server-side session, whose restart detection
        # re-handshakes cleanly
        fresh = Client("aa" * 4, clock, seed=5)
        fresh.driver = client.driver  # same replica, new session state
        fresh.session = SyncSession(fresh.driver, clock=clock,
                                    rng=random.Random(99))
        clients[0] = fresh
        server.connect(0, 0)
        fresh.seq, fresh.max_op = client.seq, client.max_op
        fresh.edit("y", 2)
        assert drive(server, clients, clock,
                     lambda: fresh.heads() == farm.get_heads(0))
        channel = server.channels[0]
        assert channel.session.stats["peer_restarts"] == 1

    def test_converged_channels_go_quiet(self):
        """The advert-suppression path: once a pair converges, repeated
        pumping produces no frames and no new sequence numbers (without
        it, ack->regenerate chatter spins forever)."""
        clock = ManualClock()
        farm, server = make_server(1, clock)
        client = Client("aa" * 4, clock, seed=6)
        client.edit("x", 1)
        server.connect(0, 0)
        clients = {0: client}
        assert drive(server, clients, clock,
                     lambda: client.heads() == farm.get_heads(0))
        # drain whatever acks are still owed
        drive(server, clients, clock, lambda: False, max_time=10.0)
        seq_before = (client.session.seq_out,
                      server.channels[0].session.seq_out)
        for _ in range(25):
            assert client.session.poll() is None
            server.wake(0)
            assert server.pump() == []
            clock.advance(0.1)
        assert (client.session.seq_out,
                server.channels[0].session.seq_out) == seq_before


# ---------------------------------------------------------------------- #
# dynamic batcher: flush boundaries


def handshake_frame(clock, seed=11):
    """A fresh client's first payload frame (a sync handshake)."""
    client = Client("cc" * 4, clock, seed=seed)
    return client, client.session.poll()


class TestBatcherFlushBoundaries:
    def make(self, clock, num_docs=4, max_docs=3, pending=8):
        return make_server(
            num_docs, clock,
            config=BatcherConfig(flush_interval=0.05, max_docs=max_docs,
                                 max_pending_per_tenant=pending),
        )

    def test_timer_only_flush(self):
        """T elapses with fewer than N dirty docs -> the window flushes on
        the timer."""
        clock = ManualClock()
        farm, server = self.make(clock)
        for i, doc in enumerate((0, 1)):
            client, frame = handshake_frame(clock, seed=20 + i)
            server.connect(i, doc)
            server.receive(i, frame)
        assert not server.batcher.due()          # 2 dirty docs < N=3
        assert server.tick() is None
        clock.advance(0.05)
        assert server.batcher.due()
        report = server.tick()
        assert report is not None
        assert len(report.committed) == 2
        assert server.batcher.pending == 0

    def test_count_only_flush(self):
        """N distinct docs dirty before T -> due immediately."""
        clock = ManualClock()
        farm, server = self.make(clock)
        for i, doc in enumerate((0, 1, 2)):
            client, frame = handshake_frame(clock, seed=30 + i)
            server.connect(i, doc)
            server.receive(i, frame)
        assert server.batcher.due()              # no clock advance needed
        report = server.tick()
        assert len(report.committed) == 3

    def test_empty_ticks_dispatch_nothing(self):
        clock = ManualClock()
        farm, server = self.make(clock)
        assert server.tick() is None
        report = server.batcher.flush()
        assert not report.dispatched
        assert report.committed == [] and report.docs_dispatched == 0
        clock.advance(1.0)
        assert server.tick() is None             # still nothing queued

    def test_doc_quarantined_mid_window_is_excluded_from_its_flush(self):
        clock = ManualClock()
        farm, server = self.make(clock)
        client = Client("aa" * 4, clock, seed=41)
        client.edit("x", 1)
        server.connect(0, 0)
        frame = client.session.poll()             # first payload frame
        server.receive(0, frame)                  # admitted: doc is clean
        # the doc quarantines AFTER admission, before the flush
        farm.quarantine[0] = DecodeError("poisoned mid-window")
        clock.advance(0.05)
        report = server.tick()
        assert report.shed_quarantined == 1
        assert report.committed == []
        # not acked: the server's seq watermark did not move, so the
        # client's retransmission retries after release
        assert server.channels[0].session.last_seen == 0
        farm.release_quarantine(0)
        assert drive(server, {0: client}, clock,
                     lambda: client.heads() == farm.get_heads(0))

    def test_backpressure_releases_after_drain(self):
        clock = ManualClock()
        farm, server = self.make(clock, pending=2)
        frames = []
        for i in range(3):
            client, frame = handshake_frame(clock, seed=50 + i)
            server.connect(i, i % 4, tenant="tenantA")
            frames.append(frame)
        server.receive(0, frames[0])
        server.receive(1, frames[1])
        with pytest.raises(BackpressureError):
            server.receive(2, frames[2])
        assert server.batcher.pending_for("tenantA") == 2
        clock.advance(0.05)
        assert server.tick() is not None          # window drains
        server.receive(2, frames[2])              # budget released
        assert server.batcher.pending_for("tenantA") == 1

    def test_quarantined_doc_rejected_at_admission(self):
        clock = ManualClock()
        farm, server = self.make(clock)
        farm.quarantine[2] = DecodeError("already poisoned")
        client, frame = handshake_frame(clock, seed=60)
        server.connect(9, 2)
        with pytest.raises(AdmissionRejectedError):
            server.receive(9, frame)
        assert server.batcher.pending == 0


# ---------------------------------------------------------------------- #
# FarmApplyResult.applied / .quarantined


class TestFarmApplyResultAccessors:
    def test_applied_and_quarantined_partition_the_outcomes(self):
        farm = TorchDocFarm(3, capacity=64, device="cpu")
        buf = faults.make_change("aa" * 4, 1, 1, [],
                                [faults.set_op("k", 1)])
        result = farm.apply_changes([[buf], [faults.garbage(48)], []])
        assert set(result.applied) == {0, 2}
        assert set(result.quarantined) == {1}
        assert all(o.status == "applied" for o in result.applied.values())
        assert result.quarantined[1].error_kind == "decode"
        # the two views partition the outcome list exactly
        assert len(result.applied) + len(result.quarantined) == len(result.outcomes)

    def test_applied_includes_fallback_served_docs(self):
        farm = TorchDocFarm(1, capacity=64, device="cpu")
        buf = faults.make_change("aa" * 4, 1, 1, [],
                                [faults.set_op("k", 1)])
        with faults.inject("farm.device_dispatch", faults.fail_always()):
            result = farm.apply_changes([[buf]])
        assert set(result.applied) == {0}
        assert result.applied[0].fallback is True


# ---------------------------------------------------------------------- #
# parity: batched serving path vs direct apply_changes (acceptance)


class TestServingParity:
    def test_patches_bit_for_bit_vs_direct_apply(self):
        """Every patch the batcher fans out must be byte-identical to the
        same deliveries applied through direct apply_changes calls (the
        style of tests/test_parity_incremental.py)."""
        clock = ManualClock()
        farm, server = make_server(4, clock)
        mirror = TorchDocFarm(4, capacity=256, device="cpu")
        clients = {}
        for i in range(4):
            client = Client(f"{i:02x}" * 4, clock, seed=70 + i)
            client.edit(f"a{i}", i)
            client.edit(f"b{i}", i * 10)
            clients[i] = client
            server.connect(i, i)

        flushed = []
        original_tick = server.tick

        def recording_tick():
            report = original_tick()
            if report is not None and report.changes_by_doc:
                flushed.append(report)
            return report

        server.tick = recording_tick

        def converged():
            return all(
                clients[i].heads() == farm.get_heads(i) for i in range(4)
            )

        assert drive(server, clients, clock, converged)
        assert flushed, "no change-carrying flush happened"

        # replay the exact per-flush groupings through direct calls
        for report in flushed:
            per_doc = [[] for _ in range(4)]
            for doc, changes in report.changes_by_doc.items():
                per_doc[doc] = list(changes)
            mirror_patches = mirror.apply_changes(per_doc)
            served = {
                channel.doc: patch
                for channel, patch in report.committed
                if channel.doc in report.changes_by_doc
            }
            for doc, patch in served.items():
                assert json.dumps(patch, sort_keys=True) == json.dumps(
                    mirror_patches[doc], sort_keys=True
                ), f"patch divergence on doc {doc}"
        for d in range(4):
            assert mirror.get_heads(d) == farm.get_heads(d)
            assert json.dumps(mirror.get_patch(d), sort_keys=True) == (
                json.dumps(farm.get_patch(d), sort_keys=True)
            )


# ---------------------------------------------------------------------- #
# chaos + poison composition (acceptance)


class TestChaosPoisonComposition:
    def test_serve_loop_survives_chaos_plus_poison(self):
        """30% per-link chaos composed with a 12.5%-poison workload: no
        crash, poisoned docs quarantine and shed at admission, every
        client on a clean doc still converges."""
        farm = TorchDocFarm(16, capacity=256, device="cpu")
        config = LoadConfig(
            clients=48, docs=16, edits_per_client=2, ops_per_edit=2,
            spread=0.5, chaos=0.3, poison=0.125, seed=13, max_time=600.0,
        )
        harness = LoadGen(farm, config)
        report = harness.run()
        assert report["poisoned_docs"] == 2
        # the poison quarantined its docs, nothing else
        assert set(farm.quarantine) <= harness.poison_docs
        assert report["quarantined_docs"] >= 1
        # quarantine-aware shedding engaged at the front door
        assert report["admission"]["rejected_quarantine"] > 0 or (
            report["frames_shed"] > 0
        )
        # all surviving (clean-doc) clients converged — no crash, no stall
        assert report["converged"], report
        assert report["unconverged_clients"] == 0

    def test_loadgen_deterministic_per_seed(self):
        def run(seed):
            farm = TorchDocFarm(4, capacity=256, device="cpu")
            config = LoadConfig(clients=8, docs=4, edits_per_client=1,
                                ops_per_edit=2, spread=0.2, chaos=0.2,
                                seed=seed, max_time=300.0)
            report = LoadGen(farm, config).run()
            return (report["simulated_s"], report["dispatches"],
                    report["changes_committed"], report["converged"])

        assert run(5) == run(5)


# ---------------------------------------------------------------------- #
# chaos transport helpers added for the serve harness


class TestChaosNetworkAggregates:
    def test_in_flight_and_next_arrival(self):
        clock = ManualClock()
        net = ChaosNetwork(random.Random(0), clock,
                           ChaosConfig(delay=1.0, min_delay=0.5,
                                       max_delay=0.5))
        assert net.in_flight == 0
        assert net.next_arrival() is None
        net.send("a", "b", b"x")
        net.send("b", "a", b"y")
        assert net.in_flight == 2
        arrival = net.next_arrival()
        assert arrival == pytest.approx(0.5)
        clock.advance(0.6)
        assert net.deliver("b") == [("a", b"x")]
        assert net.in_flight == 1


# ---------------------------------------------------------------------- #
# asyncio adapter (real transport smoke)


class TestAsyncioAdapter:
    def test_hello_and_sync_over_streams(self):
        import asyncio
        import socket

        # reserve an ephemeral loopback port for the adapter
        probe = socket.socket()
        try:
            probe.bind(("127.0.0.1", 0))
        except OSError as exc:
            probe.close()
            pytest.skip(f"loopback unavailable: {exc}")
        port = probe.getsockname()[1]
        probe.close()

        async def main():
            farm = TorchDocFarm(1, capacity=256, device="cpu")
            server = AmServer(farm, rng=random.Random(1),
                              config=BatcherConfig(flush_interval=0.02))
            task = asyncio.ensure_future(
                server.serve_forever("127.0.0.1", port)
            )
            await asyncio.sleep(0.1)
            loop = asyncio.get_event_loop()
            client = Client("aa" * 4, loop.time, seed=1)
            client.edit("x", 1)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            hello = b"HELLO c1 0 default"
            writer.write(len(hello).to_bytes(4, "big") + hello)
            await writer.drain()

            async def read_frame():
                header = await reader.readexactly(4)
                return await reader.readexactly(int.from_bytes(header, "big"))

            deadline = loop.time() + 15.0
            while loop.time() < deadline:
                if farm.get_heads(0) and client.heads() == farm.get_heads(0):
                    break
                frame = client.session.poll()
                if frame is not None:
                    writer.write(len(frame).to_bytes(4, "big") + frame)
                    await writer.drain()
                try:
                    client.session.handle(
                        await asyncio.wait_for(read_frame(), 0.1)
                    )
                except asyncio.TimeoutError:
                    pass
            writer.close()
            task.cancel()
            return bool(farm.get_heads(0)) and (
                client.heads() == farm.get_heads(0)
            )

        try:
            converged = asyncio.new_event_loop().run_until_complete(
                asyncio.wait_for(main(), 30.0)
            )
        except (OSError, RuntimeError) as exc:
            pytest.skip(f"asyncio loopback unavailable: {exc}")
        assert converged

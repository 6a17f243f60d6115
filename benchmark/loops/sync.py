"""The ``sync`` loop: a server farm and one farm per replica, each with a
``SyncFarm``, all on one card. Each step is an epoch: every replica
applies its new changes to its own farm (one ``apply_changes`` each),
then the server and the replicas sync until no message moves, sweep by
sweep as ``chip_smoke.sync_until_quiet`` does, over sync states that
persist from epoch to epoch (a server keeps its peers' states). An epoch
still moving messages after `MAX_SWEEPS` sweeps is given up and counted.
The control delivers each epoch's changes straight to every other farm
instead (`ControlDriver`)."""
from __future__ import annotations

import time

from harness import cells

#: sweeps after which an epoch that still moves messages is given up
MAX_SWEEPS = 64


def farm_count(stream) -> int:
    return 1 + stream.sources


def build(cfg, mix, stream, device):
    """The server's farm and the replicas', each with a SyncFarm."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    farms = [TorchDocFarm(stream.docs, capacity=cfg["capacity"],
                          device=device) for _ in range(farm_count(stream))]
    return farms, [SyncFarm(f) for f in farms]


class Driver(cells.Driver):
    def __init__(self, stream, mix, farms, syncs=None, device="cuda"):
        super().__init__(stream, mix, farms, syncs, device)
        if self.syncs:
            n, peers = stream.docs, len(farms) - 1
            self.s_states = [[self.syncs[0].init_state() for _ in range(n)]
                             for _ in range(peers)]
            self.r_states = [[self.syncs[0].init_state() for _ in range(n)]
                             for _ in range(peers)]

    def run_step(self, step):
        t_epoch = time.perf_counter()
        ch = self.stream.changes
        made = []
        for r, idxs in step:
            self._apply(1 + r, idxs, delivered=True)
            made.extend(idxs)
        if self.in_window:
            self.made.extend(made)
            self.epochs += 1
        pending = [(ch.doc[i], ch.actor[i], ch.seq[i]) for i in made]
        for _ in range(MAX_SWEEPS):
            moved = self._sweep()
            t_end = time.perf_counter()
            if self.in_window:
                self.sweeps += 1
            still = []
            for d, actor, seq in pending:
                if all(self.known.get((f, d), {}).get(actor, 0) >= seq
                       for f in range(len(self.farms))):
                    if self.in_window:
                        self.lag_ms.append((t_end - t_epoch) * 1e3)
                else:
                    still.append((d, actor, seq))
            pending = still
            if not moved:
                return
        self.unquiesced += 1

    def _generate(self, sync, channels):
        t0 = time.perf_counter()
        with self.span("sync.generate_messages"):
            out = sync.generate_messages(channels)
        dt = time.perf_counter() - t0
        if self.in_window:
            self.generate_s += dt
            self.program_s += dt
        return out

    def _receive(self, f, batch):
        t0 = time.perf_counter()
        with self.span("sync.receive_messages"):
            out = self.syncs[f].receive_messages(batch)
            cells.synchronize(self.device)
        if self.in_window:
            self.program_s += time.perf_counter() - t0
        for (d, _, _), (_, patch) in zip(batch, out):
            if patch is not None:
                self._observe(f, d, patch)
        return out

    def _sweep(self) -> int:
        """One sweep: each replica generates for its channels and the
        server receives (one call per replica), then the server generates
        for every channel in one call and each replica receives. Returns
        the messages moved."""
        docs = self.stream.docs
        replicas = len(self.farms) - 1
        moved = nbytes = 0
        for r in range(replicas):
            out = self._generate(self.syncs[1 + r], [
                (d, self.r_states[r][d]) for d in range(docs)])
            batch = []
            for d, (state, msg) in enumerate(out):
                self.r_states[r][d] = state
                if msg is not None:
                    batch.append((d, self.s_states[r][d], msg))
            moved += len(batch)
            nbytes += sum(len(m) for _, _, m in batch)
            if batch:
                for (d, _, _), (state, _) in zip(batch,
                                                 self._receive(0, batch)):
                    self.s_states[r][d] = state
        out = self._generate(self.syncs[0], [
            (d, self.s_states[r][d]) for r in range(replicas)
            for d in range(docs)])
        for r in range(replicas):
            batch = []
            for d in range(docs):
                state, msg = out[r * docs + d]
                self.s_states[r][d] = state
                if msg is not None:
                    batch.append((d, self.r_states[r][d], msg))
            moved += len(batch)
            nbytes += sum(len(m) for _, _, m in batch)
            if batch:
                for (d, _, _), (state, _) in zip(
                        batch, self._receive(1 + r, batch)):
                    self.r_states[r][d] = state
        cells.synchronize(self.device)
        if self.in_window:
            self.sync_bytes += nbytes
        return moved


class ControlDriver(Driver):
    """An epoch with every change delivered straight to every other farm
    instead of a sync."""

    def run_step(self, step):
        made = []
        for r, idxs in step:
            self._apply(1 + r, idxs, delivered=True)
            made.extend(idxs)
        if self.in_window:
            self.made.extend(made)
            self.epochs += 1
        for f in range(len(self.farms)):
            mine = {i for r, idxs in step if 1 + r == f for i in idxs}
            self._apply(f, [i for i in made if i not in mine],
                        delivered=False)

#!/usr/bin/env python3
"""Chip smoke run of automerge_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build the CUDA kernels from ``automerge_tpu_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, started together), timed;
2. hold each Bloom kernel against its plain PyTorch version on the card,
   bit-exact, at edge shapes (see ``edge_checks``: ragged packed blocks,
   the cluster split, a modulo with bit 31 set, negative counts);
3. the main path: a server ``TorchDocFarm`` of ``--docs`` (512)
   map/counter documents and 8 replica farms of the same documents. Each
   replica makes 8 changes of 16 ops to every document (sets on 64 root
   keys; increments on the counter its first change creates), then the
   replicas sync with the server over the Bloom protocol (``SyncFarm``)
   until no message moves: one ``generate_messages`` call over all 8 x
   ``--docs`` server channels per sweep, one ``receive_messages`` call per
   replica. Every farm must end
   with equal heads and equal whole-document patches, and both Bloom
   kernels must have launched; the launches are logged by shape. The
   kernels are then held against their plain versions again on the
   inputs of their largest main-path launch and timed there: device time
   per launch from a CUDA-graph replay, time per eager call, the launch
   floor, and the profiler's kernel mean as a cross-check
   (``kernel_times``);
4. the same scenario at 16 documents, then phase 11's mixed v1/v2 sync
   and phase 13's supervised channels at 16 documents, phase 15's store
   at 16 documents, and phase 16's serving at 64 clients over 16 docs with
   30 % chaos and a store attached, once on the card and once on the CPU:
   every sync message, patch, session frame, saved session, load report
   and store file must be byte-identical;
5. hold the LEB128 segmented-sum kernel against its plain version on the
   card, bit-exact, at edge inputs (``segsum_edge_inputs``), each of which
   must take the pass its ids call for (the sorted pass, or the general
   pass behind a descending pair), and run streams of 1- to 8-byte
   varints (unsigned and signed) through the device scan;
6. the repo's configuration 2 ("Automerge.Text: 2-actor concurrent
   insert/delete, 10k ops") on ``BatchedTextEngine`` at ``--text-docs``
   (1,024) documents: a 64-insert seed, then 100 rounds of one 50-op
   change per actor per doc (80 % inserts, 20 % deletes, tied counters).
   Every doc's visible length must match the traffic and 32 sampled docs
   must equal a plain host reference;
7. the same per-doc traffic through a server ``TorchDocFarm`` and one
   replica farm per actor at ``--farm-text-docs`` (3) documents (one change
   per doc per ``apply_changes`` call), then the Bloom sync until no
   message moves. Every farm must converge, every whole-doc patch (device
   RGA rank + mirror) must equal the farm's embedded sequential walk's,
   and both Bloom kernels must have launched;
8. the device LEB128 scan (kernel 3) over the varint stream of every
   change buffer of phases 3 and 7, equal to the NumPy pass, with one
   torch.profiler trace of the scan (``scan_breakdown``); the kernel
   must have taken its sorted pass there, and is then held against its
   plain version at that launch and timed (``leb_timings``: warm, cold,
   and on the same rows and ids shuffled, which takes the general pass);
9. phase 7 at 2 docs x 20 changes and phase 6 at 16 docs, once on the
   card and once on the CPU: messages, patches, ranks and texts must be
   byte-identical;
10. long histories (``run_long_history``): a server farm holds 2 map/counter
   documents of 10,000 changes (4 ops each); a fresh peer farm joins over
   the Bloom sync, then each side makes 8 changes per doc and they
   reconnect from a fresh sync state. Both farms must converge, and the
   sync must have built a filter on a cluster of blocks (the split
   build) and queried a live filter with more than 256 candidates. The
   Bloom kernels are held against their plain versions on the inputs of
   this phase's largest launches and timed there: the ``wide`` entry of
   their rows;
11. mixed-protocol sync (``--v2-docs``, 128): phase 3's scenario with
   replicas 0-3 on sync v2 channels and 4-7 on v1, so every sweep
   launches both Bloom kernels and resolves the v2 channels' fingerprint
   queries in one reduction per generate call. Every farm must converge,
   each ``SyncFarm.generate_messages`` call whose v2 channels planned
   queries must dispatch exactly one reduction (and any other call none),
   and the Bloom kernels are held against their plain versions at this
   phase's largest launches (the ``mixed`` entry of their rows); the
   reduction is checked against NumPy and timed at its largest launch;
12. phase 10's scenario over v2 on phase 10's loaded server: a fresh peer
   joins, then 8 changes a side and a reconnect. Both must converge
   within 2*log2(n)+2 round trips; the bytes moved are set beside phase
   10's v1;
13. supervised channels (``SESSION_DOCS``, 16): per doc a host client
   (``backend``) against the farm through two ``SyncSession``s over a link
   that drops 30 % of frames, on a fake clock, half the pairs on v2; every
   session is saved and restored mid-run. Every client must converge with
   the farm, and a v1 pair must carry plain v1 messages;
14. a device fault (``--fault-docs``, 64, plus 2 list docs): the farm's
   ``farm.device_dispatch`` point fails with one doc in the batch; the
   bisection probes run on the card, the doc is quarantined (error kind
   "device") and rolled back, the survivors are served by the sequential
   walk with a fault-free control farm's patches, and keep applying after;
   then every dispatch fails, and nobody is blamed;
15. the store (``--store-docs``, 256, x 6 rounds x one 256-op change: the
   JAX package's STORE_r01.json shape): the deliveries through a bare farm
   and through one with a ``ShardStore`` attached (fsync on), in turns
   bare, WAL, WAL, bare; the per-doc sequential loads of 16 docs against
   ``open_farm``'s batched cold start on the card, a clean recovery report
   and hydrated patches equal to the writer's for every doc, a fresh
   replica caught up over the Bloom sync, and, after one more round logged
   by the hydrated farm, a torn tail that recovers exactly the acked prefix
   (``run_store``);
16. the serving front door (``--serve-clients`` 1,024 over 128 docs, one
   doc per 8 clients: the JAX package's SERVE_r06.json shape cut from
   10,000 over 1,024): ``LoadGen``'s clients against ``AmServer`` and its
   ``DynamicBatcher`` over the farm on the card, 2 edits of 4 ops per
   client over 2.0 simulated s, the default batcher and session settings.
   Every client must converge (``run_serve``). Phases 15 and 16 hold both
   Bloom kernels bit-exact against their plain versions at their largest
   launches there.

Every fault-free phase (3, 4, 6, 7, 10-13, 15, 16) fails if the degraded walk served
a document (``farm.fallback.calls`` moved, or a farm has ``degraded``
docs): only phase 14's injected fault may take it.

Each path's kernel launch counts are set to 0 just before it runs and
read just after. The line before the last is the kernel table (JSON); the
last line is ``{"ok": true, "device": {...}}``. Weights are the documents
themselves, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores

# phase 3 per document: replicas, changes per replica, ops per change
MAP_REPLICAS, MAP_CHANGES, MAP_OPS = 8, 8, 16
# configuration 2 per document: changes per actor, ops per change (2 actors)
TEXT_CHANGES, TEXT_OPS = 100, 50
# phase 10 per document: history changes, ops per change, changes each side
# makes before it reconnects
LONG_CHANGES, LONG_OPS, LONG_NEW = 10_000, 4, 8
# phase 11: replicas 0-3 sync over v2 channels, 4-7 over v1
MIXED_V2_REPLICAS = 4
# phase 13: the share of session frames the link drops (the JAX package's
# SYNC_r01 soak loss)
SESSION_LOSS = 0.3
# phase 13: the documents, one supervised pair each (phase 4 runs as many)
SESSION_DOCS = 16
V2_TYPE = 0x45  # leading byte of a sync v2 message (sync_v2.py)


def log(*args):
    print(*args, flush=True)


def decode_cache_env(docs, replicas=MAP_REPLICAS, changes=MAP_CHANGES):
    """The decode-LRU settings (read by columnar.py at import) sized to
    phase 3's working set. They are deployment settings: every distinct
    change is re-read by every farm and by thousands of channels per
    sweep, and the defaults (8,192 changes, 16,384 metas) hold an eighth
    of the 65,536 changes of 1,024 docs, which makes the caches thrash."""
    cap = str(2 * docs * replicas * changes)
    return {"AM_DECODE_CACHE_CHANGES": cap, "AM_DECODE_CACHE_METAS": cap,
            "AM_DECODE_CACHE_BYTES": str(1 << 30)}


# ---------------------------------------------------------------------- #
# the scenario: replicas edit, then sync with the server until quiescent


def make_edits(docs, replicas, changes, ops, seed, first_actor=1,
               base=None):
    """Per replica, per change index, one change buffer per document: the
    first change sets the replica's counter and 15 root keys, later ones
    increment that counter and set 15 root keys (a set names the
    replica's previous op on its key as pred). Replica r's actor is
    number ``first_actor + r``. ``base``, when given, is (per-doc heads,
    largest op counter) of the history the changes build on: the first
    change of each doc depends on those heads, and op counters continue
    above it."""
    from automerge_tpu_torch.columnar import decode_change_columns, encode_change

    rng = np.random.default_rng(seed)
    base_heads, base_op = base or ([[] for _ in range(docs)], 0)
    out = []
    for r in range(replicas):
        actor = f"{r + first_actor:02x}" * 16
        per_change = []
        heads = [list(h) for h in base_heads]
        last = [dict() for _ in range(docs)]
        keys = rng.integers(0, 64, size=(changes, docs, ops - 1))
        vals = rng.integers(0, 1 << 20, size=(changes, docs, ops - 1))
        incs = rng.integers(1, 10, size=(changes, docs))
        for c in range(changes):
            start = base_op + c * ops + 1
            bufs = []
            for d in range(docs):
                if c == 0:
                    first = {"action": "set", "obj": "_root", "key": "ctr",
                             "value": 0, "datatype": "counter", "pred": []}
                else:
                    first = {"action": "inc", "obj": "_root", "key": "ctr",
                             "value": int(incs[c, d]),
                             "pred": [f"{base_op + 1}@{actor}"]}
                body = [first]
                for i in range(ops - 1):
                    key = f"k{int(keys[c, d, i])}"
                    pred = [last[d][key]] if key in last[d] else []
                    last[d][key] = f"{start + 1 + i}@{actor}"
                    body.append({"action": "set", "obj": "_root", "key": key,
                                 "datatype": "uint",
                                 "value": int(vals[c, d, i]), "pred": pred})
                buf = encode_change({"actor": actor, "seq": c + 1,
                                     "startOp": start, "time": 0,
                                     "deps": heads[d], "ops": body})
                heads[d] = [decode_change_columns(buf)["hash"]]
                bufs.append(buf)
            per_change.append(bufs)
        out.append(per_change)
    return out


def canon(x):
    return json.dumps(x, sort_keys=True)


def run_scenario(device, docs, replicas, changes, ops, seed, record=None,
                 prof=None, v2_replicas=0):
    """Builds the farms, applies the replicas' edits, syncs to quiescence
    (replicas below `v2_replicas` over sync v2 channels, the rest over v1).
    Returns (farms, stats). `record` (a list) collects every sync message
    and every patch in order, for the card-vs-CPU comparison."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    prof = prof or PhaseProfile(enabled=False)
    capacity = changes * ops * replicas
    server = TorchDocFarm(docs, capacity=capacity, device=device)
    farms = [TorchDocFarm(docs, capacity=capacity, device=device)
             for _ in range(replicas)]
    ssync = SyncFarm(server)
    rsyncs = [SyncFarm(f) for f in farms]
    edits = make_edits(docs, replicas, changes, ops, seed)

    def rec(x):
        if record is not None:
            record.append(x)

    stats = {"sweeps": [], "edit_s": 0.0}
    with use_profile(prof):
        t0 = time.perf_counter()
        for farm, per_change in zip(farms, edits):
            for bufs in per_change:
                result = farm.apply_changes([[b] for b in bufs])
                if result.quarantined:
                    raise RuntimeError(f"edit quarantined: {result.quarantined}")
                rec([canon(p) for p in result])
        _sync(device)
        stats["edit_s"] = time.perf_counter() - t0
        rows0 = sum(int(f.engine.lengths.sum()) for f in [server, *farms])

        t_sync = time.perf_counter()
        stats["sweeps"] = sync_until_quiet(device, ssync, rsyncs, docs, rec,
                                           v2_replicas)
        stats["sync_s"] = time.perf_counter() - t_sync
    rows1 = sum(int(f.engine.lengths.sum()) for f in [server, *farms])
    stats["merged_rows"] = rows1 - rows0
    stats["buffers"] = [b for per_change in edits for bufs in per_change
                        for b in bufs]
    stats["syncs"] = [ssync, *rsyncs]
    return [server, *farms], stats


class Sweep(NamedTuple):
    """One sync sweep: wall seconds, messages moved, how many of them were
    sync v2 messages, and their bytes."""

    seconds: float
    moved: int
    v2_moved: int
    bytes: int


def sync_until_quiet(device, ssync, rsyncs, docs, rec, v2_replicas=0):
    """The replicas sync with the server until no message moves: per
    sweep, each replica generates for its channels and the server receives
    them (one call per replica), then the server generates for every
    channel in one call and each replica receives. Replicas below
    `v2_replicas` (and the server's channels to them) run sync v2, the
    rest the Bloom protocol. Returns [Sweep]."""
    from automerge_tpu_torch import SyncFarm

    replicas = len(rsyncs)
    s_states = [[SyncFarm.init_state() for _ in range(docs)]
                for _ in range(replicas)]
    r_states = [[SyncFarm.init_state() for _ in range(docs)]
                for _ in range(replicas)]
    server_protocols = [("v2" if r < v2_replicas else "v1")
                        for r in range(replicas) for _ in range(docs)]
    sweeps = []
    for _sweep in range(64):
        t_sweep = time.perf_counter()
        moved = v2_moved = nbytes = 0

        def count(batch):
            nonlocal moved, v2_moved, nbytes
            moved += len(batch)
            v2_moved += sum(m[0] == V2_TYPE for _, _, m in batch)
            nbytes += sum(len(m) for _, _, m in batch)

        # replicas -> server: one receive call per replica (distinct docs)
        for r in range(replicas):
            out = rsyncs[r].generate_messages(
                [(d, r_states[r][d]) for d in range(docs)],
                protocols=["v2" if r < v2_replicas else "v1"] * docs)
            batch = []
            for d, (state, msg) in enumerate(out):
                r_states[r][d] = state
                rec(msg)
                if msg is not None:
                    batch.append((d, s_states[r][d], msg))
            count(batch)
            if batch:
                for (d, _, _), (state, patch) in zip(
                        batch, ssync.receive_messages(batch)):
                    s_states[r][d] = state
                    rec(canon(patch) if patch is not None else None)
        # server -> replicas: every channel in one generate call
        out = ssync.generate_messages(
            [(d, s_states[r][d]) for r in range(replicas)
             for d in range(docs)], protocols=server_protocols)
        for r in range(replicas):
            batch = []
            for d in range(docs):
                state, msg = out[r * docs + d]
                s_states[r][d] = state
                rec(msg)
                if msg is not None:
                    batch.append((d, r_states[r][d], msg))
            count(batch)
            if batch:
                for (d, _, _), (state, patch) in zip(
                        batch, rsyncs[r].receive_messages(batch)):
                    r_states[r][d] = state
                    rec(canon(patch) if patch is not None else None)
        _sync(device)
        sweeps.append(Sweep(time.perf_counter() - t_sweep, moved, v2_moved,
                            nbytes))
        if moved == 0:
            return sweeps
    raise RuntimeError("sync did not quiesce in 64 sweeps")


def log_sweeps(sweeps):
    for i, sw in enumerate(sweeps):
        log(f"  sweep {i}: {sw.seconds * 1e3:.1f} ms, {sw.moved} messages "
            f"({sw.moved - sw.v2_moved} v1, {sw.v2_moved} v2), {sw.bytes} "
            "bytes")


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_converged(farms, docs):
    """Every doc on every farm: equal heads and canonical-JSON-equal
    whole-document patches. Returns the server's patches."""
    patches = []
    for d in range(docs):
        heads = farms[0].get_heads(d)
        want = canon(farms[0].get_patch(d))
        for f in farms[1:]:
            if f.get_heads(d) != heads:
                raise RuntimeError(f"doc {d}: heads differ across farms")
            if canon(f.get_patch(d)) != want:
                raise RuntimeError(f"doc {d}: patches differ across farms")
        patches.append(want)
    return patches


def run_long_history(device, docs, changes, ops, new, seed, v2=False,
                     server=None, actors=(2, 3)):
    """A fresh peer joins documents with a long history, then both sides
    edit and reconnect without their sync state. The server farm is
    loaded with `changes` changes of `ops` ops per doc by one actor, in
    one ``apply_changes`` call (set-up: the history it accumulated
    before), unless a loaded `server` farm is given. An empty peer farm
    syncs with it until no message moves: the server's first filter holds
    a doc's whole history, and it queries that history against the peer's
    empty filter. Then the peer and the server each make `new` changes
    per doc on top of the history (as `actors`), both start again from
    Automerge's ``initSyncState`` (a client that does not persist its
    sync state reconnects), and they sync until quiet: each side's filter
    holds its whole history, and each queries its whole history against
    the other's. With `v2` every channel runs sync v2 instead. Returns
    (farms, stats)."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    capacity = (changes + 2 * new) * ops
    stats = {"load_s": 0.0}
    if server is None:
        server = TorchDocFarm(docs, capacity=capacity, device=device)
        history = make_edits(docs, 1, changes, ops, seed)[0]
        t0 = time.perf_counter()
        result = server.apply_changes(
            [[history[c][d] for c in range(changes)] for d in range(docs)])
        if result.quarantined:
            raise RuntimeError(f"history quarantined: {result.quarantined}")
        _sync(device)
        stats["load_s"] = time.perf_counter() - t0
    peer = TorchDocFarm(docs, capacity=capacity, device=device)
    ssync, psync = SyncFarm(server), SyncFarm(peer)
    v2_replicas = 1 if v2 else 0
    t0 = time.perf_counter()
    stats["join"] = sync_until_quiet(device, ssync, [psync], docs,
                                     lambda _: None, v2_replicas)
    stats["join_s"] = time.perf_counter() - t0
    base = ([server.get_heads(d) for d in range(docs)],
            max(server.max_op[:docs]))
    t0 = time.perf_counter()
    for farm, actor in zip((peer, server), actors):
        edits = make_edits(docs, 1, new, ops, seed + actor, first_actor=actor,
                           base=base)[0]
        for bufs in edits:
            result = farm.apply_changes([[b] for b in bufs])
            if result.quarantined:
                raise RuntimeError(f"edit quarantined: {result.quarantined}")
    _sync(device)
    stats["edit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats["rejoin"] = sync_until_quiet(device, ssync, [psync], docs,
                                       lambda _: None, v2_replicas)
    stats["rejoin_s"] = time.perf_counter() - t0
    stats["syncs"] = (ssync, psync)
    return [server, peer], stats


# ---------------------------------------------------------------------- #
# supervised channels: single-document clients and the farm, through
# SyncSessions over a lossy link on a fake clock


class FakeClock:
    """The sessions' injected clock: simulated seconds, advanced by the
    driver (``SyncSession`` calls it for deadlines and backoff)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def drive_sessions(pairs, clock, link, loss, resume=None, resume_step=3,
                   max_steps=20_000):
    """Shuttles frames between session pairs ``[a, b]`` until every pair's
    heads agree and no frame moves. Per step each session polls once (a
    first, then b, pair by pair); the link drops a frame when
    ``link.random() < loss``, else the peer handles it. The clock moves
    0.02 s per busy step and 0.26 s per quiet one, so retransmission
    deadlines come due. At step `resume_step`, `resume(i, pair)` may swap
    pair i for sessions restored from ``save()``. Returns
    (frames [(pair, side, frame bytes, dropped)], steps)."""
    frames = []
    for step in range(max_steps):
        if resume is not None and step == resume_step:
            for i, pair in enumerate(pairs):
                pairs[i] = resume(i, pair)
        busy = False
        for i, pair in enumerate(pairs):
            for side in (0, 1):
                frame = pair[side].poll()
                if frame is None:
                    continue
                busy = True
                dropped = link.random() < loss
                frames.append((i, side, frame, dropped))
                if not dropped:
                    pair[1 - side].handle(frame)
        if not busy and all(a.driver.heads() == b.driver.heads()
                            for a, b in pairs):
            return frames, step
        clock.advance(0.02 if busy else 0.26)
    raise RuntimeError(f"sessions did not converge in {max_steps} steps")


def session_edits(docs, seed):
    """Per doc, the farm's changes and the client's: replicas 0 and 1 of
    phase 3's traffic (8 changes x 16 ops each)."""
    edits = make_edits(docs, 2, MAP_CHANGES, MAP_OPS, seed)
    return ([[edits[0][c][d] for c in range(MAP_CHANGES)] for d in range(docs)],
            [[edits[1][c][d] for c in range(MAP_CHANGES)] for d in range(docs)])


def run_sessions(device, docs, seed, loss=SESSION_LOSS, record=None):
    """Phase 13: per doc, a single-document client (this package's
    ``backend``, on the host) pairs with the farm (on `device`) through two
    ``SyncSession``s, ``BackendDriver`` against the SyncFarm's
    ``FarmDriver``. Pairs of the first half of the docs negotiate sync v2,
    the rest stay v1. Frames cross a link that drops `loss` of them, on a
    fake clock; mid-run every session is saved and restored. Returns
    (farm, clients, pairs, frames, stats)."""
    from automerge_tpu_torch import (BackendDriver, SessionConfig, SyncFarm,
                                     SyncSession, TorchDocFarm)
    from automerge_tpu_torch import backend as Backend

    farm_bufs, client_bufs = session_edits(docs, seed)
    farm = TorchDocFarm(docs, capacity=2 * MAP_CHANGES * MAP_OPS,
                        device=device)
    result = farm.apply_changes(farm_bufs)
    if result.quarantined:
        raise RuntimeError(f"edit quarantined: {result.quarantined}")
    sync = SyncFarm(farm)
    clock = FakeClock()

    def config(d):
        return SessionConfig(enable_v2=d < docs // 2)

    pairs = []
    for d in range(docs):
        client, _ = Backend.apply_changes(Backend.init(), client_bufs[d])
        pairs.append([
            SyncSession(BackendDriver(client), clock=clock,
                        rng=random.Random(seed * 7919 + 2 * d),
                        config=config(d)),
            sync.make_session(d, clock=clock,
                              rng=random.Random(seed * 7919 + 2 * d + 1),
                              config=config(d)),
        ])

    def resume(d, pair):
        blobs = [s.save() for s in pair]
        if record is not None:
            record.extend(blobs)
        rng = [random.Random(seed * 104729 + 2 * d + k) for k in (0, 1)]
        return [
            SyncSession.restore(blobs[0], BackendDriver(pair[0].driver.backend),
                                clock=clock, rng=rng[0], config=config(d)),
            sync.restore_session(d, blobs[1], clock=clock, rng=rng[1],
                                 config=config(d)),
        ]

    t0 = time.perf_counter()
    frames, steps = drive_sessions(pairs, clock, random.Random(seed), loss,
                                   resume)
    _sync(device)
    if steps <= 3:
        raise RuntimeError("the sessions converged before they were saved "
                           "and restored")
    stats = {"s": time.perf_counter() - t0, "steps": steps,
             "sim_s": clock.t}
    if record is not None:
        record.extend(f for _, _, f, _ in frames)
        record.extend(s.save() for pair in pairs for s in pair)
    return farm, [p[0].driver.backend for p in pairs], pairs, frames, stats


def check_sessions(farm, clients, pairs, frames):
    """Phase 13's checks: every client converged with the farm (heads and
    whole-document patch), v2 pairs negotiated v2 and v1 pairs did not,
    and every payload a v1 pair carried is a v1 sync message that
    re-encodes to the same bytes. Returns per protocol {frames, payloads,
    dropped, retransmits, watchdog} totals."""
    from automerge_tpu_torch import backend as Backend
    from automerge_tpu_torch.sync import decode_sync_message, encode_sync_message
    from automerge_tpu_torch.sync_session import decode_frame

    docs = len(pairs)
    for d, (client, (a, b)) in enumerate(zip(clients, pairs)):
        if Backend.get_heads(client) != farm.get_heads(d):
            raise RuntimeError(f"session doc {d}: heads differ")
        if canon(Backend.get_patch(client)) != canon(farm.get_patch(d)):
            raise RuntimeError(f"session doc {d}: patches differ")
        want_v2 = d < docs // 2
        if a.v2_active != want_v2 or b.v2_active != want_v2:
            raise RuntimeError(f"session doc {d}: v2 active {a.v2_active}/"
                               f"{b.v2_active}, want {want_v2}")
        if a.quarantined or b.quarantined:
            raise RuntimeError(f"session doc {d}: channel quarantined")
    totals = {p: dict.fromkeys(("frames", "payloads", "dropped",
                                "retransmits", "watchdog"), 0)
              for p in ("v1", "v2")}
    for d, _side, frame, dropped in frames:
        t = totals["v2" if d < docs // 2 else "v1"]
        t["frames"] += 1
        t["dropped"] += dropped
        payload = decode_frame(frame)["payload"]
        if payload is None:
            continue
        t["payloads"] += 1
        if d >= docs // 2 and (payload[0] == V2_TYPE or encode_sync_message(
                decode_sync_message(payload)) != payload):
            raise RuntimeError(f"session doc {d}: a v1 pair carried a "
                               "payload that is not a plain v1 message")
    for d, pair in enumerate(pairs):
        t = totals["v2" if d < docs // 2 else "v1"]
        for s in pair:
            t["retransmits"] += s.stats["retransmits"]
            t["watchdog"] += (s.stats["stalls"] + s.stats["escalations"]
                              + s.stats["resets"])
    return totals


# ---------------------------------------------------------------------- #
# a device fault: bisection on the card, survivors served by the walk


def fault_traffic(docs, list_docs, seed):
    """Three rounds of deliveries for `docs` map/counter docs followed by
    `list_docs` list/text docs: map docs take replica 0's changes of
    phase 3's traffic (8 changes x 16 ops, one change per doc per round
    except the first, which takes 6), list docs the seed change and then
    actor A's phase-7 changes (a third of 20 per round). Returns the
    rounds' per-doc buffer lists."""
    maps = make_edits(docs, 1, MAP_CHANGES, MAP_OPS, seed)[0]
    maps = [[maps[c][d] for c in range(MAP_CHANGES)] for d in range(docs)]
    traffic = TextTraffic(list_docs, TEXT_OPS, seed)
    seed_buf, rounds = text_change_buffers(traffic, 20)
    text = [[seed_buf] + [rounds[c][0][d] for c in range(20)]
            for d in range(list_docs)]
    cuts = [((0, 6), (0, 8)), ((6, 7), (8, 15)), ((7, 8), (15, 21))]
    return [[m[a:b] for m in maps] + [t[ta:tb] for t in text]
            for (a, b), (ta, tb) in cuts]


FALLBACK_COUNTERS = ("farm.bisect.rounds", "farm.fallback.calls",
                     "farm.fallback.docs", "farm.quarantine.causes.device")


@contextlib.contextmanager
def counting_fallbacks():
    """Turns the degraded walk's counters on alone in this package's
    registry (the rest stays off, as in the phases' measurements) and
    restores each counter's flag on the way out."""
    from automerge_tpu_torch.obs.metrics import get_metrics

    counters = [get_metrics().counter(name) for name in FALLBACK_COUNTERS]
    was = [c.enabled for c in counters]
    for c in counters:
        c.enabled = True
    try:
        yield
    finally:
        for c, on in zip(counters, was):
            c.enabled = on


def fallback_counts():
    """The degraded walk's counters ({name: value}); they move only inside
    `counting_fallbacks`."""
    from automerge_tpu_torch.obs.metrics import get_metrics

    return {name: get_metrics().counter(name).value
            for name in FALLBACK_COUNTERS}


def run_device_fault(device, docs, list_docs, seed):
    """Phase 14: a farm and a fault-free control farm of `docs` map docs
    and `list_docs` list docs take the same deliveries. In round 1 the
    farm's ``farm.device_dispatch`` point fails whenever doc `k` is in the
    dispatched group (``fail_docs``): doc k must be quarantined with error
    kind "device" and rolled back, every survivor walk-served with the
    control's patch, and the counters must move as the JAX package's tests
    assert. Round 2 re-sends k's lost changes with the next ones: every doc
    applies, the degraded docs through their walk, and every whole-doc
    read equals the control's. Round 3 fails every dispatch
    (``fail_always``): nobody is blamed, every doc is walk-served. Returns
    stats."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.testing import faults

    n = docs + list_docs
    capacity = 2 * MAP_CHANGES * MAP_OPS
    farm, control = (TorchDocFarm(n, capacity=capacity, device=device,
                                  quarantine_threshold=None)
                     for _ in range(2))
    rounds = fault_traffic(docs, list_docs, seed)
    k = int(np.random.default_rng(seed).integers(docs))

    def same(got, want, what):
        for d in range(n):
            if canon(got[d]) != canon(want[d]):
                raise RuntimeError(f"{what}: doc {d}'s patch differs from "
                                   "the control farm's")

    def reads_equal(what):
        for d in range(n):
            if farm.get_heads(d) != control.get_heads(d) or canon(
                    farm.get_patch(d)) != canon(control.get_patch(d)):
                raise RuntimeError(f"{what}: doc {d}'s whole-doc read "
                                   "differs from the control farm's")

    def deliver(per_doc, hook=None, control_skips=()):
        want = control.apply_changes(
            [[] if d in control_skips else bufs
             for d, bufs in enumerate(per_doc)])
        fault = (contextlib.nullcontext() if hook is None
                 else faults.inject("farm.device_dispatch", hook))
        with counting_fallbacks(), fault:
            c0 = fallback_counts()
            got = farm.apply_changes(per_doc)
            c1 = fallback_counts()
        _sync(device)
        return got, want, {key: c1[key] - c0[key] for key in c0}

    stats = {"k": k}
    t0 = time.perf_counter()
    got, want, _ = deliver(rounds[0])
    same(got, want, "round 0")
    got, want, counts = deliver(rounds[1], faults.fail_docs([k]), (k,))
    out = got.outcomes[k]
    if (out.status, out.error_kind) != ("quarantined", "device"):
        raise RuntimeError(f"doc {k}: outcome {out.status}/{out.error_kind}, "
                           "want quarantined/device")
    if len(farm.get_all_changes(k)) != len(rounds[0][k]):
        raise RuntimeError(f"doc {k} was not rolled back")
    survivors = [d for d in range(n) if d != k]
    if not all(got.outcomes[d].status == "applied" and got.outcomes[d].fallback
               for d in survivors):
        raise RuntimeError("a survivor was not served by the walk")
    if farm.degraded != set(survivors):
        raise RuntimeError(f"degraded docs {sorted(farm.degraded)}")
    same([got[d] if d != k else want[d] for d in range(n)], want, "round 1")
    want_counts = {"farm.fallback.calls": 1, "farm.fallback.docs": n - 1,
                   "farm.quarantine.causes.device": 1}
    if any(counts[key] != v for key, v in want_counts.items()) or counts[
            "farm.bisect.rounds"] <= 0:
        raise RuntimeError(f"round 1 counters {counts}, want {want_counts} "
                           "and bisect rounds > 0")
    stats["round1"] = counts
    resend = [list(b) for b in rounds[2]]
    resend[k] = rounds[1][k] + resend[k]
    got, want, counts = deliver(resend)
    same(got, want, "round 2")
    if got.quarantined or any(o.fallback for o in got.outcomes) or any(
            counts.values()):
        raise RuntimeError(f"round 2 on a sound device: {counts}")
    reads_equal("round 2")
    more = make_edits(n, 1, 1, MAP_OPS, seed + 9, first_actor=9,
                      base=([farm.get_heads(d) for d in range(n)],
                            max(farm.max_op)))[0][0]
    got, want, counts = deliver([[b] for b in more], faults.fail_always())
    same(got, want, "round 3")
    if got.quarantined or not all(o.fallback for o in got.outcomes):
        raise RuntimeError("a wedged device must blame nobody and walk-serve "
                           "every doc")
    if counts["farm.fallback.docs"] != n or counts[
            "farm.quarantine.causes.device"] != 0:
        raise RuntimeError(f"round 3 counters {counts}")
    reads_equal("round 3")
    stats["round3"] = counts
    stats["s"] = time.perf_counter() - t0
    return stats


def check_no_fallback(before, farms, what):
    """A fault-free phase: no dispatch failed since `before` (a
    `fallback_counts` reading) and no farm walk-serves a document in
    degraded mode — the walk must never pass for the device path."""
    after = fallback_counts()
    if after != before:
        raise RuntimeError(f"{what}: the degraded walk ran ({before} -> "
                           f"{after})")
    for f in farms:
        if f.degraded:
            raise RuntimeError(f"{what}: docs {sorted(f.degraded)} are served "
                               "by the degraded walk")


# ---------------------------------------------------------------------- #
# list/text documents: the repo's configuration 2 ("Automerge.Text:
# 2-actor concurrent insert/delete, 10k ops")

ACTOR_A = "0a" * 16  # the seed author
ACTOR_B = "0b" * 16
TEXT_OBJ = f"1@{ACTOR_A}"  # the seed change's makeText
SEED_INSERTS = 64
LETTERS = [chr(ord("a") + i) for i in range(26)]


class TextTraffic:
    """Configuration 2 traffic for `docs` text documents. A seed change by
    actor A (makeText, then SEED_INSERTS chained inserts) that both actors
    see; then per round one change of `ops` ops from each actor, authored
    concurrently: each actor references only the seed and its own ops.
    80 % of ops insert (10 % of those at _head, the rest after a random
    element live in the author's view), 20 % delete a live element of the
    author's view, so both actors may delete one seed element. Both
    actors' counters start right after the seed, so they tie and order
    breaks on the actor string. Ops are backend-form dicts."""

    def __init__(self, docs, ops, seed):
        self.rng = np.random.default_rng(seed)
        self.docs, self.ops = docs, ops
        seed_elems = [f"{2 + i}@{ACTOR_A}" for i in range(SEED_INSERTS)]
        self.live = {a: [list(seed_elems) for _ in range(docs)]
                     for a in (ACTOR_A, ACTOR_B)}
        self.seed_set = set(seed_elems)
        self.seed_dels = {a: [set() for _ in range(docs)]
                          for a in (ACTOR_A, ACTOR_B)}
        self.inserts = np.full(docs, SEED_INSERTS, np.int64)
        self.deletes = np.zeros(docs, np.int64)
        self.ctr = SEED_INSERTS + 2  # the next change's startOp

    @staticmethod
    def seed_ops():
        """[(op, counter)] of the seed change: makeText, then the inserts,
        each after the previous one."""
        out = [({"action": "makeText", "obj": "_root", "key": "text",
                 "pred": []}, 1)]
        ref = "_head"
        for i in range(SEED_INSERTS):
            out.append(({"action": "set", "obj": TEXT_OBJ, "elemId": ref,
                         "insert": True, "value": LETTERS[i % 26],
                         "pred": []}, 2 + i))
            ref = f"{2 + i}@{ACTOR_A}"
        return out

    def next_round(self):
        """(startOp, per doc [A's ops, B's ops]) of the next round."""
        rng, n, start = self.rng, self.ops, self.ctr
        shape = (2, self.docs, n)
        ins = (rng.random(shape) < 0.8).tolist()
        head = (rng.random(shape) < 0.1).tolist()
        pick = rng.random(shape).tolist()
        val = rng.integers(0, 26, shape).tolist()
        seed_set = self.seed_set
        ids = [[f"{start + i}@{a}" for i in range(n)]
               for a in (ACTOR_A, ACTOR_B)]
        out = []
        for d in range(self.docs):
            pair = []
            n_ins = 0
            for k, actor in enumerate((ACTOR_A, ACTOR_B)):
                live = self.live[actor][d]
                ins_k, head_k, pick_k, val_k = (
                    ins[k][d], head[k][d], pick[k][d], val[k][d])
                own = ids[k]
                ops = []
                for i in range(n):
                    if ins_k[i] or not live:
                        ref = ("_head" if head_k[i] or not live
                               else live[int(pick_k[i] * len(live))])
                        ops.append({"action": "set", "obj": TEXT_OBJ,
                                    "elemId": ref, "insert": True,
                                    "value": LETTERS[val_k[i]], "pred": []})
                        live.append(own[i])
                        n_ins += 1
                    else:
                        j = int(pick_k[i] * len(live))
                        elem = live[j]
                        live[j] = live[-1]
                        live.pop()
                        ops.append({"action": "del", "obj": TEXT_OBJ,
                                    "elemId": elem, "pred": [elem]})
                        if elem in seed_set:
                            self.seed_dels[actor][d].add(elem)
                pair.append(ops)
            self.inserts[d] += n_ins
            self.deletes[d] += 2 * n - n_ins
            out.append(pair)
        self.ctr += n
        return start, out

    def text_lengths(self):
        """Per doc: inserts minus distinct deleted elements (the only
        duplicate deletes are of seed elements, by both actors)."""
        dup = np.array([
            len(self.seed_dels[ACTOR_A][d] & self.seed_dels[ACTOR_B][d])
            for d in range(self.docs)
        ], np.int64)
        return self.inserts - (self.deletes - dup)


def reference_text(ops):
    """Plain host reference of one text document: the sequential RGA scan
    (HostDocOrder) over [(op, counter, actor)] in causal order, and
    last-writer visibility: an element's only writer is its insert, so it
    is visible iff no delete names it."""
    from automerge_tpu_torch.tpu.text_engine import HostDocOrder

    order = HostDocOrder()
    value, deleted = {}, set()
    for op, ctr, actor in ops:
        if op.get("insert"):
            elem = f"{ctr}@{actor}"
            order.insert(elem, op["elemId"])
            value[elem] = op["value"]
        else:
            deleted.add(op["elemId"])
    return [value[e] for e in order.elems if e not in deleted]


def run_text_engine(device, docs, changes, ops, seed, sample=()):
    """Configuration 2 on ``BatchedTextEngine``: `changes` apply_batch
    rounds, round r carrying change r of both actors for every doc (the
    seed change rides round 0). Returns (engine, traffic, {sampled doc:
    its op stream}, seconds spent applying)."""
    from automerge_tpu_torch.tpu.text_engine import BatchedTextEngine

    eng = BatchedTextEngine(docs, device=device)
    eng._actor(ACTOR_B)  # intern B before A: intern order != rank order
    traffic = TextTraffic(docs, ops, seed)
    seed_ops = [(op, ctr, ACTOR_A) for op, ctr in TextTraffic.seed_ops()[1:]]
    kept = {d: [] for d in sample}
    apply_s = 0.0
    for r in range(changes):
        start, pairs = traffic.next_round()
        per_doc = []
        for d, (ops_a, ops_b) in enumerate(pairs):
            row = list(seed_ops) if r == 0 else []
            row += [(op, start + i, ACTOR_A) for i, op in enumerate(ops_a)]
            row += [(op, start + i, ACTOR_B) for i, op in enumerate(ops_b)]
            per_doc.append(row)
            if d in kept:
                kept[d].extend(row)
        t0 = time.perf_counter()
        eng.apply_batch(per_doc)
        apply_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    _sync(device)
    return eng, traffic, kept, apply_s + time.perf_counter() - t0


def text_change_buffers(traffic, changes):
    """Encodes the text traffic as change buffers: the seed change, then
    per round, per actor, one change per doc (each actor's changes chain
    on its previous one). Returns (seed buffer, [round][actor][doc])."""
    from automerge_tpu_torch.columnar import decode_change_columns, encode_change

    seed_buf = encode_change({
        "actor": ACTOR_A, "seq": 1, "startOp": 1, "time": 0, "deps": [],
        "ops": [op for op, _ in TextTraffic.seed_ops()],
    })
    seed_hash = decode_change_columns(seed_buf)["hash"]
    heads = {a: [[seed_hash] for _ in range(traffic.docs)]
             for a in (ACTOR_A, ACTOR_B)}
    first_seq = {ACTOR_A: 2, ACTOR_B: 1}
    rounds = []
    for r in range(changes):
        start, pairs = traffic.next_round()
        per_actor = []
        for k, actor in enumerate((ACTOR_A, ACTOR_B)):
            bufs = []
            for d in range(traffic.docs):
                buf = encode_change({
                    "actor": actor, "seq": first_seq[actor] + r,
                    "startOp": start, "time": 0, "deps": heads[actor][d],
                    "ops": pairs[d][k],
                })
                heads[actor][d] = [decode_change_columns(buf)["hash"]]
                bufs.append(buf)
            per_actor.append(bufs)
        rounds.append(per_actor)
    return seed_buf, rounds


def run_text_farm(device, docs, changes, ops, seed, record=None, prof=None):
    """List/text documents through the farm and the Bloom sync: a server
    ``TorchDocFarm`` and one replica farm per actor. Each replica applies
    the seed change and then its actor's changes, one change per doc per
    ``apply_changes`` call; then both sync with the server until no
    message moves. Returns (farms, stats)."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    prof = prof or PhaseProfile(enabled=False)
    traffic = TextTraffic(docs, ops, seed)
    seed_buf, rounds = text_change_buffers(traffic, changes)
    capacity = SEED_INSERTS + 1 + 2 * changes * ops
    server, rep_a, rep_b = (
        TorchDocFarm(docs, capacity=capacity, device=device) for _ in range(3)
    )

    def rec(x):
        if record is not None:
            record.append(x)

    def apply(farm, bufs):
        result = farm.apply_changes([[b] for b in bufs])
        if result.quarantined:
            raise RuntimeError(f"text edit quarantined: {result.quarantined}")
        rec([canon(p) for p in result])

    stats = {"traffic": traffic,
             "buffers": [seed_buf] + [b for per_actor in rounds
                                      for bufs in per_actor for b in bufs]}
    with use_profile(prof):
        t0 = time.perf_counter()
        for farm in (rep_a, rep_b):
            apply(farm, [seed_buf] * docs)
        for per_actor in rounds:
            apply(rep_a, per_actor[0])
            apply(rep_b, per_actor[1])
        _sync(device)
        stats["edit_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats["sweeps"] = sync_until_quiet(
            device, SyncFarm(server), [SyncFarm(rep_a), SyncFarm(rep_b)],
            docs, rec,
        )
        stats["sync_s"] = time.perf_counter() - t0
    return [server, rep_a, rep_b], stats


def _edit_elems(patch):
    """elemIds of a whole-doc patch's text object, in document order (a
    multi-insert edit covers consecutive counters of one actor)."""
    (obj,) = patch["diffs"]["props"]["text"].values()
    out = []
    for edit in obj["edits"]:
        if edit["action"] == "multi-insert":
            ctr, actor = edit["elemId"].split("@", 1)
            out.extend(f"{int(ctr) + i}@{actor}"
                       for i in range(len(edit["values"])))
        else:
            out.append(edit["elemId"])
    return out


def check_text_converged(farms, docs, lengths):
    """Every doc on every farm: equal heads; the whole-doc patch (device
    RGA rank + mirror) equals the farm's embedded sequential walk's, the
    document orders compared element by element; equal patches across
    farms; and the visible length the traffic predicts. Returns the
    server's patches."""
    patches = []
    for d in range(docs):
        heads = farms[0].get_heads(d)
        want = None
        for f in farms:
            if f.get_heads(d) != heads:
                raise RuntimeError(f"text doc {d}: heads differ across farms")
            got = f.get_patch(d)
            walk = f.exact[d].get_patch()
            if _edit_elems(got) != _edit_elems(walk):
                raise RuntimeError(f"text doc {d}: device order differs from "
                                   "the sequential walk's")
            if canon(got) != canon(walk):
                raise RuntimeError(f"text doc {d}: get_patch differs from the "
                                   "sequential walk's")
            if want is None:
                want = canon(got)
                n = len(_edit_elems(got))
                if n != int(lengths[d]):
                    raise RuntimeError(f"text doc {d}: {n} visible elements, "
                                       f"want {int(lengths[d])}")
            elif canon(got) != want:
                raise RuntimeError(f"text doc {d}: patches differ across "
                                   "farms")
        patches.append(want)
    return patches


def varint_stream(buffers):
    """The varint byte stream ``tpu/decode._decode_batch`` scans in one
    pass: every varint column (RLE, delta, boolean, group, actor, length)
    of every change in `buffers`, concatenated in order."""
    from automerge_tpu_torch.columnar import decode_change_columns
    from automerge_tpu_torch.tpu.decode import _collect_columns

    segs = []
    for buf in buffers:
        meta = decode_change_columns(buf)
        grouped = _collect_columns(
            [(c["columnId"], c["buffer"]) for c in meta["columns"]]
        )
        if grouped is not None:
            segs.extend(b for _, _, b in grouped[0])
    return np.frombuffer(b"".join(segs), np.uint8)


# ---------------------------------------------------------------------- #
# kernels: exactness, timing, bounds


def _time_cuda(fn, iters=50):
    """Per call: CUDA events around `iters` eager calls of `fn` after 3
    warm-up calls. For a kernel wrapper this is what its caller pays per
    call (``call_ms``): when the wrapper's host work outlasts the kernel,
    the stream runs dry between launches and this measures the host."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_graph(fn, iters=50, replays=5):
    """Device time per launch (``ms``): `iters` calls of `fn` captured
    into one CUDA graph (the ctypes launchers enqueue on the current
    stream, which is the capture stream), so the launches run back to back
    with no host work between them. Median over `replays` replays, each
    timed alone between CUDA events after one warm-up replay, divided by
    `iters`."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times))


def launch_floor_ms():
    """``floor_ms``: `_time_graph` of a one-element in-place add, the
    launch floor no kernel can beat."""
    import torch

    t = torch.zeros(1, device="cuda")
    return _time_graph(lambda: t.add_(1))


def _profiler_ms(fn, kernel, iters=50):
    """Cross-check of ``ms``: the device time per call of the kernels
    whose name contains `kernel`, as torch.profiler (CUPTI) reports it
    over `iters` eager calls: each such kernel's mean time per launch,
    summed over the kernels (a wrapper may launch several; the trace may
    drop some launches, so no count of calls is assumed). None, with the
    reason logged, when the trace holds no such kernel or the profiler
    fails: it is a second reading, and ``ms`` does not depend on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_launch_us = 0.0
        for evt in prof.key_averages():
            if kernel not in evt.key or evt.count == 0:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            per_launch_us += us / evt.count
    except Exception as exc:  # noqa: BLE001 - a failed cross-check is logged
        log(f"  profiler cross-check of {kernel} failed: {exc!r}")
        return None
    if per_launch_us <= 0:
        log(f"  profiler cross-check of {kernel}: no device time in the "
            "trace")
        return None
    return per_launch_us / 1e3


def kernel_times(fn, kernel, floor_ms):
    """The timing fields of one kernel-table row (see `_time_graph`,
    `_time_cuda`, `launch_floor_ms`, `_profiler_ms`)."""
    return {"ms": _time_graph(fn), "call_ms": _time_cuda(fn),
            "floor_ms": floor_ms, "profiler_ms": _profiler_ms(fn, kernel)}


def _time_cold(fn, iters=20, flush_mib=256):
    """``cold_ms``: device time per call of `fn` with the 50 MB L2 cache
    flushed before each call, for inputs that would not be warm in it.
    One CUDA graph of `iters` x (a sum over a `flush_mib` MiB buffer, then
    `fn`), less a graph of the flushes alone, over `iters`. The flush
    reads, so it leaves clean lines in L2 and no write-back for `fn` to
    pay."""
    import torch

    flush = torch.ones(flush_mib << 18, device="cuda")
    total = torch.empty((), device="cuda")

    def flushed():
        torch.sum(flush, 0, out=total)
        fn()

    both = _time_graph(flushed, iters=iters)
    alone = _time_graph(lambda: torch.sum(flush, 0, out=total), iters=iters)
    return both - alone


def _max_abs_err(got, want):
    return float((got.long() - want.long()).abs().max().item()) if got.numel() else 0.0


def check_build(xyz, counts, num_words):
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    words, modulo = bk.bloom_build(xyz, counts, num_words)
    p_words, p_mod = bk.bloom_build_plain(xyz, counts, num_words)
    err = max(_max_abs_err(words, p_words), _max_abs_err(modulo, p_mod))
    if err != 0.0:
        raise RuntimeError(f"bloom_build disagrees with its plain version "
                           f"(B={xyz.shape[0]}, E={xyz.shape[1]}, W={num_words})")
    return words, modulo, err


def check_query(words, modulo, counts, query):
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    got = bk.bloom_query(words, modulo, counts, query)
    want = bk.bloom_query_plain(words, modulo, counts, query)
    err = _max_abs_err(got, want)
    if err != 0.0:
        raise RuntimeError(f"bloom_query disagrees with its plain version "
                           f"(B={words.shape[0]}, C={query.shape[1]}, "
                           f"W={words.shape[1]})")
    return err


def edge_checks(device):
    """Bit-exact kernel-vs-plain checks at the edge shapes: counts 0 and
    1, negative counts (their modulo rounds as JAX's ceil), a word count
    that is not a multiple of 32, a candidate count that is not a power
    of two, batches that are not a multiple of the filters one block
    packs, an entry count just above the packed limit (256) and just
    above one split block's share (1,024), candidate counts on both sides
    of one block (256), a row above 48 KB of shared memory, the
    10,000-entry filter (3,125 words) at B 2 and B 1 (the cluster split);
    then queries on rows and moduli made directly: a modulo with bit 31
    set (the kernel's wrapping branch), exactly 2^31, and a 64 KB row
    that is not staged in shared memory."""
    import torch

    rng = np.random.default_rng(7)
    cases = [  # (batch, entries, words, candidates, counts)
        (4, 3, 1, 5, [0, 1, 0, 1]),
        (4, 8, 4, 6, [-1, 3, -9, -2**20]),
        (3, 64, 20, 33, [64, 40, 0]),
        (5, 12, 16, 9, [12, 7, 1, 0, 3]),
        (5, 64, 20, 64, [64, 63, 1, 0, 64]),
        (9, 32, 10, 16, [32, 31, 30, 2, 1, 0, 17, 32, 5]),
        (3, 129, 41, 130, [129, 100, 0]),
        (3, 257, 81, 257, [257, 200, 0]),
        (1, 1025, 321, 200, [1025]),
        (2, 2000, 16_384, 64, [2000, 1500]),
        (2, 10_000, 3125, 1001, [10_000, 9_999]),
        (1, 10_000, 3125, 1001, [10_000]),
    ]
    for batch, entries, num_words, cands, counts in cases:
        xyz = rng.integers(0, 2**32, (batch, entries, 3), dtype=np.uint32)
        q = rng.integers(0, 2**32, (batch, cands, 3), dtype=np.uint32)
        half = min(cands // 2, entries)
        q[:, :half] = xyz[:, :half]
        t_xyz = torch.from_numpy(xyz.view(np.int32)).to(device)
        t_cnt = torch.tensor(counts, dtype=torch.int32, device=device)
        words, modulo, _ = check_build(t_xyz, t_cnt, num_words)
        check_query(words, modulo, t_cnt,
                    torch.from_numpy(q.view(np.int32)).to(device))
        log(f"  edge ok: B={batch} E={entries} W={num_words} C={cands} "
            f"counts={counts[:4]}")
    direct = [  # (words, candidates, moduli as int32, counts)
        (64, 40, [-8, -2**31, 2**31 - 8, 640], [5, 5, 5, 0]),
        (16_384, 70, [32 * 16_384, 1000, -8], [1, 7, 3]),
    ]
    for num_words, cands, moduli, counts in direct:
        batch = len(moduli)
        words = rng.integers(0, 2**32, (batch, num_words), dtype=np.uint32)
        q = rng.integers(0, 2**32, (batch, cands, 3), dtype=np.uint32)
        check_query(torch.from_numpy(words.view(np.int32)).to(device),
                    torch.tensor(moduli, dtype=torch.int32, device=device),
                    torch.tensor(counts, dtype=torch.int32, device=device),
                    torch.from_numpy(q.view(np.int32)).to(device))
        log(f"  edge ok: query W={num_words} C={cands} moduli={moduli}")


def build_bound(xyz, counts, num_words):
    live = int(counts.clamp(0, xyz.shape[1]).long().sum().item())
    batch = xyz.shape[0]
    nbytes = live * 12 + batch * 4 + batch * num_words * 4 + batch * 4
    ops = live * 7 * 5  # per probe: two adds, two modulos, one OR
    return max(nbytes / HBM_BYTES_PER_S, ops / NON_TENSOR_OPS_PER_S) * 1e3, \
        nbytes, ops


def query_bound(words, counts, query):
    batch, num_words = words.shape
    cands = query.shape[1]
    live = int((counts > 0).sum().item())
    nbytes = batch * 8 + live * (num_words * 4 + cands * 12) + batch * cands
    ops = live * cands * 7 * 6  # per probe: adds, modulos, shift, AND
    return max(nbytes / HBM_BYTES_PER_S, ops / NON_TENSOR_OPS_PER_S) * 1e3, \
        nbytes, ops


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def wide_bloom_inputs(device, seed=7):
    """Inputs of phase 10's largest launches (`run_long_history` at the
    defaults), made directly, for timing two checkouts' kernels alike
    (chip_compare.py). The join's build: B 2 filters of 10,000 entries in
    the sync farm's pow2 bucket (E 16,384, W 5,120). The join's query: the
    peer tests the 10,000 changes it received (C 16,384 bucket) against
    the server's filters of the same 10,000, whose 3,125 wire words sit
    in the W 4,096 bucket. The query's rows come from the plain build, so
    making them launches no kernel. Returns (build args, query args)."""
    import torch

    from automerge_tpu_torch.tpu import bloom_kernels as bk

    rng = np.random.default_rng(seed)
    docs, width = 2, _pow2(LONG_CHANGES)
    xyz = np.zeros((docs, width, 3), np.uint32)
    xyz[:, :LONG_CHANGES] = rng.integers(0, 2**32, (docs, LONG_CHANGES, 3),
                                         dtype=np.uint32)
    t_xyz = torch.from_numpy(xyz.view(np.int32)).to(device)
    counts = torch.full((docs,), LONG_CHANGES, dtype=torch.int32,
                        device=device)
    wire_words = -(-LONG_CHANGES * 10 // 32)
    words, modulo = bk.bloom_build_plain(t_xyz, counts, wire_words)
    padded = torch.zeros(docs, _pow2(wire_words), dtype=torch.int32,
                         device=device)
    padded[:, :wire_words] = words
    return (t_xyz, counts, -(-width * 10 // 32)), (padded, modulo, counts,
                                                   t_xyz)


def bloom_timings(bk, build_args, query_args, floor_ms):
    """Timing fields (`kernel_times`), plain time, bound and shape of the
    Bloom kernels of module `bk` (this checkout's, or another checkout's
    in chip_compare.py) at one pair of inputs: (build row, query row).
    ``copy_ms`` is a yardstick, not a library twin: the same graph timing
    of one device-to-device copy of the entries (build) or candidates
    (query), the bulk of the bytes each kernel must read."""
    import torch

    xyz, counts, num_words = build_args
    q_words, _, q_counts, query = query_args
    b_bound, b_bytes, _ = build_bound(xyz, counts, num_words)
    q_bound, q_bytes, _ = query_bound(q_words, q_counts, query)
    copy_x, copy_q = torch.empty_like(xyz), torch.empty_like(query)
    build = {
        **kernel_times(lambda: bk.bloom_build(*build_args), "bloom_build",
                       floor_ms),
        "copy_ms": _time_graph(lambda: copy_x.copy_(xyz)),
        "plain_ms": _time_cuda(lambda: bk.bloom_build_plain(*build_args),
                               iters=10),
        "bound_ms": b_bound,
        "shape": {"B": xyz.shape[0], "E": xyz.shape[1], "W": num_words,
                  "bytes": b_bytes}}
    query_row = {
        **kernel_times(lambda: bk.bloom_query(*query_args), "bloom_query",
                       floor_ms),
        "copy_ms": _time_graph(lambda: copy_q.copy_(query)),
        "plain_ms": _time_cuda(lambda: bk.bloom_query_plain(*query_args),
                               iters=10),
        "bound_ms": q_bound,
        "shape": {"B": q_words.shape[0], "C": query.shape[1],
                  "W": q_words.shape[1], "bytes": q_bytes}}
    return build, query_row


def log_bloom_rows(rows, at=None):
    """Logs the timing fields of the two Bloom rows of the kernel table:
    at their main-path launch, or at the shape stored under key `at`."""
    for row in rows[:2]:
        r = row if at is None else row[at]
        log(f"  {row['name']} {r['shape']}: ms {r['ms']:.5f} (device), "
            f"call_ms {r['call_ms']:.5f}, copy_ms {r['copy_ms']:.5f}, "
            f"profiler_ms {r['profiler_ms']}, bound_ms {r['bound_ms']:.6f}, "
            f"plain_ms {r['plain_ms']:.4f}")


def check_segsum(planes, seg_ids, num_segments):
    """The LEB128 kernel against its plain version on the same card
    tensors: bit-exact, or the run fails. Returns (max abs error, the pass
    that produced the result: "sorted" or "general")."""
    import torch

    from automerge_tpu_torch.tpu import leb_kernels as lk

    got, path = lk.leb128_segment_sum_path(planes, seg_ids, num_segments)
    want = lk.leb128_segment_sum_plain(planes, seg_ids, num_segments)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError(
            f"leb128_segment_sum disagrees with its plain version "
            f"(N={planes.shape[0]}, V={num_segments}, {path} pass)"
        )
    err = float((got - want).abs().max().item()) if got.numel() else 0.0
    return err, path


def sorted_ids(seg, num_segments):
    """Whether the kernel's sorted pass suffices: the ids, clamped to -1
    below 0 and to V from V up, never descend."""
    c = np.clip(seg, -1, num_segments)
    return bool(np.all(c[1:] >= c[:-1]))


def segsum_edge_inputs(rng):
    """(label, planes, ids, V) of the LEB128 kernel's edge checks: N = 1,
    N and V not multiples of 8, -1 and >= V ids scattered (unsorted),
    unsorted ids, N > 512 with V > 128 (past the TPU kernel's tiles); and
    the sorted pass's edges: N = 0, all ids -1, all >= V, leading -1s and
    trailing >= V ids around sorted ids with gaps, descending pairs inside
    the dropped runs, one run of 20,000 rows (planes < 800, so its sum
    stays below 2^24), a descending pair only at the first and only at
    the last pair, and 4,000 fully shuffled ids."""
    def planes(n, high=1 << 14):
        return rng.integers(0, high, (n, 4)).astype(np.float32)

    out = []
    for n, v, ids in [(1, 1, "sorted"), (13, 5, "sorted"),
                      (37, 11, "out_of_range"), (29, 7, "unsorted"),
                      (1300, 300, "unsorted"),
                      (70_001, 9_999, "out_of_range")]:
        seg = np.sort(rng.integers(0, v, n)).astype(np.int32)
        if ids == "unsorted":
            rng.shuffle(seg)
        elif ids == "out_of_range":
            bad = rng.random(n) < 0.3
            seg[bad] = rng.choice([-1, v, v + 3, 10 * v], int(bad.sum()))
        out.append((ids, planes(n), seg, v))
    mid = np.sort(rng.choice(np.arange(3, 1900, 2), 700))
    gaps = np.concatenate([np.full(50, -1), mid, [2000, 2000, 2003, 20_000]])
    asc = np.sort(rng.integers(0, 500, 3000)).astype(np.int32)
    first, last = asc.copy(), asc.copy()
    first[0] = first[1] + 1
    last[-1] = last[-2] - 1
    shuffled = np.sort(rng.integers(0, 1000, 4000)).astype(np.int32)
    rng.shuffle(shuffled)
    out += [
        ("empty", planes(0), np.zeros(0, np.int32), 5),
        ("all_minus_one", planes(40), np.full(40, -1, np.int32), 7),
        ("all_at_or_above_v", planes(40),
         np.sort(rng.choice([7, 8, 70], 40)).astype(np.int32), 7),
        ("edges_and_gaps", planes(len(gaps)), gaps.astype(np.int32), 2000),
        ("dropped_runs_unordered", planes(11),
         np.array([-1, -7, -2, 0, 0, 2, 5, 9, 6, 50, 6], np.int32), 6),
        ("one_long_run", planes(20_000, 800), np.ones(20_000, np.int32), 3),
        ("descending_first_pair", planes(3000), first, 520),
        ("descending_last_pair", planes(3000), last, 500),
        ("shuffled", planes(4000), shuffled, 1000),
    ]
    return out


def leb_edge_checks(device):
    """Bit-exact kernel-vs-plain checks of the LEB128 segmented sum at the
    edge inputs of `segsum_edge_inputs`, each of which must take the pass
    its ids call for (sorted or general); then streams of 1- to 8-byte
    varints, unsigned and signed, through the device scan against the
    NumPy pass."""
    import torch

    from automerge_tpu_torch.codecs import Encoder
    from automerge_tpu_torch.tpu.decode import leb128_scan, leb128_scan_device

    rng = np.random.default_rng(11)
    paths = []
    for label, planes, seg, v in segsum_edge_inputs(rng):
        _, path = check_segsum(torch.from_numpy(planes).to(device),
                               torch.from_numpy(seg).to(device), v)
        want = "sorted" if sorted_ids(seg, v) else "general"
        if path != want:
            raise RuntimeError(f"leb128_segment_sum took the {path} pass on "
                               f"{label} ids, want the {want} pass")
        paths.append(path)
        log(f"  edge ok: leb128_segment_sum N={len(seg)} V={v} ids={label} "
            f"({path} pass)")
    if "general" not in paths:
        raise RuntimeError("no LEB128 edge case took the general pass")
    for signed in (False, True):
        enc = Encoder()
        for k in range(5000):
            bits = int(rng.integers(0, 53))
            val = int(rng.integers(0, 1 << bits)) if bits else 0
            if signed:
                enc.append_int53(-val if k % 2 else val)
            else:
                enc.append_uint53(val)
        data = np.frombuffer(enc.buffer, np.uint8)
        planes, seg, nvar = segsum_inputs(torch.from_numpy(data.copy())
                                          .to(device))
        _, path = check_segsum(planes, seg, nvar)
        if path != "sorted":
            raise RuntimeError("a varint stream's ids took the general pass")
        want = leb128_scan(data)
        got = leb128_scan_device(torch.from_numpy(data.copy()).to(device))
        lengths = set(got[1].tolist())
        if any(not np.array_equal(g, w) for g, w in zip(got, want)) or \
                not {1, 8} <= lengths:
            raise RuntimeError(f"device scan differs from the NumPy pass "
                               f"(signed={signed})")
        log(f"  edge ok: leb128_scan_device, {len(want[0])} varints of "
            f"{min(lengths)}-{max(lengths)} bytes, signed={signed} (kernel: "
            f"{path} pass)")


def segsum_inputs(data):
    """(planes, ids, V) of kernel 3's launch for a uint8 card tensor of
    varints, as ``tpu/decode.leb128_scan_device`` makes them: the scan
    runs once with its call of the kernel recorded."""
    from automerge_tpu_torch.tpu import leb_kernels as lk
    from automerge_tpu_torch.tpu.decode import leb128_scan_device

    rec = LargestLaunch(lk.leb128_segment_sum)
    lk.leb128_segment_sum = rec
    leb128_scan_device(data)
    lk.leb128_segment_sum = rec.fn
    return rec.args


#: how many varints of phase 8's stream have 1..8 bytes, extrapolated from
#: the same per-document traffic on the CPU (`run_scenario` at 16 docs x 32
#: and `run_text_farm` at 1 doc x 6: 1,432,572 bytes in 1,344,392 varints,
#: against phase 8's 1,428,125 in 1,340,192); phase 8 logs the true mix
PHASE8_LENGTH_MIX = (1_256_212, 88_180, 0, 0, 0, 0, 0, 0)
#: varints in phase 8's stream at the defaults
PHASE8_VARINTS = 1_340_192


def synthetic_varint_stream(num_varints, seed=5):
    """A stream of `num_varints` unsigned varints, made from `seed`, whose
    byte lengths follow ``PHASE8_LENGTH_MIX`` (phase 8's stream): the
    inputs on which chip_compare.py times two checkouts' kernel 3 alike."""
    rng = np.random.default_rng(seed)
    mix = np.asarray(PHASE8_LENGTH_MIX, np.float64)
    lengths = rng.choice(np.arange(1, 9), num_varints, p=mix / mix.sum())
    # a k-byte varint: k - 1 bytes with the continuation bit, then one
    # without; the last byte is nonzero so the encoding is minimal
    nbytes = int(lengths.sum())
    data = rng.integers(0, 0x80, nbytes, dtype=np.uint8) | 0x80
    ends = np.cumsum(lengths) - 1
    data[ends] = rng.integers(1, 0x80, num_varints, dtype=np.uint8)
    data[ends[lengths == 1]] = rng.integers(0, 0x80, int((lengths == 1).sum()),
                                            dtype=np.uint8)
    return data


def segsum_bound(planes, num_segments):
    n, p = planes.shape
    nbytes = n * p * 4 + n * 4 + num_segments * p * 4
    ops = n * p  # one add per input cell
    return max(nbytes / HBM_BYTES_PER_S, ops / NON_TENSOR_OPS_PER_S) * 1e3, \
        nbytes, ops


def leb_timings(lk, planes, seg_ids, num_segments, floor_ms, seed=3):
    """Timing fields (`kernel_times`, and `_time_cold` as ``cold_ms``),
    plain time, ``index_add_`` time, bound and shape of kernel 3 of module
    `lk` (this checkout's, or another checkout's in chip_compare.py) at
    one launch. ``unsorted_ms`` is the graph timing of the same rows and
    ids shuffled together (the same sums; held bit-exact first), which
    takes the general pass; ``copy_ms`` a yardstick: one device copy of
    the planes, the bulk of the bytes read."""
    import torch

    v = num_segments
    bound, nbytes, _ = segsum_bound(planes, v)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        planes.shape[0])).to(planes.device)
    sh_planes, sh_seg = planes[perm].contiguous(), seg_ids[perm].contiguous()
    got = lk.leb128_segment_sum(sh_planes, sh_seg, v)
    want = lk.leb128_segment_sum_plain(planes, seg_ids, v)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError("leb128_segment_sum disagrees with its plain "
                           "version on shuffled rows and ids")
    copy = torch.empty_like(planes)

    def fn():
        return lk.leb128_segment_sum(planes, seg_ids, v)

    return {
        **kernel_times(fn, "leb128_", floor_ms),
        "cold_ms": _time_cold(fn),
        "unsorted_ms": _time_graph(
            lambda: lk.leb128_segment_sum(sh_planes, sh_seg, v)),
        "copy_ms": _time_graph(lambda: copy.copy_(planes)),
        "plain_ms": _time_cuda(
            lambda: lk.leb128_segment_sum_plain(planes, seg_ids, v),
            iters=10),
        "bound_ms": bound,
        "library_ms": _time_cuda(
            lambda: torch.zeros(v, planes.shape[1], device=planes.device)
            .index_add_(0, seg_ids, planes)),
        "shape": {"N": planes.shape[0], "P": planes.shape[1], "V": v,
                  "bytes": nbytes}}


def scan_breakdown(data):
    """One torch.profiler trace of ``leb128_scan_device`` on a uint8 card
    tensor, for the record: the host clock around the call (ending in a
    synchronise), the device time of kernel 3's kernels and of every
    other device op (kernels, copies, fills), and the host ops that wait
    on the device or copy back (``item``, ``nonzero``, the readback
    copies) with their CPU time. None, with the reason logged, when the
    profiler fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from automerge_tpu_torch.tpu.decode import leb128_scan_device

    leb128_scan_device(data)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            leb128_scan_device(data)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
    except Exception as exc:  # noqa: BLE001 - a record, not a check
        log(f"  scan breakdown: the profiler failed: {exc!r}")
        return None
    out = {"wall_ms": wall_ms, "kernel_ms": 0.0, "other_device_ms": 0.0,
           "device_ops": 0, "host": {}}
    waits = ("aten::_local_scalar_dense", "aten::nonzero", "aten::_to_copy",
             "cudaStreamSynchronize", "cudaMemcpyAsync",
             "cudaDeviceSynchronize")
    for evt in events:
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            key = "kernel_ms" if "leb128_" in evt.key else "other_device_ms"
            out[key] += dev_us / 1e3
            out["device_ops"] += evt.count
        elif evt.key in waits:
            out["host"][evt.key] = {"calls": evt.count,
                                    "cpu_ms": evt.cpu_time_total / 1e3}
    busy = out["kernel_ms"] + out["other_device_ms"]
    out["device_idle_share"] = 1.0 - busy / wall_ms if wall_ms > 0 else None
    return out


def check_text_samples(texts, kept):
    """visible_texts of the sampled docs against the plain host reference,
    computed in worker processes (the sequential scan is O(length) per
    insert)."""
    import concurrent.futures
    import multiprocessing

    docs = sorted(kept)
    workers = max(1, min(8, os.cpu_count() or 1, len(docs)))
    with concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        refs = list(pool.map(reference_text, [kept[d] for d in docs]))
    for d, ref in zip(docs, refs):
        if texts[d] != ref:
            raise RuntimeError(f"text doc {d}: visible_texts differs from the "
                               "host reference")
    return len(docs)


class LargestLaunch:
    """Wraps a kernel entry to keep a copy of the inputs of its largest
    call (by element count). With `shape_of` it also tallies its calls by
    shape: ``shapes[key] = [calls, most live entries of one filter]``,
    where `shape_of(*args)` gives (key, the filters' counts)."""

    def __init__(self, fn, shape_of=None):
        self.fn = fn
        self.shape_of = shape_of
        self.size = -1
        self.args = None
        self.shapes = {}

    def __call__(self, *args):
        size = sum(a.numel() for a in args if hasattr(a, "numel"))
        if size > self.size:
            self.size = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a
                              for a in args)
        if self.shape_of is not None:
            key, counts = self.shape_of(*args)
            tally = self.shapes.setdefault(key, [0, 0])
            tally[0] += 1
            tally[1] = max(tally[1], int(counts.max().item()))
        return self.fn(*args)


@contextlib.contextmanager
def recorded_bloom_launches():
    """Routes sync_batch's two Bloom entries through `LargestLaunch`
    recorders while the block runs; yields (build, query). Build shapes
    are (B, E, W), query shapes (B, C, W)."""
    from automerge_tpu_torch.tpu import sync_batch

    build = LargestLaunch(
        sync_batch.bloom_build,
        lambda xyz, counts, w: ((xyz.shape[0], xyz.shape[1], w), counts))
    query = LargestLaunch(
        sync_batch.bloom_query,
        lambda words, modulo, counts, q: (
            (q.shape[0], q.shape[1], words.shape[1]), counts))
    sync_batch.bloom_build, sync_batch.bloom_query = build, query
    try:
        yield build, query
    finally:
        sync_batch.bloom_build, sync_batch.bloom_query = build.fn, query.fn


@contextlib.contextmanager
def recorded_reductions():
    """Routes the fingerprint reduction through a `LargestLaunch` recorder
    while the block runs, tallied by (B, E) with the widest span."""
    from automerge_tpu_torch.tpu import fingerprint

    rec = LargestLaunch(
        fingerprint.reduce_ranges,
        lambda words, starts, ends: (tuple(words.shape[:2]), ends - starts))
    fingerprint.reduce_ranges = rec
    try:
        yield rec
    finally:
        fingerprint.reduce_ranges = rec.fn


@contextlib.contextmanager
def counted_generate_calls():
    """Checks ``SyncFarm.generate_messages`` call by call: a call whose v2
    channels planned fingerprint queries must dispatch exactly one
    reduction, any other call none. Yields a tally: the calls with
    queries, the most v2 channels with queries in one call, and the calls
    that broke the rule as (channels with queries, reductions)."""
    from automerge_tpu_torch.tpu import sync_farm

    tally = {"with_queries": 0, "most_channels": 0, "wrong": []}
    plain_generate = sync_farm.SyncFarm.generate_messages
    plain_plan = sync_farm.plan_generate_v2
    planned = []

    def plan(*args):
        v2_plan, queries = plain_plan(*args)
        planned.append(len(queries))
        return v2_plan, queries

    def generate(self, channels, protocols=None):
        planned.clear()
        before = self.fingerprints.dispatches
        out = plain_generate(self, channels, protocols)
        with_queries = sum(1 for n in planned if n)
        ran = self.fingerprints.dispatches - before
        if ran != (1 if with_queries else 0):
            tally["wrong"].append((with_queries, ran))
        if with_queries:
            tally["with_queries"] += 1
            tally["most_channels"] = max(tally["most_channels"],
                                         with_queries)
        return out

    sync_farm.plan_generate_v2 = plan
    sync_farm.SyncFarm.generate_messages = generate
    try:
        yield tally
    finally:
        sync_farm.plan_generate_v2 = plain_plan
        sync_farm.SyncFarm.generate_messages = plain_generate


def reduction_row(args, floor_ms):
    """The fingerprint reduction at a recorded launch: equal to a NumPy XOR
    reduction of the same masked words (bit-exact), its device time per
    call (the kernel table's CUDA-graph method), the time per eager call,
    and its bytes bound (each input read once, the output written once)."""
    from automerge_tpu_torch.tpu import fingerprint as fp

    words, starts, ends = args
    got = fp.reduce_ranges(*args).cpu().numpy()
    w = words.cpu().numpy()
    idx = np.arange(w.shape[1])[None, :]
    mask = (idx >= starts.cpu().numpy()[:, None]) & (
        idx < ends.cpu().numpy()[:, None])
    want = np.bitwise_xor.reduce(np.where(mask[:, :, None], w, 0), axis=1)
    if not np.array_equal(got, want):
        raise RuntimeError("the fingerprint reduction disagrees with NumPy")
    nbytes = (words.numel() + starts.numel() + ends.numel()
              + got.size) * 4
    return {"shape": "B {} · E {} · 8".format(*words.shape[:2]),
            "ms": _time_graph(lambda: fp.reduce_ranges(*args)),
            "call_ms": _time_cuda(lambda: fp.reduce_ranges(*args)),
            "floor_ms": floor_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "max_abs_err": 0.0}


def log_reductions(rec, row):
    for (b, e), (n, span) in sorted(rec.shapes.items()):
        log(f"  fingerprint reduction B={b} E={e}: {n} calls, widest span "
            f"{span}")
    log(f"  fingerprint reduction at {row['shape']}: ms {row['ms']:.5f} "
        f"(device, CUDA graph), call_ms {row['call_ms']:.5f}, bound_ms "
        f"{row['bound_ms']:.6f} (bytes), launch floor {row['floor_ms']:.5f}; "
        "equal to NumPy")


def log_bloom_shapes(build, query):
    """Logs the recorded launches by shape, each build with its plan
    (0 = packed, k = split on clusters of k blocks). Returns the largest
    cluster size a build launched with."""
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    largest = 0
    for (b, e, w), (n, live) in sorted(build.shapes.items()):
        plan = bk.build_plan(b, e, w)
        largest = max(largest, plan)
        log(f"  bloom_build B={b} E={e} W={w}: {n} launches, at most {live} "
            f"live entries, plan {plan}")
    for (b, c, w), (n, live) in sorted(query.shapes.items()):
        log(f"  bloom_query B={b} C={c} W={w}: {n} launches, filters of at "
            f"most {live} entries")
    return largest


# ---------------------------------------------------------------------- #
# the store (phase 15): the WAL's cost, the batched cold start, recovery

# phase 15: docs, rounds of one change per doc, ops per change (the JAX
# package's STORE_r01.json shape), and the sample of the per-doc loads
STORE_DOCS, STORE_ROUNDS, STORE_OPS = 256, 6, 256
STORE_SAMPLE = 16
STORE_COUNTERS = ("store.append.records", "store.append.bytes",
                  "store.fsyncs")


def store_streams(docs, rounds, ops, seed):
    """Per doc, one actor's change stream: `rounds` changes of `ops` uint
    sets on 64 root keys, each naming the previous op on its key as pred
    (the JAX package's ``bench._make_change_stream``, seeded with
    seed + d for doc d)."""
    from automerge_tpu_torch.columnar import decode_change_columns, encode_change

    streams = []
    for d in range(docs):
        rng = random.Random(seed + d)
        actor = "aaaaaaaa"
        buffers, last, max_op, deps = [], {}, 0, []
        for r in range(rounds):
            body = []
            ctr = start_op = max_op + 1
            for _ in range(ops):
                key = f"k{rng.randrange(64)}"
                body.append({"action": "set", "obj": "_root", "key": key,
                             "datatype": "uint", "value": rng.randrange(10**6),
                             "pred": [last[key]] if key in last else []})
                last[key] = f"{ctr}@{actor}"
                ctr += 1
            max_op = ctr - 1
            buf = encode_change({"actor": actor, "seq": r + 1,
                                 "startOp": start_op, "time": 0,
                                 "deps": deps, "ops": body})
            deps = [decode_change_columns(buf)["hash"]]
            buffers.append(buf)
        streams.append(buffers)
    return streams


def dir_files(root):
    """[(name, bytes)] of every file under `root`, sorted by path."""
    out = []
    for base, _dirs, names in sorted(os.walk(root)):
        for name in sorted(names):
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out.append((os.path.relpath(path, root), fh.read()))
    return out


def last_commit_frame(path):
    """(offset, length, doc, changes) of the last frame of a WAL segment,
    read with the segment's frame layout (``u32le length | sha256 |
    payload``, payload ``u8 type | uleb doc | uleb n | ...``)."""
    from automerge_tpu_torch.store.wal import _HEADER

    with open(path, "rb") as fh:
        data = fh.read()
    pos, last = len(_HEADER), None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "little")
        last = (pos, 4 + 32 + length)
        pos += 4 + 32 + length
    if last is None or pos != len(data):
        raise RuntimeError(f"{path}: no whole last frame")
    payload = data[last[0] + 36:last[0] + last[1]]
    if payload[0] != 1:
        raise RuntimeError(f"{path}: the last frame is not a commit record")
    values, i = [], 1
    for _ in range(2):
        value = shift = 0
        while True:
            byte = payload[i]
            i += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        values.append(value)
    return last[0], last[1], values[0], values[1]


def run_store(device, docs, rounds, ops, seed, root, sample=STORE_SAMPLE,
              record=None, what="phase 15"):
    """Phase 15 in `root` (a directory this call owns): `docs` documents
    take `rounds` deliveries of one `ops`-op change each.

    1. WAL cost: the deliveries through a bare ``TorchDocFarm`` and through
       one with a ``ShardStore`` attached (fsync on, one barrier per
       delivery), after one warm-up pass, in turns bare, WAL, WAL, bare,
       each after a full collection of the cyclic garbage collector, all
       with this package's metrics registry on (the store's append
       counters need it); the first WAL run's store is the one the rest
       of the phase reads;
    2. cold start: the per-doc sequential loads (``OpSet``) of a `sample`
       of the recovered docs, then ``open_farm`` on `device`, each after
       clearing the decode caches; the hydrated farm's recovery report
       must be clean and its change log, heads and whole-doc patches equal
       to the writer's (and the sample's heads);
    3. catch-up: a fresh replica joins the hydrated farm over the Bloom
       sync until no message moves, and must converge;
    4. torn tail: the hydrated farm takes one more round (logged to the
       store it attached, whose segments are sized so that round cannot
       rotate the active one away), then, on a copy of its directory, the
       active segment is cut in the middle of its last frame; reopening
       must recover exactly the acked commits before that frame.

    Every farm the phase builds is checked for degraded docs before it is
    dropped (`what` names the phase); run it inside `counting_fallbacks`
    for the walk's counters to count outside the timed turns too.
    `record` collects the store's files, the patches and the sync
    messages, for the card-vs-CPU comparison. Returns stats."""
    import shutil

    from automerge_tpu_torch import SyncFarm, TorchDocFarm
    from automerge_tpu_torch.columnar import clear_decode_caches
    from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
    from automerge_tpu_torch.opset import OpSet
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile
    from automerge_tpu_torch.store import ShardStore, StoreConfig, open_farm

    def rec(x):
        if record is not None:
            record.append(x)

    streams = store_streams(docs, rounds + 1, ops, seed)
    deliveries = [[[streams[d][r]] for d in range(docs)]
                  for r in range(rounds)]
    capacity = (rounds + 1) * ops + 8
    wal = os.path.join(root, "shard-000")
    fallbacks = fallback_counts()

    def farm():
        return TorchDocFarm(docs, capacity=capacity, device=device)

    def deliver(f, prof):
        t0 = time.perf_counter()
        with use_profile(prof):
            for delivery in deliveries:
                result = f.apply_changes(delivery)
                if result.quarantined:
                    raise RuntimeError(f"store delivery quarantined: "
                                       f"{result.quarantined}")
        _sync(device)
        return time.perf_counter() - t0

    # warm-up: the round shape both timed loops run
    deliver(farm(), PhaseProfile(enabled=False))

    # turns bare, WAL, WAL, bare, each after a full collection; the
    # registry goes off again at the end: give the degraded walk's
    # counters back their flags afterwards
    stats = {"turns": [], "gen2": {"bare": 0, "wal": 0}}
    registry = get_metrics()
    profs = {"bare": PhaseProfile(), "wal": PhaseProfile()}
    writer = None
    with counting_fallbacks(), enabled_metrics():
        for turn in ("bare", "wal", "wal", "bare"):
            f, store = farm(), None
            first = turn == "wal" and writer is None
            if turn == "wal":
                store = ShardStore(wal if first else
                                   os.path.join(root, "wal-2"), StoreConfig())
                f.attach_store(store)
                before = {n: registry.counter(n).value for n in STORE_COUNTERS}
            gc.collect()
            gen2 = gc.get_stats()[2]["collections"]
            seconds = deliver(f, profs[turn])
            stats["gen2"][turn] += gc.get_stats()[2]["collections"] - gen2
            stats["turns"].append((turn, seconds))
            check_no_fallback(fallbacks, [f], f"{what} ({turn} turn)")
            if store is not None:
                store.close()
            if first:
                writer = f
                for name in STORE_COUNTERS:
                    stats[name] = registry.counter(name).value - before[name]
    shutil.rmtree(os.path.join(root, "wal-2"))
    for turn in ("bare", "wal"):
        stats[f"{turn}_s"] = sum(t for k, t in stats["turns"] if k == turn)
    stats["overhead"] = stats["wal_s"] / stats["bare_s"]
    stats["commit_s"] = profs["wal"].as_dict()["store_commit"]["total_s"]
    stats["profs"] = profs
    rec(dir_files(wal))
    want_changes = [list(c) for c in writer.changes]
    want_heads = [writer.get_heads(d) for d in range(docs)]
    want_patches = [canon(writer.get_patch(d)) for d in range(docs)]
    rec(want_patches)
    del writer

    # per-doc sequential loads of a sample, then the batched cold start;
    # the store it reattaches takes one more round below, in an active
    # segment that round cannot fill (it is under the default bound when
    # reopened, since every barrier rotates a segment at that bound)
    reader = ShardStore(wal)
    loads = sorted(reader.recovered_commits().items())[:sample]
    reader.close()
    clear_decode_caches()
    t0 = time.perf_counter()
    for doc, bufs in loads:
        opset = OpSet()
        opset.apply_changes(list(bufs))
        opset.get_patch()
        if sorted(opset.heads) != sorted(want_heads[doc]):
            raise RuntimeError(f"store doc {doc}: the sequential load's "
                               "heads differ from the writer's")
    stats["sequential_s"] = time.perf_counter() - t0
    stats["sample"] = len(loads)
    clear_decode_caches()
    t0 = time.perf_counter()
    extra = sum(len(s[rounds]) for s in streams)
    hydrated, store2 = open_farm(
        wal, docs, capacity=capacity, device=device,
        store_config=StoreConfig(
            segment_bytes=StoreConfig().segment_bytes + 2 * extra))
    _sync(device)
    stats["batched_s"] = time.perf_counter() - t0
    report = store2.report
    stats["report"] = {"clean": report.clean, "segments": report.segments,
                       "records": report.records, "changes": report.changes,
                       "torn_bytes": report.torn_bytes,
                       "corrupt_segments": len(report.corrupt_segments)}
    if not report.clean or report.changes != docs * rounds:
        raise RuntimeError(f"store recovery: {stats['report']}, want clean "
                           f"with {docs * rounds} changes")
    if [list(c) for c in hydrated.changes] != want_changes:
        raise RuntimeError("the hydrated farm's change log differs")
    got = [canon(hydrated.get_patch(d)) for d in range(docs)]
    bad = [d for d in range(docs) if got[d] != want_patches[d]
           or hydrated.get_heads(d) != want_heads[d]]
    if bad:
        raise RuntimeError(f"hydrated docs {bad[:8]} differ from the writer")
    rec(got)

    # a fresh replica catches up from the hydrated farm
    replica = farm()
    t0 = time.perf_counter()
    stats["sweeps"] = sync_until_quiet(device, SyncFarm(hydrated),
                                       [SyncFarm(replica)], docs, rec)
    stats["catch_up_s"] = time.perf_counter() - t0
    rec(check_converged([hydrated, replica], docs))
    check_no_fallback(fallbacks, [replica], f"{what} (catch-up replica)")
    del replica

    # the hydrated farm keeps logging; then a torn tail: cut the active
    # segment of a copy in the middle of its last frame
    result = hydrated.apply_changes([[s[rounds]] for s in streams])
    if result.quarantined:
        raise RuntimeError(f"store delivery quarantined: {result.quarantined}")
    for d, s in enumerate(streams):
        want_changes[d].append(s[rounds])
    store2.close()
    check_no_fallback(fallbacks, [hydrated], f"{what} (hydrated farm)")
    del hydrated
    torn = os.path.join(root, "torn")
    shutil.copytree(wal, torn)
    active = [n for n in os.listdir(torn) if n.endswith(".open")]
    if len(active) != 1:
        raise RuntimeError(f"store: {len(active)} active segments")
    path = os.path.join(torn, active[0])
    offset, length, doc, n = last_commit_frame(path)
    os.truncate(path, offset + length // 2)
    torn_farm, store3 = open_farm(torn, docs, capacity=capacity,
                                  device=device)
    want_changes[doc] = want_changes[doc][:len(want_changes[doc]) - n]
    if [list(c) for c in torn_farm.changes] != want_changes:
        raise RuntimeError("the torn store did not recover exactly the "
                           "commits before its torn frame")
    stats["torn"] = {"doc": doc, "lost": n,
                     "torn_bytes": store3.report.torn_bytes,
                     "recovered": sum(len(c) for c in torn_farm.changes)}
    if store3.report.torn_bytes != length // 2 or \
            store3.report.corrupt_segments:
        raise RuntimeError(f"torn store report: {vars(store3.report)}")
    rec(canon(stats["torn"]))
    store3.close()
    check_no_fallback(fallbacks, [torn_farm], f"{what} (torn store)")
    return stats


def log_store(stats, docs, rounds, ops, card):
    sweeps = stats["sweeps"]
    log(f"phase 15 store: {docs} docs x {rounds} rounds x one {ops}-op "
        f"change, card {card}")
    turns = ", ".join(f"{k} {t:.3f} s" for k, t in stats["turns"])
    log(f"  WAL cost in turns: {turns}; bare {stats['bare_s']:.3f} s, with "
        f"the store {stats['wal_s']:.3f} s in all (ratio "
        f"{stats['overhead']:.3f}); store_commit {stats['commit_s']:.3f} s "
        f"({stats['commit_s'] / stats['wal_s']:.1%} of the WAL runs); "
        f"full (gen 2) collections during the runs: {stats['gen2']}; the "
        f"first WAL run: {stats['store.append.records']} append records, "
        f"{stats['store.append.bytes']} bytes, {stats['store.fsyncs']} "
        "fsyncs")
    seq_rate = stats["sample"] / stats["sequential_s"]
    log(f"  cold start: open_farm {stats['batched_s']:.3f} s "
        f"({docs / stats['batched_s']:.1f} docs/s); per-doc sequential loads "
        f"{stats['sequential_s']:.3f} s for {stats['sample']} docs "
        f"({seq_rate:.2f} docs/s); recovery {stats['report']}; hydrated "
        "patches equal the writer's for every doc")
    log(f"  catch-up: a fresh replica converged in {len(sweeps)} sweeps "
        f"({stats['catch_up_s']:.3f} s, "
        f"{sum(sw.moved for sw in sweeps)} messages)")
    log(f"  torn tail: the last frame (doc {stats['torn']['doc']}, "
        f"{stats['torn']['lost']} change) cut mid-frame, "
        f"{stats['torn']['torn_bytes']} torn bytes truncated, "
        f"{stats['torn']['recovered']} changes recovered, exactly the acked "
        "prefix")
    log("  phase table (both WAL runs, host clock):")
    for line in stats["profs"]["wal"].table().splitlines():
        log("    " + line)
    bare, wal = (stats["profs"][k].as_dict() for k in ("bare", "wal"))
    deltas = {name: round(wal[name]["total_s"]
                          - bare.get(name, {"total_s": 0.0})["total_s"], 4)
              for name in wal}
    log(f"  both WAL runs less both bare runs, by phase (s): {deltas}")


# ---------------------------------------------------------------------- #
# the serving front door (phase 16): LoadGen's clients against AmServer

# phase 16: the JAX package's SERVE_r06.json shape (10,000 clients over
# 1,024 docs) cut to 1,024 clients over 128 docs, keeping its ~8 clients
# per doc; per client 2 edits of 4 ops spread over 2.0 simulated s
SERVE_CLIENTS, SERVE_CLIENTS_PER_DOC = 1024, 8
SERVE_EDITS, SERVE_OPS, SERVE_SPREAD = 2, 4, 2.0
OCCUPANCY_FLOOR = 8


def run_serve(device, clients, docs, seed, spread=SERVE_SPREAD, chaos=0.0,
              store_root=None, record=None, prof=None):
    """Phase 16: ``LoadGen``'s simulated clients (this package's
    ``backend`` replicas on ``SyncSession``s, over chaos links at `chaos`)
    against an ``AmServer`` over a ``TorchDocFarm`` on `device`, with a
    ``ShardStore`` in `store_root` attached when given. The default
    ``BatcherConfig`` and ``SessionConfig``, observability "metrics".
    `record` collects every frame sent and delivered, the report, every
    doc's whole patch and the store's files. Returns (farm, report); the
    run zeroes this package's registry first, so the degraded walk's
    counters read after it count this run alone."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile
    from automerge_tpu_torch.serve import LoadConfig, LoadGen
    from automerge_tpu_torch.store import ShardStore
    from automerge_tpu_torch.testing import faults

    per_doc_ops = -(-clients // docs) * SERVE_EDITS * SERVE_OPS + 8
    capacity = 1 << (per_doc_ops - 1).bit_length()
    farm = TorchDocFarm(docs, capacity=capacity, device=device)
    store = None
    if store_root is not None:
        store = ShardStore(store_root)
        farm.attach_store(store)
    harness = LoadGen(farm, LoadConfig(
        clients=clients, docs=docs, edits_per_client=SERVE_EDITS,
        ops_per_edit=SERVE_OPS, spread=spread, chaos=chaos, seed=seed,
        observability="metrics"))
    frames = []

    def frame(**ctx):
        frames.append(bytes(ctx["frame"]))

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if record is not None:
            stack.enter_context(faults.inject("chaos.send", frame))
            stack.enter_context(faults.inject("chaos.deliver", frame))
        stack.enter_context(use_profile(prof or PhaseProfile(enabled=False)))
        # the run turns the whole registry on and off again: give the
        # degraded walk's counters back their flags afterwards
        stack.enter_context(counting_fallbacks())
        report = harness.run()
    _sync(device)
    host_s = time.perf_counter() - t0
    if store is not None:
        store.close()
    if record is not None:
        record.extend(frames)
        record.append(canon(report))
        record.extend(canon(farm.get_patch(d)) for d in range(docs))
        if store_root is not None:
            record.append(dir_files(store_root))
    report["host_s"], report["spread_s"] = host_s, spread
    report["ops_per_s"] = (report["surviving_clients"] * SERVE_EDITS
                           * SERVE_OPS / host_s)
    return farm, report


def check_serve(farm, report, clients, what):
    """Right after `run_serve`: every client converged and survived, and
    the degraded walk never ran in the run."""
    if not report["converged"] or report["unconverged_clients"] or \
            report["surviving_clients"] != clients:
        raise RuntimeError(f"{what}: {report['unconverged_clients']} clients "
                           f"unconverged, {report['surviving_clients']} of "
                           f"{clients} surviving")
    check_no_fallback(dict.fromkeys(FALLBACK_COUNTERS, 0), [farm], what)


def log_serve(report, clients, docs, prof, card):
    lat, adm = report["latency_ms"], report["admission"]
    floor = "at or above" if report["occupancy_mean"] >= OCCUPANCY_FLOOR \
        else "BELOW"
    log(f"phase 16 serve: {clients} clients over {docs} docs, "
        f"{SERVE_EDITS} edits of {SERVE_OPS} ops each spread over "
        f"{report['spread_s']} simulated s, 4 tenants, no chaos, card {card}")
    log(f"  converged {report['converged']}, {report['surviving_clients']} "
        f"clients surviving; {report['dispatches']} dispatches, mean flush "
        f"occupancy {report['occupancy_mean']} docs ({floor} the floor of "
        f"{OCCUPANCY_FLOOR}); admission {adm}; {report['changes_committed']} "
        f"changes committed")
    log(f"  latency (simulated ms, log2 buckets): p50 {lat['p50']}, p95 "
        f"{lat['p95']}, p99 {lat['p99']} over {lat['samples']} samples; "
        f"{report['simulated_s']} simulated s; host wall "
        f"{report['host_s']:.3f} s, served {report['ops_per_s']:.0f} ops/s "
        "(ops over host wall)")
    # the served ops/s above is bounded by the simulated fleet on the same
    # host; the farm's own phases are the server's share of that wall
    farm_s = sum(t for path, (t, _) in prof.totals_by_path().items()
                 if "/" not in path and not path.startswith("backend."))
    log(f"  the served farm's phases (every top-level span but the clients' "
        f"backend.*): {farm_s:.3f} s, {farm_s / report['host_s']:.1%} of the "
        "host wall")
    log("  phase table (served farm and clients, host clock):")
    for line in prof.table().splitlines():
        log("    " + line)


def check_launched(table, launches, rec_build, rec_query, key, what):
    """Both Bloom kernels launched in the phase's run; each is then held
    bit-exact against its plain version at its largest launch there, and
    the phase's counts land under `key` in the kernel table's rows."""
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{what} never launched {name}")
    log_bloom_shapes(rec_build, rec_query)
    _, _, build_err = check_build(*rec_build.args)
    query_err = check_query(*rec_query.args)
    for row, n, err in zip(table["kernels"],
                           (launches["bloom_build"], launches["bloom_query"]),
                           (build_err, query_err)):
        row[key] = {"launches": n, "max_abs_err": err}
    log(f"  Bloom kernels at this phase's largest launches: bit-exact "
        f"(build {build_err}, query {query_err})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=512)
    parser.add_argument("--replicas", type=int, default=MAP_REPLICAS)
    parser.add_argument("--changes", type=int, default=MAP_CHANGES)
    parser.add_argument("--ops", type=int, default=MAP_OPS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--text-docs", type=int, default=1024)
    parser.add_argument("--farm-text-docs", type=int, default=3)
    parser.add_argument("--v2-docs", type=int, default=128)
    parser.add_argument("--fault-docs", type=int, default=64)
    parser.add_argument("--store-docs", type=int, default=STORE_DOCS)
    parser.add_argument("--serve-clients", type=int, default=SERVE_CLIENTS)
    args = parser.parse_args(argv)

    for name, value in decode_cache_env(args.docs, args.replicas,
                                        args.changes).items():
        os.environ.setdefault(name, value)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one H100",
              file=sys.stderr)
        return 2
    try:
        import automerge_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the automerge_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2

    # every fault-free phase reads the degraded walk's counters
    with counting_fallbacks():
        return run_phases(args)


def run_phases(args) -> int:
    """Phases 1-16 on the card (see the module docstring); raises on the
    first check that fails."""
    import shutil
    import tempfile

    import torch

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.profiling import PhaseProfile
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    device = "cuda"

    # 1. build
    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc[{name}] {line.strip()}")

    # 2. edge shapes
    t0 = time.perf_counter()
    edge_checks(device)
    log(f"phase 2 kernel checks at edge shapes: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # 3. main path
    prof = PhaseProfile()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    t0 = time.perf_counter()
    with recorded_bloom_launches() as (rec_build, rec_query):
        farms, stats = run_scenario(device, args.docs, args.replicas,
                                    args.changes, args.ops, args.seed,
                                    prof=prof)
    launches = dict(bk.LAUNCHES)
    main_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_converged(farms, args.docs)
    check_no_fallback(fallbacks, farms, "phase 3")
    check_s = time.perf_counter() - t0
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"main path never launched {name}")
    total_ops = args.docs * args.replicas * args.changes * args.ops
    server_rows = int(farms[0].engine.lengths.sum())
    if server_rows != total_ops:
        raise RuntimeError(f"server holds {server_rows} rows, want {total_ops}")
    sweeps = stats["sweeps"]
    log(f"phase 3 main path: {args.docs} docs x {args.replicas} replicas x "
        f"{args.changes} changes x {args.ops} ops, card {card}")
    log(f"  edits {stats['edit_s']:.3f} s; sync {stats['sync_s']:.3f} s in "
        f"{len(sweeps)} sweeps; convergence check {check_s:.3f} s; "
        f"whole phase {main_s:.3f} s")
    log_sweeps(sweeps)
    log(f"  merged rows during sync: {stats['merged_rows']} "
        f"({stats['merged_rows'] / stats['sync_s']:.0f} ops/s); server rows "
        f"{server_rows}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"  kernel launches: {launches}")
    log("  phase table (main path, host clock):")
    for line in prof.table().splitlines():
        log("    " + line)

    log_bloom_shapes(rec_build, rec_query)

    # kernels at the main path's largest launch: exactness, times, bounds
    floor_ms = launch_floor_ms()
    _, _, build_err = check_build(*rec_build.args)
    query_err = check_query(*rec_query.args)
    b_main, q_main = bloom_timings(bk, rec_build.args, rec_query.args,
                                   floor_ms)
    table = {"kernels": [
        {"name": "bloom_build", "route": "cuda",
         "source": "automerge_tpu_torch/csrc/bloom.cu",
         "replaces": "automerge_tpu/tpu/pallas_kernels.py:258",
         "launches": launches["bloom_build"], "max_abs_err": build_err,
         **b_main, "bound_by": "bytes", "library_ms": None},
        {"name": "bloom_query", "route": "cuda",
         "source": "automerge_tpu_torch/csrc/bloom.cu",
         "replaces": "automerge_tpu/tpu/pallas_kernels.py:113",
         "launches": launches["bloom_query"], "max_abs_err": query_err,
         **q_main, "bound_by": "bytes", "library_ms": None},
    ]}
    log(f"  launch floor (graph replay of a 1-element add): {floor_ms:.5f} "
        "ms")
    log_bloom_rows(table["kernels"], None)
    # phase 8 reads the buffers; the farms' host objects would otherwise
    # stay live through every later phase (and its garbage collections)
    del farms, stats["syncs"]

    # 4. the same scenario at 16 docs, then phase 11's mixed v1/v2 sweep
    # and phase 13's sessions: card vs CPU, byte for byte
    t0 = time.perf_counter()
    on_card, on_cpu = [], []
    for dev, rec in (("cuda", on_card), ("cpu", on_cpu)):
        fallbacks = fallback_counts()
        for v2 in (0, MIXED_V2_REPLICAS):
            f4, _ = run_scenario(dev, 16, args.replicas, args.changes,
                                 args.ops, args.seed, record=rec,
                                 v2_replicas=v2)
            rec.extend(check_converged(f4, 16))
            check_no_fallback(fallbacks, f4, f"phase 4 ({dev})")
        f4, clients, pairs, frames, _ = run_sessions(
            dev, SESSION_DOCS, args.seed, record=rec)
        check_sessions(f4, clients, pairs, frames)
        check_no_fallback(fallbacks, [f4], f"phase 4 ({dev})")
        root = tempfile.mkdtemp(prefix="chip-smoke-store-")
        try:
            with counting_fallbacks():
                run_store(dev, 16, STORE_ROUNDS, STORE_OPS, args.seed, root,
                          sample=2, record=rec, what=f"phase 4 ({dev})")
            check_no_fallback(fallbacks, [], f"phase 4 ({dev})")
            f4, report = run_serve(dev, 64, 16, args.seed, chaos=0.3,
                                   store_root=os.path.join(root, "serve"),
                                   record=rec)
            check_serve(f4, report, 64, f"phase 4 ({dev})")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if on_card != on_cpu:
        first = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu))
                     if a != b) if len(on_card) == len(on_cpu) else "length"
        raise RuntimeError(f"card and CPU runs differ (first at {first})")
    log(f"phase 4 card vs CPU at 16 docs (v1 sync, mixed v1/v2 sync, 16 "
        f"supervised channels, a store round trip with a torn tail, 64 "
        f"served clients at 30 % chaos with a store attached): "
        f"{len(on_card)} messages, patches, frames, saved sessions, reports "
        f"and store files identical ({time.perf_counter() - t0:.2f} s)")

    del f4, clients, pairs

    # 5. LEB128 kernel edge shapes and the device scan's edge streams
    t0 = time.perf_counter()
    leb_edge_checks(device)
    log(f"phase 5 LEB128 checks at edge shapes: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # 6. configuration 2 on BatchedTextEngine at full width. The engine
    # and the traffic keep ~10 M small acyclic host objects alive (elemId
    # tables, op dicts); full passes of the cyclic collector over them
    # would dominate the host clock, so it is paused for the phase (a
    # deployment setting, like the decode LRU sizes above)
    t0 = time.perf_counter()
    fallbacks = fallback_counts()
    gc.disable()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(args.seed)
    sample = tuple(int(d) for d in rng.choice(
        args.text_docs, min(32, args.text_docs), replace=False))
    eng, traffic, kept, apply_s = run_text_engine(
        device, args.text_docs, TEXT_CHANGES, TEXT_OPS, args.seed,
        sample)
    rows = int(eng.engine.lengths.sum())
    t1 = time.perf_counter()
    ranks = eng.document_ranks()
    ranks_s = time.perf_counter() - t1
    dev_in = (
        torch.from_numpy(eng.elem_parent).to(device),
        torch.from_numpy(eng.elem_opid).to(device),
        torch.arange(eng.elem_capacity, device=device)[None, :]
        < torch.from_numpy(eng.num_elems).to(device)[:, None],
        torch.from_numpy(eng._actor_rank()).to(device),
    )
    from automerge_tpu_torch.tpu.rga import batched_rga_rank
    rank_ms = _time_cuda(lambda: batched_rga_rank(*dev_in), iters=5)
    del dev_in
    t1 = time.perf_counter()
    texts = eng.visible_texts()
    texts_s = time.perf_counter() - t1
    gc.enable()
    peak = torch.cuda.max_memory_allocated()
    lengths = traffic.text_lengths()
    got_len = np.array([len(t) for t in texts], np.int64)
    if not np.array_equal(got_len, lengths):
        bad = int(np.nonzero(got_len != lengths)[0][0])
        raise RuntimeError(f"text doc {bad}: {got_len[bad]} visible elements, "
                           f"want {lengths[bad]}")
    t1 = time.perf_counter()
    n_ref = check_text_samples(texts, kept)
    ref_s = time.perf_counter() - t1
    log(f"phase 6 configuration 2 on BatchedTextEngine: {args.text_docs} docs "
        f"x 2 actors x {TEXT_CHANGES} changes x {TEXT_OPS} ops "
        f"(+{SEED_INSERTS}-insert seed), card {card}")
    log(f"  rows {rows} ({rows / args.text_docs:.0f} per doc), element slots "
        f"{eng.elem_capacity} per doc; apply {apply_s:.3f} s in "
        f"{TEXT_CHANGES} rounds; document_ranks {ranks_s * 1e3:.1f} ms "
        f"(host clock, with copies), rank program {rank_ms:.3f} ms (CUDA "
        f"events); visible_texts {texts_s:.3f} s; peak device memory "
        f"{peak / 2**20:.0f} MiB")
    check_no_fallback(fallbacks, [], "phase 6")
    log(f"  visible lengths match the traffic for every doc; {n_ref} sampled "
        f"docs equal the host reference ({ref_s:.1f} s); whole phase "
        f"{time.perf_counter() - t0:.3f} s")
    del eng, kept, texts, ranks

    # 7. list/text documents through the farm and the Bloom sync
    t0 = time.perf_counter()
    prof7 = PhaseProfile()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    with recorded_bloom_launches() as (rec_build7, rec_query7):
        tfarms, tstats = run_text_farm(device, args.farm_text_docs,
                                       TEXT_CHANGES, TEXT_OPS,
                                       args.seed, prof=prof7)
    launches7 = dict(bk.LAUNCHES)
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    check_text_converged(tfarms, args.farm_text_docs,
                         tstats["traffic"].text_lengths())
    check_no_fallback(fallbacks, tfarms, "phase 7")
    check_s = time.perf_counter() - t1
    for name, n in launches7.items():
        if n <= 0:
            raise RuntimeError(f"the text sync never launched {name}")
    sweeps = tstats["sweeps"]
    log(f"phase 7 list/text farms + Bloom sync: {args.farm_text_docs} docs x "
        f"(server + 2 replicas), {TEXT_CHANGES} changes x "
        f"{TEXT_OPS} ops per actor, card {card}")
    log(f"  edits {tstats['edit_s']:.3f} s; sync {tstats['sync_s']:.3f} s in "
        f"{len(sweeps)} sweeps; check (device order = walk order, equal "
        f"patches) {check_s:.3f} s; whole phase "
        f"{time.perf_counter() - t0:.3f} s (run {run_s:.3f} s)")
    log_sweeps(sweeps)
    log(f"  server rows {int(tfarms[0].engine.lengths.sum())}; kernel "
        f"launches: {launches7}")
    log_bloom_shapes(rec_build7, rec_query7)
    log("  phase table (text farms, host clock):")
    for line in prof7.table().splitlines():
        log("    " + line)
    del tfarms

    # 8. the device LEB128 scan over the run's change buffers (kernel 3)
    from automerge_tpu_torch.tpu import leb_kernels as lk
    from automerge_tpu_torch.tpu.decode import leb128_scan, leb128_scan_device

    t0 = time.perf_counter()
    buffers = stats["buffers"] + tstats["buffers"]
    data = varint_stream(buffers)
    want = leb128_scan(data)
    build_s = time.perf_counter() - t0
    rec_seg = LargestLaunch(lk.leb128_segment_sum)
    lk.leb128_segment_sum = rec_seg
    lk.reset_launch_counts()
    t1 = time.perf_counter()
    got = leb128_scan_device(torch.from_numpy(data.copy()).to(device))
    _sync(device)
    scan_s = time.perf_counter() - t1
    launches8 = dict(lk.LAUNCHES)
    lk.leb128_segment_sum = rec_seg.fn
    if any(not np.array_equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("device LEB128 scan differs from the NumPy pass")
    if launches8["leb128_segment_sum"] <= 0:
        raise RuntimeError("the device scan never launched leb128_segment_sum")
    planes, seg_ids, nvar = rec_seg.args
    seg_err, seg_path = check_segsum(planes, seg_ids, nvar)
    if seg_path != "sorted":
        raise RuntimeError("the scan's ids took kernel 3's general pass")
    mix = np.bincount(want[1], minlength=9)[1:].tolist()
    log(f"phase 8 device LEB128 scan: {len(buffers)} change buffers, "
        f"{data.shape[0]} varint bytes, {nvar} varints (by length 1-8: "
        f"{mix}); stream built in {build_s:.3f} s; scan "
        f"{scan_s * 1e3:.1f} ms (host clock, upload to readback); equal to "
        f"the NumPy pass; launches {launches8}; kernel 3 took the "
        f"{seg_path} pass")
    breakdown = scan_breakdown(torch.from_numpy(data.copy()).to(device))
    if breakdown is not None:
        log(f"  scan breakdown (torch.profiler, one call): "
            f"{json.dumps(breakdown)}")
    seg_row = leb_timings(lk, planes, seg_ids, nvar, floor_ms)
    table["kernels"].append(
        {"name": "leb128_segment_sum", "route": "cuda",
         "source": "automerge_tpu_torch/csrc/leb128.cu",
         "replaces": "automerge_tpu/tpu/pallas_kernels.py:222",
         "launches": launches8["leb128_segment_sum"],
         "max_abs_err": seg_err, "path": seg_path, **seg_row,
         "bound_by": "bytes"})
    log(f"  leb128_segment_sum {seg_row['shape']}: ms {seg_row['ms']:.5f} "
        f"(device, warm), cold_ms {seg_row['cold_ms']:.5f}, unsorted_ms "
        f"{seg_row['unsorted_ms']:.5f}, call_ms {seg_row['call_ms']:.5f}, "
        f"copy_ms {seg_row['copy_ms']:.5f}, profiler_ms "
        f"{seg_row['profiler_ms']}, bound_ms {seg_row['bound_ms']:.6f}, "
        f"library_ms {seg_row['library_ms']:.5f}, plain_ms "
        f"{seg_row['plain_ms']:.4f}")

    # 9. card vs CPU: the text farms at 2 docs and the text engine at 16
    t0 = time.perf_counter()
    on_card, on_cpu = [], []
    for dev, rec in (("cuda", on_card), ("cpu", on_cpu)):
        tf, ts = run_text_farm(dev, 2, 20, TEXT_OPS, args.seed,
                               record=rec)
        rec.extend(check_text_converged(tf, 2, ts["traffic"].text_lengths()))
        eng, *_ = run_text_engine(dev, 16, TEXT_CHANGES, TEXT_OPS,
                                  args.seed)
        rec.append(eng.document_ranks().tobytes())
        rec.append(canon(eng.visible_texts()))
    if on_card != on_cpu:
        first = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu))
                     if a != b) if len(on_card) == len(on_cpu) else "length"
        raise RuntimeError(f"text card and CPU runs differ (first at {first})")
    log(f"phase 9 card vs CPU (text farms at 2 docs x 20 changes, text engine "
        f"at 16 docs): {len(on_card)} messages, patches, ranks and texts "
        f"identical ({time.perf_counter() - t0:.2f} s)")

    # 10. a fresh peer joins long-history documents, then both reconnect
    t0 = time.perf_counter()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    with recorded_bloom_launches() as (rec_build10, rec_query10):
        lfarms, lstats = run_long_history(device, 2, LONG_CHANGES, LONG_OPS,
                                          LONG_NEW, args.seed)
    launches10 = dict(bk.LAUNCHES)
    run_s = time.perf_counter() - t0
    check_converged(lfarms, 2)
    check_no_fallback(fallbacks, lfarms, "phase 10")
    want_rows = 2 * (LONG_CHANGES + 2 * LONG_NEW) * LONG_OPS
    for farm in lfarms:
        if int(farm.engine.lengths.sum()) != want_rows:
            raise RuntimeError(f"a long-history farm holds "
                               f"{int(farm.engine.lengths.sum())} rows, want "
                               f"{want_rows}")
    log(f"phase 10 long history: 2 docs x {LONG_CHANGES} changes x "
        f"{LONG_OPS} ops, a fresh peer joins, then {LONG_NEW} changes a "
        f"side and a reconnect, card {card}")
    log(f"  load {lstats['load_s']:.3f} s; join {lstats['join_s']:.3f} s in "
        f"{len(lstats['join'])} sweeps; edits {lstats['edit_s']:.3f} s; "
        f"reconnect {lstats['rejoin_s']:.3f} s in {len(lstats['rejoin'])} "
        f"sweeps; whole phase {time.perf_counter() - t0:.3f} s (run "
        f"{run_s:.3f} s); kernel launches: {launches10}")
    cluster = log_bloom_shapes(rec_build10, rec_query10)
    for name, n in launches10.items():
        if n <= 0:
            raise RuntimeError(f"the long-history sync never launched {name}")
    if cluster < 2:
        raise RuntimeError("the long-history sync built no filter on a "
                           "cluster of blocks")
    if not any(c > 256 and live > 0
               for (_, c, _), (_, live) in rec_query10.shapes.items()):
        raise RuntimeError("the long-history sync queried no live filter "
                           "with more than 256 candidates")
    long_server = lfarms[0]  # phase 12 reuses its loaded history
    del lfarms, lstats["syncs"]
    # the kernels at phase 10's largest launches: exactness, times, bounds
    check_build(*rec_build10.args)
    check_query(*rec_query10.args)
    for row, wide, n in zip(
            table["kernels"],
            bloom_timings(bk, rec_build10.args, rec_query10.args, floor_ms),
            (launches10["bloom_build"], launches10["bloom_query"])):
        row["wide"] = {**wide, "launches": n}
    log_bloom_rows(table["kernels"], "wide")

    # 11. mixed-protocol sync: replicas 0-3 on v2 channels, 4-7 on v1
    prof11 = PhaseProfile()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    t0 = time.perf_counter()
    with recorded_bloom_launches() as (rec_build11, rec_query11), \
            recorded_reductions() as rec_red11, \
            counted_generate_calls() as gen_calls:
        mfarms, mstats = run_scenario(device, args.v2_docs, args.replicas,
                                      args.changes, args.ops, args.seed,
                                      prof=prof11,
                                      v2_replicas=MIXED_V2_REPLICAS)
    launches11 = dict(bk.LAUNCHES)
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    check_converged(mfarms, args.v2_docs)
    check_no_fallback(fallbacks, mfarms, "phase 11")
    check_s = time.perf_counter() - t1
    for name, n in launches11.items():
        if n <= 0:
            raise RuntimeError(f"the mixed sync never launched {name}")
    dispatches = sum(s.fingerprints.dispatches for s in mstats["syncs"])
    if gen_calls["wrong"] or dispatches != gen_calls["with_queries"] or \
            dispatches == 0:
        raise RuntimeError(
            f"{dispatches} fingerprint reductions for "
            f"{gen_calls['with_queries']} generate calls with v2 queries; "
            f"calls off one per call (channels with queries, reductions): "
            f"{gen_calls['wrong']}")
    total_ops = args.v2_docs * args.replicas * args.changes * args.ops
    if int(mfarms[0].engine.lengths.sum()) != total_ops:
        raise RuntimeError("the mixed sync's server lacks rows")
    sweeps = mstats["sweeps"]
    log(f"phase 11 mixed-protocol sync: {args.v2_docs} docs x "
        f"{args.replicas} replicas ({MIXED_V2_REPLICAS} on v2 channels) x "
        f"{args.changes} changes x {args.ops} ops, card {card}")
    log(f"  edits {mstats['edit_s']:.3f} s; sync {mstats['sync_s']:.3f} s in "
        f"{len(sweeps)} sweeps; convergence check {check_s:.3f} s; whole "
        f"phase {time.perf_counter() - t0:.3f} s (run {run_s:.3f} s)")
    log_sweeps(sweeps)
    log(f"  merged rows during sync: {mstats['merged_rows']} "
        f"({mstats['merged_rows'] / mstats['sync_s']:.0f} ops/s); kernel "
        f"launches: {launches11}; fingerprint reductions {dispatches} (one "
        f"per generate call with v2 queries; up to "
        f"{gen_calls['most_channels']} v2 channels with queries in one)")
    log("  phase table (mixed sync, host clock):")
    for line in prof11.table().splitlines():
        log("    " + line)
    log_bloom_shapes(rec_build11, rec_query11)
    _, _, build_err11 = check_build(*rec_build11.args)
    query_err11 = check_query(*rec_query11.args)
    for row, n, err in zip(table["kernels"],
                           (launches11["bloom_build"],
                            launches11["bloom_query"]),
                           (build_err11, query_err11)):
        row["mixed"] = {"launches": n, "max_abs_err": err}
    log(f"  Bloom kernels at this phase's largest launches: bit-exact "
        f"(build {build_err11}, query {query_err11})")
    log_reductions(rec_red11, reduction_row(rec_red11.args, floor_ms))
    del mfarms, mstats

    # 12. a long history over v2: phase 10's loaded server, a fresh peer
    t0 = time.perf_counter()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    with recorded_reductions() as rec_red12:
        vfarms, vstats = run_long_history(device, 2, LONG_CHANGES, LONG_OPS,
                                          LONG_NEW, args.seed, v2=True,
                                          server=long_server, actors=(4, 5))
    launches12 = dict(bk.LAUNCHES)
    run_s = time.perf_counter() - t0
    check_converged(vfarms, 2)
    check_no_fallback(fallbacks, vfarms, "phase 12")
    n_changes = len(vfarms[0].get_all_changes(0))
    bound = 2 * np.log2(n_changes) + 2
    trips = {k: sum(1 for sw in vstats[k] if sw.moved)
             for k in ("join", "rejoin")}
    if max(trips.values()) > bound:
        raise RuntimeError(f"v2 took {trips} round trips, bound {bound:.1f}")
    v2_bytes = {k: sum(sw.bytes for sw in vstats[k]) for k in trips}
    v1_bytes = {k: sum(sw.bytes for sw in lstats[k]) for k in trips}
    log(f"phase 12 long history over v2: 2 docs of {n_changes} changes "
        f"(phase 10's server), a fresh peer joins, then {LONG_NEW} changes a "
        f"side and a reconnect, card {card}")
    log(f"  join {vstats['join_s']:.3f} s, {trips['join']} round trips; "
        f"edits {vstats['edit_s']:.3f} s; reconnect {vstats['rejoin_s']:.3f} "
        f"s, {trips['rejoin']} round trips (bound 2*log2(n)+2 = "
        f"{bound:.1f}); whole phase {time.perf_counter() - t0:.3f} s (run "
        f"{run_s:.3f} s)")
    log(f"  bytes moved: join {v2_bytes['join']} (phase 10's v1: "
        f"{v1_bytes['join']}), reconnect {v2_bytes['rejoin']} (v1: "
        f"{v1_bytes['rejoin']}); Bloom launches {launches12}; fingerprint "
        f"reductions {sum(s.fingerprints.dispatches for s in vstats['syncs'])}")
    log_reductions(rec_red12, reduction_row(rec_red12.args, floor_ms))
    del vfarms, vstats, long_server

    # 13. supervised channels: single-document clients against the farm
    fallbacks = fallback_counts()
    sfarm, clients, pairs, frames, sstats = run_sessions(
        device, SESSION_DOCS, args.seed)
    totals = check_sessions(sfarm, clients, pairs, frames)
    check_no_fallback(fallbacks, [sfarm], "phase 13")
    log(f"phase 13 supervised channels: {SESSION_DOCS} docs, a "
        f"host client per doc against the farm on the card, "
        f"{SESSION_DOCS // 2} pairs on v2, {SESSION_LOSS:.0%} of frames "
        f"dropped, every session saved and restored at step 3; converged in "
        f"{sstats['steps']} steps ({sstats['sim_s']:.2f} simulated s, "
        f"{sstats['s']:.3f} s), card {card}")
    for proto, t in totals.items():
        log(f"  {proto}: {t['frames']} frames ({t['payloads']} with a "
            f"payload, {t['dropped']} dropped), {t['retransmits']} "
            f"retransmissions, {t['watchdog']} watchdog events")
    del sfarm, clients, pairs, frames

    # 14. a device fault on the card: bisection, quarantine, the walk
    fstats = run_device_fault(device, args.fault_docs, 2, args.seed)
    log(f"phase 14 device fault: {args.fault_docs} map docs + 2 list docs, "
        f"farm.device_dispatch fails with doc {fstats['k']} in the batch: "
        f"doc {fstats['k']} quarantined (device) and rolled back, survivors "
        f"walk-served with the control farm's patches, and degraded docs "
        f"equal to it after the next call; counters {fstats['round1']}; "
        f"then every dispatch failing: nobody blamed, {fstats['round3']}; "
        f"{fstats['s']:.3f} s, card {card}")

    # 15. the store on the card: WAL cost, batched cold start, recovery
    t0 = time.perf_counter()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    root = tempfile.mkdtemp(prefix="chip-smoke-store-")
    try:
        with recorded_bloom_launches() as (rec_build15, rec_query15), \
                counting_fallbacks():
            sstats = run_store(device, args.store_docs, STORE_ROUNDS,
                               STORE_OPS, args.seed, root)
        launches15 = dict(bk.LAUNCHES)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_no_fallback(fallbacks, [], "phase 15")
    log_store(sstats, args.store_docs, STORE_ROUNDS, STORE_OPS, card)
    log(f"  whole phase {time.perf_counter() - t0:.3f} s; kernel launches: "
        f"{launches15}")
    check_launched(table, launches15, rec_build15, rec_query15, "store",
                   "phase 15")

    # 16. the serving front door on the card
    t0 = time.perf_counter()
    serve_docs = max(1, args.serve_clients // SERVE_CLIENTS_PER_DOC)
    prof16 = PhaseProfile()
    bk.reset_launch_counts()
    with recorded_bloom_launches() as (rec_build16, rec_query16):
        sfarm, report = run_serve(device, args.serve_clients,
                                  serve_docs, args.seed, prof=prof16)
    launches16 = dict(bk.LAUNCHES)
    check_serve(sfarm, report, args.serve_clients, "phase 16")
    log_serve(report, args.serve_clients, serve_docs, prof16, card)
    log(f"  whole phase {time.perf_counter() - t0:.3f} s; kernel launches: "
        f"{launches16}")
    check_launched(table, launches16, rec_build16, rec_query16, "serve",
                   "phase 16")
    del sfarm

    log(card)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

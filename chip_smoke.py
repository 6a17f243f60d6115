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
   native codecs must be on (``native.available()``: the repo's
   ``native/codecs.cpp`` built with ``g++`` into ``build/native/``), and
   the phase logs the share of ``decode`` in the farm phases. The
   kernels are then held against their plain versions again on the
   inputs of their largest main-path launch and timed there: device time
   per launch from a CUDA-graph replay, time per eager call, the launch
   floor, and the profiler's kernel mean as a cross-check
   (``kernel_times``);
4. the same scenario at 16 documents, then phase 11's mixed v1/v2 sync
   and phase 13's supervised channels at 16 documents, phase 15's store
   at 16 documents, phase 16's serving at 64 clients over 16 docs with
   30 % chaos and a store attached, phase 17's API clients at 8
   documents, a 16-doc ``MeshFarm`` of 4 shards (inline, then over
   process workers on the pickle transport; doc 0 migrated mid-run), and
   phase 20's dense merge at 16 docs, and phase 21's runs at 16 docs
   (the fault run at 25 %, the gate in both modes, the have filters and
   the sweep with malformed peers), once on the card and once on the
   CPU: every sync message, patch, outcome, session frame, saved session,
   load report, store file, ``save()``, filter and dense column must be
   byte-identical, and the two meshes' patches too;
5. hold the LEB128 segmented-sum kernel against its plain version on the
   card, bit-exact, at edge inputs (``segsum_edge_inputs``), each of which
   must take the pass its ids call for (the sorted pass, or the general
   pass behind a descending pair), and run streams of 1- to 8-byte
   varints (unsigned and signed) through the device scan;
6. the repo's configuration 2 ("Automerge.Text: 2-actor concurrent
   insert/delete, 10k ops") on ``BatchedTextEngine`` at ``--text-docs``
   (256) documents: a 64-insert seed, then 100 rounds of one 50-op
   change per actor per doc (80 % inserts, 20 % deletes, tied counters).
   Every doc's visible length must match the traffic and 16 sampled docs
   must equal a plain host reference;
7. the same per-doc traffic through a server ``TorchDocFarm`` and one
   replica farm per actor at ``--farm-text-docs`` (2) documents (one change
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
11. mixed-protocol sync (``--v2-docs``, 64): phase 3's scenario with
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
15. the store (``--store-docs``, 64, x 6 rounds x one 256-op change: the
   JAX package's STORE_r01.json shape, its 256 docs cut to 64): the deliveries through a bare farm
   and through one with a ``ShardStore`` attached (fsync on), in turns
   bare, WAL, WAL, bare; the per-doc sequential loads of 16 docs against
   ``open_farm``'s batched cold start on the card, a clean recovery report
   and hydrated patches equal to the writer's for every doc, a fresh
   replica caught up over the Bloom sync, and, after one more round logged
   by the hydrated farm, a torn tail that recovers exactly the acked prefix
   (``run_store``);
16. the serving front door (``--serve-clients`` 512 over 64 docs, one
   doc per 8 clients: the JAX package's SERVE_r06.json shape cut from
   10,000 over 1,024): ``LoadGen``'s clients against ``AmServer`` and its
   ``DynamicBatcher`` over the farm on the card, 2 edits of 4 ops per
   client over 2.0 simulated s, the default batcher and session settings.
   Every client must converge (``run_serve``). Phases 15 and 16 hold both
   Bloom kernels bit-exact against their plain versions at their largest
   launches there;
17. the public API (``--api-docs``, 32): per doc 4 API clients
   (``automerge_tpu_torch.init`` with fixed actor ids) share client 0's
   seed change (a list, a Text, a Counter, a Table), then make 8 rounds
   of one 16-op ``change()`` each (root-map sets, list and Text inserts
   and deletes, a Counter increment, from round 2 a Table row; the time
   pinned). After each round every client's ``get_changes`` since its
   last push goes into one ``TorchDocFarm`` on the card in one
   ``apply_changes`` delivery, and every client syncs with the farm over
   the Bloom protocol (``generate_sync_message``/``receive_sync_message``
   against ``SyncFarm``) until no message moves (``run_api``). Every
   client's saved document must equal the farm's whole-document patch read
   through ``Frontend.apply_patch``, with the farm's heads, and its live
   document may differ from its saved one only at root keys where that
   holds a conflict, by another of the conflict's values; the phase runs
   with the program observatory on, and its ``kernel.bloom_*`` dispatch
   counts must equal the wrappers' launch counts;
18. ``python -m automerge_tpu_torch.obs --docs 64 --rounds 4 --json`` in a
   subprocess on the card: rc 0, a span tree, and a program table with
   both Bloom kernels and ``paging.apply_ops`` dispatched; then
   ``--ledger`` renders a two-record ledger in a temp directory and
   ``--diff -2 -1`` diffs it;
19. the doc-sharded mesh at the JAX package's MULTICHIP_r09.json shape
   (``--mesh-docs`` 8,192 over 8 shards, 2 rounds of one 256-op change
   per doc, the same change stream for every doc): (a) a ``MeshFarm`` of
   8 process workers, each with its own CUDA context on the card, over
   the shared-memory transport (no batch or result may fall back to the
   pipe), every change committed and nothing quarantined, against a solo
   shard-sized farm in this process (``wall_scaling``, the usable cores,
   per-shard dispatch seconds, pipe and ring bytes); (b) the same
   deliveries at 1,024 docs through the pickle transport and the inline
   backend, every patch byte-identical to (a)'s; (c) a migration over the
   pipe after round 0 with a clean ``audit()``, and a second reconcile
   pass that syncs 0; (d) a worker SIGKILLed mid-apply: its docs are
   quarantined, it respawns and re-hydrates, and after release they equal
   the inline mesh, with its black box in the crash dump; (e) a fresh
   replica of 256 docs catches up through a ``SyncFarm`` over the mesh
   (its filters on the card), and both Bloom kernels are held bit-exact
   at that phase's largest launches (the ``mesh`` entry of their rows).
20. the engine-level API: (a) ``bench.py``'s device workload
   (``bench_device`` at its defaults: 8,192 docs x 8 rounds x 64 ops,
   capacity 512; keys in [0, 64), one actor, SET, no preds,
   drawn from ``--seed`` as bench.py draws them) through the dense
   whole-state merge: the batches staged on the card, one warm-up, then
   8 ``batched_apply_ops`` and one ``batched_visible_state`` timed to a
   synchronize (ops/s); (b) the same at ``BASELINE.json``'s 100k-doc
   batch (100,000 docs), with the peak device memory.
   Each run's ``engine.apply_ops`` dispatches and dense merge kernel
   launches (``csrc/dense_merge.cu``) must equal the merges issued, and
   its first 256 docs must equal a CPU run (the plain version) on those
   docs in all 7 state and 5 visibility columns. (c) The kernel on the
   dense-100k cell's own traffic (12,500 docs x 14,000 rows, 80 change
   rows a round drawn by ``benchmark/schemas/dense.py``: markers, hides
   inside a round): equal to the plain version on the card in all 7
   columns after every round up to ~9,900 live rows a doc, and timed
   against it and its live-row bound at ~5,000 and ~9,900
   (``run_dense_cell_kernel``); its timings and launches are the kernel
   table's ``dense_merge`` row. Then a
   ``BatchTranscoder`` + ``BatchedMapEngine`` round of 64 docs (nested
   maps, tables, counters) must decode to the same documents on the card
   as on the CPU, and ``python -m automerge_tpu_torch.analysis`` must exit
   0.
21. the per-document fault domains: (a) ``bench.py --faults``'s
   degradation curve at 1,024 docs, one actor's stream of 8 rounds x one
   64-op change delivered to every doc with ``quarantine_threshold=None``
   and ``isolation="doc"``, at 0, 10 and 25 % poisoned docs (spread by
   stride, each poisoned delivery through a ``BYTE_CORPUS`` corrupter in
   turn): healthy-doc ops/s, ``vs_clean``, quarantined deliveries and
   their causes, the phase table; every healthy doc must read as the
   clean run's and every poisoned doc as a doc that received nothing (in
   heads, log and the full-state readback; the first 512 docs in the
   whole-doc patch too), and the allocator must hold exactly the pages
   the page tables name; (b) at bench.py's default 512 docs, the 10 %
   deliveries with the default threshold (3): the poisoned docs are shed
   from their fourth delivery, then ``release_quarantine()`` and one
   clean delivery bring every doc to the clean run's state; (c)
   ``isolation="batch"`` on (b)'s farm: one doc over the packing range
   rejects the whole call, and ``_read_visibility``, heads and logs read
   the same before and after; (d) phase 3's traffic at 64
   docs with each replica's changes in swapped pairs (every other
   delivery defers in the causal gate) through ``gate_mode="columnar"``
   and ``"oracle"`` on the card and columnar on the CPU, every outcome
   and patch identical; (e) ``batched_have_filters`` over 64 backends,
   each filter equal to the sequential ``BloomFilter``'s and to the CPU's,
   then a 16-channel ``SyncFarm`` sweep in which channels 5 and 12 send a
   malformed message and are dropped: the other 14 converge and
   ``sync.messages.rejected`` counts 2. Both Bloom kernels must have
   launched in (e) and are held bit-exact at their largest launches there.
22. the farm held to the reference on the JAX suite's own cases
   (``run_farm_phase``): (a) the nine ``TestFarmBasics`` cases of
   tests/test_farm.py on the card, every farm call's patch equal to the
   port's ``OpSet`` and every record to a CPU run's; (b) the suite's
   differential traffic (``FarmWorkload``, a copy of its ``Workload``:
   seed 4, 3 actors, counters, nesting and deletes, ``delay_prob`` 0.5) at
   phase 3's 512 docs x 12 rounds + 3 drain rounds, every round's patch of
   every doc equal to ``OpSet``'s, then every doc's whole patch, heads and
   missing deps; (c) ``BASELINE.json`` ``configs[2]`` ("Counter CRDT: 64
   actors, 100k concurrent increments") on 16 docs: one change makes the
   root counter, then 64 actors x 25 changes x 64 ``inc`` ops of 1, round
   r carrying every actor's r-th change in a seeded shuffle; after round r
   every doc's counter reads 4,096 r, docs 0-1's patches equal a CPU
   farm's, no page is leaked, and a cut of 64 actors x 25 changes x 1
   increment on 2 docs is held to ``OpSet`` round by round (its cost grows
   with changes x rows); wall time, increments/s, the phase table, peak
   device memory, pages and ``engine.slab.grow`` events are logged; (d)
   tests/test_sync_v2.py's ``TestFarmBatchedFingerprints`` on the card: at
   most one ``sync.fingerprint_ranges`` dispatch per ``generate_messages``
   call (the port's observatory), converged, one dispatch for a sweep with
   every channel probing and none for an empty query list, card equal to
   CPU; (e) tests/test_obs.py's two-call farm case on the card:
   ``engine.device.dispatches`` 6, cache hits plus recompiles equal to it,
   40 rows transcoded, no padding. No kernel runs on this path.
23. ``BASELINE.json`` ``configs[3]`` ("Table + nested list: 3-way
   concurrent branch merge (fuzz_test corpus)") on 128 docs
   (``run_branch_phase``; a stand-in corpus with shapes of its own, not
   the upstream fuzz test's). Per doc, built through the port's API with
   the time and the uuid factory pinned (``run_branch_corpus``):
   a base client makes a root ``Table`` of 8 rows, each a title, a flag
   and a 4-item list; three branch clients load it and make 4 epochs of
   4 ``change()`` calls of 1-3 edits (titles, item inserts, deletes and
   overwrites, rows added and removed; the mix made is logged); each
   epoch's new changes of all three branches, deduplicated by hash, go
   to one ``TorchDocFarm`` in one ``apply_changes`` call for every doc,
   and each branch applies the other two's. (a) Every delivery's patch
   of every doc equals the port's ``OpSet``'s and nothing is
   quarantined; op rows/s to a synchronize, per-delivery latency and the
   phase table. The lists make every doc a walk document, whose
   incremental patch is its embedded ``OpSet``'s, made on the host, so
   (a) holds host code; (b) holds the card's: after every delivery,
   every doc's whole-document patch from the farm (the device merge's
   rows, the visibility mirror, its elements ranked by
   ``batched_rga_rank`` on the card, timed by CUDA events), read through
   a frontend, equals the reference ``OpSet``'s whole document, heads
   too, and after the last every branch's saved document equals it,
   with the farm's heads (the branches' own documents are not compared
   before that: their incremental patches carry a fault both packages'
   ``OpSet`` share, ROADMAP queue C); (c) the first 64 docs'
   incremental patches, and their whole-document patches after every
   delivery, equal a CPU farm's; (d) a fresh replica catches up over the
   Bloom sync until no message moves, with equal heads and patches, and
   both Bloom kernels are held bit-exact at their largest launches there
   (the ``branch`` entry of their rows); (e) no fallback and no
   quarantine.

Every fault-free phase (3, 4, 6, 7, 10-13, 15-17, 19, 21-23) fails if the
degraded walk served a document (``farm.fallback.calls`` moved, or a
farm has ``degraded`` docs): only phase 14's injected fault may take it.

Each path's kernel launch counts are set to 0 just before it runs and
read just after. The line before the last is the kernel table (JSON); the
last line is ``{"ok": true, "device": {...}}``. Weights are the documents
themselves, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import importlib
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
# phase 6: the docs held to the plain host reference (~0.75 s each)
TEXT_SAMPLE = 16
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


def counts(names):
    """{name: value} of the named counters of this package's registry."""
    from automerge_tpu_torch.obs.metrics import get_metrics

    return {name: get_metrics().counter(name).value for name in names}


def fallback_counts():
    """The degraded walk's counters ({name: value}); they move only inside
    `counting_fallbacks`."""
    return counts(FALLBACK_COUNTERS)


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
    """Routes the two Bloom kernel programs (``kernel.bloom_build`` and
    ``kernel.bloom_query``; the sync path calls them by their ``sync.*``
    names) through `LargestLaunch` recorders while the block runs; yields
    (build, query). Build shapes are (B, E, W), query shapes (B, C, W)."""
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    build = LargestLaunch(
        bk.bloom_build.fn,
        lambda xyz, counts, w: ((xyz.shape[0], xyz.shape[1], w), counts))
    query = LargestLaunch(
        bk.bloom_query.fn,
        lambda words, modulo, counts, q: (
            (q.shape[0], q.shape[1], words.shape[1]), counts))
    bk.bloom_build.fn, bk.bloom_query.fn = build, query
    try:
        yield build, query
    finally:
        bk.bloom_build.fn, bk.bloom_query.fn = build.fn, query.fn


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
def counted_generate_calls(count=None):
    """Checks ``SyncFarm.generate_messages`` call by call: a call whose v2
    channels planned fingerprint queries must dispatch exactly one
    reduction, any other call none. Yields a tally: the calls with
    queries, the most v2 channels with queries in one call, and the calls
    that broke the rule as (channels with queries, reductions).
    `count(sync_farm)` reads the reductions so far (default: the farm's
    fingerprint index's own count)."""
    from automerge_tpu_torch.tpu import sync_farm

    if count is None:
        def count(s):
            return s.fingerprints.dispatches

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
        before = count(self)
        out = plain_generate(self, channels, protocols)
        with_queries = sum(1 for n in planned if n)
        ran = count(self) - before
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
# package's STORE_r01.json shape, its 256 docs cut to 64 to keep the
# script inside its time limit), and the sample of the per-doc loads
STORE_DOCS, STORE_ROUNDS, STORE_OPS = 64, 6, 256
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
# 1,024 docs) cut to 512 clients over 64 docs, keeping its ~8 clients
# per doc; per client 2 edits of 4 ops spread over 2.0 simulated s
SERVE_CLIENTS, SERVE_CLIENTS_PER_DOC = 512, 8
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


# ---------------------------------------------------------------------- #
# the public API (phase 17): single-document clients through
# ``init``/``change``/sync against one farm

# phase 17: documents, API clients per document, rounds (one change per
# client per round), ops per change, and the changes' pinned time
# (seconds; the time is part of a change's bytes)
API_DOCS, API_CLIENTS, API_ROUNDS, API_OPS = 32, 4, 8, 16
API_TIME = 1_700_000_000
# phase 18: the obs CLI's documents per farm and change rounds
CLI_DOCS, CLI_ROUNDS = 64, 4


def api_actor(d, c):
    """Client `c` of doc `d`: a fixed 16-byte actor id."""
    return f"{d:08x}{c + 1:02x}" + "a5" * 11


def api_seed(api, d):
    """Doc `d`'s first change, by client 0: the shared objects every
    client edits (a list, a Text, a Counter and a Table) and a title."""
    return api.change(
        api.init(api_actor(d, 0)), {"time": API_TIME, "message": "seed"},
        lambda x: x.update({"title": f"doc {d}", "items": [],
                            "text": api.Text(), "count": api.Counter(0),
                            "rows": api.Table()}))


def api_edit(api, doc, rng, r, c):
    """Client `c`'s change of round `r` (from 1): API_OPS ops — from round 2
    on a Table row (3 ops), a Counter increment, a list insert and, past 4
    items, a list delete, a 3-character Text insert and, past 6
    characters, a Text delete, and sets on the root map for the rest."""
    n_items, n_text = len(doc["items"]), len(doc["text"])
    chars = rng.choices(LETTERS, k=3)
    used = (3 if r >= 2 else 0) + 1 + 1 + (n_items >= 4) + 3 + (n_text >= 6)
    keys = rng.sample(range(32), API_OPS - used)
    at_item, at_text = rng.randrange(n_items + 1), rng.randrange(n_text + 1)
    del_item, del_text = rng.randrange(n_items + 1), rng.randrange(n_text + 3)

    def edit(x):
        if r >= 2:
            x["rows"].add({"round": r, "client": c})
        x["count"].increment(1)
        x["items"].insert(at_item, f"{c}.{r}")
        if n_items >= 4:
            x["items"].delete_at(del_item)
        x["text"].insert_at(at_text, *chars)
        if n_text >= 6:
            x["text"].delete_at(del_text)
        for k in keys:
            x[f"k{k}"] = f"{c}.{r}.{k}"

    return api.change(doc, {"time": API_TIME + r, "message": f"round {r}"},
                      edit)


def sync_api(api, sync, clients, c_states, f_states, rec, prof):
    """Every client syncs with the farm over the Bloom protocol until no
    message moves: per sweep, each client generates (``generate_sync_message``)
    and the farm receives them in one ``receive_messages`` call, then the
    farm generates for every channel in one ``generate_messages`` call and
    each client receives (``receive_sync_message``). Returns [Sweep]."""
    from automerge_tpu_torch.profiling import use_profile

    channels = [(d, c) for d in range(len(clients))
                for c in range(len(clients[0]))]
    sweeps = []
    for _sweep in range(64):
        t0 = time.perf_counter()
        batch = []
        for d, c in channels:
            c_states[d][c], msg = api.generate_sync_message(clients[d][c],
                                                            c_states[d][c])
            rec(msg)
            if msg is not None:
                batch.append((d, c, msg))
        with use_profile(prof):
            got = sync.receive_messages(
                [(d, f_states[d][c], msg) for d, c, msg in batch]
            ) if batch else []
        for (d, c, _), (state, patch) in zip(batch, got):
            f_states[d][c] = state
            rec(canon(patch) if patch is not None else None)
        with use_profile(prof):
            out = sync.generate_messages(
                [(d, f_states[d][c]) for d, c in channels])
        moved = len(batch)
        nbytes = sum(len(m) for _, _, m in batch)
        for (d, c), (state, msg) in zip(channels, out):
            f_states[d][c] = state
            rec(msg)
            if msg is None:
                continue
            moved += 1
            nbytes += len(msg)
            clients[d][c], c_states[d][c], patch = api.receive_sync_message(
                clients[d][c], c_states[d][c], msg)
            rec(canon(patch) if patch is not None else None)
        sweeps.append(Sweep(time.perf_counter() - t0, moved, 0, nbytes))
        if moved == 0:
            return sweeps
    raise RuntimeError("the API clients' sync did not quiesce in 64 sweeps")


def run_api(device, docs, clients, rounds, seed, record=None, prof=None,
            api=None, make_farm=None, sync_cls=None):
    """Phase 17: per doc, `clients` API documents (``init`` with fixed
    actor ids; client 0's seed change shared by all) edit concurrently for
    `rounds` rounds of one ``api_edit`` change each. After each round
    every client's ``get_changes`` since its last push goes into one farm
    on `device` in one ``apply_changes`` delivery; then every client syncs
    with the farm until no message moves (``sync_api``). The uuid factory
    (Table row ids) runs a fixed sequence for the run. `record` collects
    every farm patch, every sync message and patch, and every client's
    ``save()``. `api`, `make_farm(docs, capacity)` and `sync_cls` default
    to this package's API, a ``TorchDocFarm`` on `device` and its
    ``SyncFarm``. Returns (farm, clients, stats)."""

    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    if api is None:
        import automerge_tpu_torch as api
        from automerge_tpu_torch import SyncFarm as sync_cls
        from automerge_tpu_torch import TorchDocFarm

        def make_farm(n, capacity):
            return TorchDocFarm(n, capacity=capacity, device=device)

    prof = prof or PhaseProfile(enabled=False)

    def rec(x):
        if record is not None:
            record.append(x)

    uuid_module = importlib.import_module(f"{api.__name__}.uuid")
    row_ids = iter(range(1, 1 << 62))
    uuid_module.set_factory(lambda: f"{next(row_ids):032x}")
    stats = {"edit_s": 0.0, "push_s": 0.0, "sync_s": 0.0, "sweeps": [],
             "changes": 0}
    try:
        t0 = time.perf_counter()
        docs_ = []
        pushed = []
        for d in range(docs):
            seed_doc = api_seed(api, d)
            first = api.get_all_changes(seed_doc)
            row = [seed_doc] + [
                api.apply_changes(api.init(api_actor(d, c)), first)[0]
                for c in range(1, clients)]
            docs_.append(row)
            pushed.append([api.init(api_actor(d, 0))] + row[1:])
        stats["edit_s"] += time.perf_counter() - t0
        capacity = 1 << (clients * rounds * API_OPS + 8 - 1).bit_length()
        farm = make_farm(docs, capacity)
        sync = sync_cls(farm)
        c_states = [[api.init_sync_state() for _ in range(clients)]
                    for _ in range(docs)]
        f_states = [[sync_cls.init_state() for _ in range(clients)]
                    for _ in range(docs)]
        for r in range(1, rounds + 1):
            t0 = time.perf_counter()
            for d in range(docs):
                for c in range(clients):
                    rng = random.Random(
                        (seed * 1_000_003 + d) * 4099 + c * 131 + r)
                    docs_[d][c] = api_edit(api, docs_[d][c], rng, r, c)
            t1 = time.perf_counter()
            stats["edit_s"] += t1 - t0
            bufs = [[b for c in range(clients)
                     for b in api.get_changes(pushed[d][c], docs_[d][c])]
                    for d in range(docs)]
            stats["changes"] += sum(len(b) for b in bufs)
            with use_profile(prof):
                result = farm.apply_changes(bufs)
            if result.quarantined:
                raise RuntimeError(f"API change quarantined: "
                                   f"{result.quarantined}")
            for patch in result:
                rec(canon(patch))
            _sync(device)
            t2 = time.perf_counter()
            stats["push_s"] += t2 - t1
            stats["sweeps"].append(sync_api(api, sync, docs_, c_states,
                                            f_states, rec, prof))
            _sync(device)
            stats["sync_s"] += time.perf_counter() - t2
            pushed = [list(row) for row in docs_]
        for row in docs_:
            for doc in row:
                rec(api.save(doc))
    finally:
        uuid_module.reset_factory()
    return farm, docs_, stats


def conflict_lag(api, live, saved, where):
    """The root keys at which the live document `live` differs from its
    own materialised copy `saved`. Each must be a key at which `saved`
    holds a conflict, with the live value one of the conflict's values:
    the incremental patch the backend hands the frontend after a delivery
    omits a key's concurrent value when the delivery's change sets keys
    out of key order (both packages' backends, ROADMAP queue C), so a live
    view can hold the losing value of a conflict until the document is
    materialised again. Any other difference raises."""
    lagging = []
    for key in sorted(set(live.keys()) | set(saved.keys())):
        if key in live and key in saved and api.equals(live[key], saved[key]):
            continue
        values = (api.get_conflicts(saved, key) or {}).values()
        if key not in live or not any(api.equals(live[key], v)
                                      for v in values):
            raise RuntimeError(
                f"{where}: the live document differs from its saved one at "
                f"{key!r}, and not by a value of a conflict there")
        lagging.append(key)
    return lagging


def check_api(farm, clients, what, api=None):
    """Phase 17's checks: every client's document, materialised from its
    own ``save()``, equals the farm's (its whole-document patch read
    through ``Frontend.apply_patch``), and its heads are the farm's; its
    live document equals the materialised one but at conflicted root keys
    (``conflict_lag``). Returns [(doc, client, lagging keys)] for the live
    documents that differ."""
    if api is None:
        import automerge_tpu_torch as api

    backend = api.get_backend()
    stale = []
    for d, row in enumerate(clients):
        farm_doc = api.Frontend.apply_patch(api.Frontend.init(),
                                            farm.get_patch(d))
        heads = farm.get_heads(d)
        for c, doc in enumerate(row):
            saved = api.load(api.save(doc))
            if not api.equals(saved, farm_doc):
                raise RuntimeError(f"{what}: doc {d} client {c}: its saved "
                                   "document differs from the farm's")
            state = api.Frontend.get_backend_state(doc, "check_api")
            if backend.get_heads(state) != heads:
                raise RuntimeError(f"{what}: doc {d} client {c}: heads "
                                   "differ from the farm's")
            lagging = conflict_lag(api, doc, saved,
                                   f"{what}: doc {d} client {c}")
            if lagging:
                stale.append((d, c, lagging))
    return stale


#: the farm's programs phase 17 must drive in every run (the visibility
#: readbacks and the RGA rank run as the farm's lazy reads call for them)
API_PROGRAMS = ("paging.apply_ops", "sync.build_filters",
                "sync.query_filters", "kernel.bloom_build",
                "kernel.bloom_query")


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


def run_api_phase(args, table, card, device):
    """Phase 17 (see the module docstring). Returns the phase's program
    table and its API changes per second."""
    from automerge_tpu_torch.obs.prof import (enabled_observatory,
                                              get_observatory)
    from automerge_tpu_torch.profiling import PhaseProfile
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    t0 = time.perf_counter()
    prof = PhaseProfile()
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    observatory = get_observatory()
    observatory.reset()
    with enabled_observatory(), \
            recorded_bloom_launches() as (rec_build, rec_query):
        farm, clients, stats = run_api(device, args.api_docs, API_CLIENTS,
                                       API_ROUNDS, args.seed, prof=prof)
    programs = observatory.table()
    launches = dict(bk.LAUNCHES)
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    stale = check_api(farm, clients, "phase 17")
    check_no_fallback(fallbacks, [farm], "phase 17")
    check_s = time.perf_counter() - t1
    for name in API_PROGRAMS:
        if programs.get(name, {}).get("dispatches", 0) <= 0:
            raise RuntimeError(f"phase 17 never dispatched {name}")
    for name, n in launches.items():
        if programs[f"kernel.{name}"]["dispatches"] != n:
            raise RuntimeError(
                f"phase 17: the observatory counts "
                f"{programs[f'kernel.{name}']['dispatches']} kernel.{name} "
                f"dispatches, the wrapper {n} launches")
    made = args.api_docs * API_CLIENTS * API_ROUNDS
    rate = made / stats["edit_s"]
    farm_s = sum(t for path, (t, _) in prof.totals_by_path().items()
                 if "/" not in path)
    walk_s = prof.totals_by_path().get("walk", (0.0, 0))[0]
    log(f"phase 17 API clients: {args.api_docs} docs x {API_CLIENTS} "
        f"clients x {API_ROUNDS} rounds x {API_OPS} ops "
        f"({made} API changes, {made * API_OPS} ops, "
        f"{stats['changes']} changes delivered), card {card}")
    log(f"  edits {stats['edit_s']:.3f} s ({rate:.0f} API changes/s on the "
        f"host); pushes {stats['push_s']:.3f} s; sync {stats['sync_s']:.3f} "
        f"s; checks {check_s:.3f} s; whole phase "
        f"{time.perf_counter() - t0:.3f} s (run {run_s:.3f} s)")
    for r, sweeps in enumerate(stats["sweeps"], 1):
        log(f"  round {r} sync: {len(sweeps)} sweeps, "
            f"{sum(sw.moved for sw in sweeps)} messages, "
            f"{sum(sw.bytes for sw in sweeps)} bytes, "
            f"{sum(sw.seconds for sw in sweeps):.3f} s")
    log(f"  every client's saved document equals the farm's and its heads "
        f"are the farm's; {len(stale)} of {args.api_docs * API_CLIENTS} "
        f"live documents lag it at {sum(len(k) for *_, k in stale)} root "
        "keys, each holding another value of a conflict there (the "
        "backend's incremental patch, both packages); no other difference")
    log(f"  farm phases {farm_s:.3f} s (walk {walk_s:.3f} s, "
        f"{walk_s / farm_s if farm_s else 0.0:.1%}); kernel launches "
        f"{launches}")
    log("  phase table (API farm, host clock):")
    for line in prof.table().splitlines():
        log("    " + line)
    log("  program table (observatory; dispatch_ms on the host clock, "
        "the enqueue time for card work):")
    for name, row in programs.items():
        log(f"    {name:<26} dispatches {row['dispatches']:>6}  buckets "
            f"{row['cache_size']:>3}  compiles {row['compiles']:>3}  "
            f"dispatch_ms {row['dispatch_ms']}")
    check_launched(table, launches, rec_build, rec_query, "api", "phase 17")
    return programs, rate


def obs_cli(*argv, timeout=600):
    """``python -m automerge_tpu_torch.obs`` in a subprocess, from the
    repo's root."""
    return subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.obs", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=timeout)


def run_cli_phase(args, programs17, api_rate, device):
    """Phase 18 (see the module docstring)."""
    import shutil
    import tempfile

    from automerge_tpu_torch.obs.ledger import append_record

    t0 = time.perf_counter()
    proc = obs_cli("--docs", str(args.cli_docs), "--rounds", str(CLI_ROUNDS),
                   "--device", device, "--json")
    if proc.returncode != 0:
        raise RuntimeError(f"the obs CLI exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if not out["spans"]:
        raise RuntimeError("the obs CLI printed an empty span tree")
    programs = out["programs"]
    for name in ("kernel.bloom_build", "kernel.bloom_query",
                 "paging.apply_ops"):
        if programs.get(name, {}).get("dispatches", 0) <= 0:
            raise RuntimeError(f"the obs CLI's program table lacks {name}")
    cli_s = time.perf_counter() - t0
    log(f"phase 18 obs CLI: --docs {args.cli_docs} --rounds {CLI_ROUNDS} "
        f"--device {device} --json, rc 0 in {cli_s:.3f} s (one process); spans "
        f"{[s['name'] for s in out['spans']]}; programs:")
    for name, row in programs.items():
        log(f"    {name:<26} dispatches {row['dispatches']:>5}  compiles "
            f"{row['compiles']:>3}  dispatch_ms {row['dispatch_ms']}")

    def rows(table):
        return {n: {"compiles": r["compiles"], "dispatches": r["dispatches"]}
                for n, r in table.items()}

    root = tempfile.mkdtemp(prefix="chip-smoke-ledger-")
    try:
        path = os.path.join(root, "ledger.jsonl")
        append_record(path, {"kind": "obs-cli", "programs": rows(programs),
                             "config": {"docs": args.cli_docs,
                                        "rounds": CLI_ROUNDS}})
        append_record(path, {"kind": "api", "programs": rows(programs17),
                             "ops_per_sec": api_rate,
                             "config": {"docs": args.api_docs,
                                        "clients": API_CLIENTS,
                                        "rounds": API_ROUNDS}})
        trajectory = obs_cli("--ledger", path, timeout=120)
        diff = obs_cli("--ledger", path, "--diff", "-2", "-1", timeout=120)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if trajectory.returncode or len(trajectory.stdout.splitlines()) != 4:
        raise RuntimeError(f"--ledger failed: {trajectory.stdout[-500:]} "
                           f"{trajectory.stderr[-500:]}")
    if diff.returncode or "programs:" not in diff.stdout:
        raise RuntimeError(f"--diff failed: {diff.stdout[-500:]} "
                           f"{diff.stderr[-500:]}")
    log("  --ledger (two records, a temp directory):")
    for line in trajectory.stdout.splitlines():
        log("    " + line)
    log("  --diff -2 -1:")
    for line in diff.stdout.splitlines():
        log("    " + line)
    log(f"  whole phase {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------- #
# phase 19: the doc-sharded mesh, MULTICHIP_r09.json's shape (8 shards x
# 8,192 docs x 2 rounds of one 256-op change, process workers, the shm
# transport); its (b)-(e) steps and phase 4's small mesh

MESH_DOCS, MESH_SHARDS, MESH_ROUNDS, MESH_OPS = 8192, 8, 2, 256
MESH_PARITY_DOCS, MESH_CATCHUP_DOCS = 1024, 256
# a hung worker fails the phase well inside the script's limit
MESH_WORKER_TIMEOUT_S = 300.0
# ring slots sized for the full shape's batches and result frames (about
# 1.6 MB a shard and delivery), as the JAX package's mesh bench sizes them
MESH_SHM_SLOTS, MESH_SHM_SLOT_BYTES = 4, 8 << 20
# phase 4's mesh: docs, shards, rounds, ops per change
MESH_SMALL = (16, 4, 3, 32)


def mesh_stream(rounds, ops, seed):
    """The change stream every doc of a phase-19 mesh takes, one change a
    round: `ops` uint sets on 64 root keys (``store_streams``' first
    stream, the JAX package's ``bench._make_change_stream``)."""
    return store_streams(1, rounds, ops, seed)[0]


def open_mesh(device, docs, shards, backend, transport, capacity,
              warm=None):
    from automerge_tpu_torch.parallel import MeshFarm

    return MeshFarm(docs, num_shards=shards, capacity=capacity,
                    device=device, mesh_backend=backend,
                    mesh_transport=transport,
                    worker_timeout=MESH_WORKER_TIMEOUT_S, warm_changes=warm)


def mesh_traffic(snap, shards):
    """Per shard, from a metrics snapshot: docs dispatched, dispatch
    seconds (the worker's ``apply_changes`` wall), pipe bytes in payload
    and in control frames, and the shm rings' bytes and stalls."""
    def value(name):
        return snap.get(name, {}).get("value", 0)

    return {s: {
        "docs": value(f"mesh.shard.{s}.docs"),
        "dispatch_s": snap.get(f"mesh.shard.{s}.dispatch_ms",
                               {}).get("sum", 0.0) / 1e3,
        "payload_bytes": value(f"mesh.pipe.{s}.payload_bytes"),
        "control_bytes": value(f"mesh.pipe.{s}.control_bytes"),
        "shm_bytes": (value(f"mesh.shm.{s}.bytes_out")
                      + value(f"mesh.shm.{s}.bytes_in")),
        "stalls": value(f"mesh.shm.{s}.stalls"),
    } for s in range(shards)}


def run_mesh_throughput(device, docs, shards, rounds, ops, seed,
                        transport="shm"):
    """Phase 19 (a): `docs` documents over `shards` process workers on
    `device` take `rounds` deliveries of one `ops`-op change each, the
    same change for every doc, with this package's registry on and a phase
    profile the workers fill. Before it, a solo shard-sized
    ``TorchDocFarm`` in this process takes the same stream (after a
    warm-up farm): the per-shard rate a perfectly scaling mesh keeps.
    Returns (mesh, stream, stats); the mesh stays open. The stream holds
    one more change, for step (d). The registry is zeroed before the
    timed rounds."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    stream = mesh_stream(rounds + 1, ops, seed)
    capacity = (rounds + 1) * ops
    shard_docs = docs // shards
    warm = TorchDocFarm(shard_docs, capacity=capacity, device=device)
    warm.apply_changes([[stream[0]]] * shard_docs)
    del warm
    solo = TorchDocFarm(shard_docs, capacity=capacity, device=device)
    solo_results = []
    solo_prof = PhaseProfile()
    t0 = time.perf_counter()
    with use_profile(solo_prof):
        for buf in stream[:rounds]:
            solo_results.append(solo.apply_changes([[buf]] * shard_docs))
    _sync(device)
    solo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = open_mesh(device, docs, shards, "process", transport, capacity,
                     warm=[stream[0]])
    spawn_s = time.perf_counter() - t0
    reg = get_metrics()
    reg.reset()
    prof = PhaseProfile()
    results = []
    t0 = time.perf_counter()
    with enabled_metrics(), use_profile(prof):
        for buf in stream[:rounds]:
            results.append(mesh.apply_changes([[buf]] * docs))
    elapsed = time.perf_counter() - t0
    snap = reg.as_dict()
    if mesh.transport != transport:
        raise RuntimeError(f"the mesh resolved to the {mesh.transport} "
                           f"transport, not {transport}")
    applied = snap.get("farm.changes.applied", {}).get("value", 0)
    if applied != docs * rounds:
        raise RuntimeError(f"the shards committed {applied} changes, want "
                           f"{docs * rounds}")
    for r, res in enumerate(results):
        if res.quarantined or mesh.quarantine:
            raise RuntimeError(f"round {r} quarantined "
                               f"{sorted(res.quarantined)[:8]}")
    traffic = mesh_traffic(snap, shards)
    if transport == "shm" and any(
            t["payload_bytes"] or t["stalls"] for t in traffic.values()):
        raise RuntimeError("a batch or a result left the shm rings for the "
                           f"pipe: {traffic}")
    # every doc holds the same stream: one doc per shard against the solo
    want = [canon(res[0]) for res in solo_results]
    whole = canon(solo.get_patch(0))
    for d in sorted({mesh._owners[s][0] for s in range(shards)} | {0}):
        if [canon(res[d]) for res in results] != want or \
                canon(mesh.get_patch(d)) != whole:
            raise RuntimeError(f"mesh doc {d} differs from the solo farm")
    total = docs * rounds * ops
    solo_rate = shard_docs * rounds * ops / solo_s
    cores = len(os.sched_getaffinity(0))
    return mesh, stream, {
        "results": results, "elapsed_s": elapsed, "spawn_s": spawn_s,
        "solo_s": solo_s, "solo_rate": solo_rate, "total_ops": total,
        "rate": total / elapsed, "wall_scaling": total / elapsed / solo_rate,
        "traffic": traffic, "prof": prof, "solo_prof": solo_prof,
        "cores": cores,
        "applied": applied, "capacity": capacity,
    }


def run_mesh_parity(device, docs, shards, stream, rounds, capacity, want,
                    flight_dir):
    """Phase 19 (b)-(d) at `docs` documents, the flight recorder on with
    `flight_dir` as its dump directory:

    (b) the same deliveries through a process mesh over the pickle
        transport and an inline mesh: every patch must equal `want[r][d]`,
        (a)'s canonical patch of doc d in round r;
    (c) after round 0 doc 0 migrates to another shard of the process mesh
        (export in one worker, adopt in another) with a clean ``audit()``;
        its patches stay (a)'s, its whole patch equals an unmigrated doc's,
        and a second reconcile pass syncs 0;
    (d) one worker SIGKILLs itself at its next apply (the stream's last
        change): its docs are quarantined as lost in flight, the worker
        respawns and re-hydrates, and after release and re-delivery every
        doc equals the inline mesh's; the dead worker's black box is in
        the crash dump.

    Returns stats."""
    from automerge_tpu_torch.obs.flight import enabled_flight, load_jsonl

    inline = open_mesh(device, docs, shards, "inline", "pickle", capacity)
    stats = {}
    with enabled_flight(dump_dir=flight_dir) as rec:
        rec.clear()
        t0 = time.perf_counter()
        proc = open_mesh(device, docs, shards, "process", "pickle",
                         capacity)
        stats["spawn_s"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            for r in range(rounds):
                per_doc = [[stream[r]]] * docs
                for name, mesh in (("inline", inline), ("pickle", proc)):
                    got = mesh.apply_changes(per_doc)
                    bad = [d for d in range(docs)
                           if canon(got[d]) != want[r][d]]
                    if bad:
                        raise RuntimeError(f"round {r}: the {name} mesh's "
                                           f"patches of docs {bad[:8]} differ "
                                           "from the shm run's")
                if r == 0:
                    src = proc.shard_of(0)
                    proc.migrate_doc(0, (src + 1) % shards)
                    proc.audit()
                    stats["migrated"] = (src, proc.shard_of(0))
            stats["parity_s"] = time.perf_counter() - t0
            other = next(d for d in range(1, docs)
                         if proc.shard_of(d) == stats["migrated"][0])
            if canon(proc.get_patch(0)) != canon(proc.get_patch(other)):
                raise RuntimeError("the migrated doc's patch differs from an "
                                   "unmigrated doc's")
            stats["reconcile"] = (proc.reconcile_actors(),
                                  proc.reconcile_actors())
            if stats["reconcile"][1] != 0:
                raise RuntimeError(f"reconcile did not converge: "
                                   f"{stats['reconcile']}")
            # (d): the heartbeat sequences behind the black-box flushes
            if set(proc.heartbeat().values()) != {"ok"}:
                raise RuntimeError("a worker missed the heartbeat")
            victim = 1
            bb_path = proc._handles[victim].spec["blackbox_path"]
            if not os.path.exists(bb_path):
                raise RuntimeError("the victim wrote no black box")
            t0 = time.perf_counter()
            proc.inject_worker_fault(victim, when="next_apply")
            per_doc = [[stream[rounds]]] * docs
            inline.apply_changes(per_doc)
            res = proc.apply_changes(per_doc)
            lost = sorted(res.quarantined)
            owned = sorted(d for d in range(docs)
                           if proc.shard_of(d) == victim)
            if lost != owned or not lost:
                raise RuntimeError(f"the crash quarantined {lost[:8]}, want "
                                   f"the victim's {owned[:8]}")
            if sorted(proc.release_quarantine()) != lost:
                raise RuntimeError("release did not return the lost docs")
            redo = proc.apply_changes([per_doc[d] if d in set(lost) else []
                                       for d in range(docs)])
            if redo.quarantined:
                raise RuntimeError("the re-delivery was quarantined")
            stats["recovery_s"] = time.perf_counter() - t0
            stats["lost"] = len(lost)
            bad = [d for d in range(docs)
                   if canon(proc.get_patch(d)) != canon(inline.get_patch(d))]
            if bad:
                raise RuntimeError(f"after the crash docs {bad[:8]} differ "
                                   "from the inline mesh")
        finally:
            proc.close()
            inline.close()
    dumps = [load_jsonl(open(p, encoding="utf-8").read())
             for p in rec.dump_paths if p.startswith(flight_dir)]
    crashes = [(events, e) for events in dumps for e in events
               if e["event"] == "mesh.worker.crash"]
    if not crashes:
        raise RuntimeError("the worker crash left no flight dump")
    events, crash = crashes[-1]
    fields = crash["fields"]
    box = [e for e in events[:events.index(crash)]
           if e.get("shard") == victim]
    if fields["shard"] != victim or fields["blackbox"] != bb_path or \
            not box:
        raise RuntimeError(f"the crash dump lacks the black box: {fields}")
    stats["blackbox_events"] = fields["blackbox_events"]
    stats["worker_events"] = len(box)
    return stats


def run_mesh_catchup(device, mesh, docs, capacity, rec):
    """Phase 19 (e): a fresh replica ``TorchDocFarm`` of `docs` documents
    catches up from the first `docs` documents of `mesh` through a
    ``SyncFarm`` over the mesh (filters built on the controller's device)
    until no message moves, then every doc must match. Returns
    (sweeps, seconds)."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    replica = TorchDocFarm(docs, capacity=capacity, device=device)
    t0 = time.perf_counter()
    sweeps = sync_until_quiet(device, SyncFarm(mesh), [SyncFarm(replica)],
                              docs, rec)
    seconds = time.perf_counter() - t0
    check_converged([mesh, replica], docs)
    return sweeps, seconds


def run_mesh_small(device, backend, seed, record):
    """Phase 4's mesh: ``MESH_SMALL`` docs over its shards (`backend`, the
    pickle transport), each doc its own stream of one change a round, doc
    0 migrated after round 1. `record` takes every round's patches, every
    whole-doc patch and the reconcile counts."""
    docs, shards, rounds, ops = MESH_SMALL
    streams = store_streams(docs, rounds, ops, seed)
    mesh = open_mesh(device, docs, shards, backend, "pickle",
                     rounds * ops + 8)
    try:
        for r in range(rounds):
            res = mesh.apply_changes([[streams[d][r]] for d in range(docs)])
            if res.quarantined:
                raise RuntimeError(f"phase 4 mesh ({backend}): "
                                   f"{sorted(res.quarantined)} quarantined")
            record.extend(canon(res[d]) for d in range(docs))
            if r == 1:
                mesh.migrate_doc(0, (mesh.shard_of(0) + 1) % shards)
                mesh.audit()
        record.extend(canon(mesh.get_patch(d)) for d in range(docs))
        record.append((mesh.reconcile_actors(), mesh.reconcile_actors()))
    finally:
        mesh.close()


def check_shm_room(shards):
    """Phase 19's rings must fit in /dev/shm: a segment past its free
    space is a SIGBUS at the first write, not an error."""
    import shutil

    from automerge_tpu_torch.parallel import shm

    slots, slot_bytes = shm.ring_sizes()
    need = 2 * shards * (slots * slot_bytes + (1 << 12))
    free = shutil.disk_usage("/dev/shm").free
    if free < need:
        raise RuntimeError(f"/dev/shm has {free} bytes free; phase 19's "
                           f"rings need {need}")
    return need, free


def run_mesh_phase(args, table, card, device):
    """Phase 19 (see the module docstring)."""
    import shutil
    import tempfile

    from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    os.environ.setdefault("AM_MESH_SHM_SLOTS", str(MESH_SHM_SLOTS))
    os.environ.setdefault("AM_MESH_SHM_SLOT_BYTES", str(MESH_SHM_SLOT_BYTES))
    docs, shards = args.mesh_docs, MESH_SHARDS
    need, free = check_shm_room(shards)
    t_phase = time.perf_counter()
    with counting_fallbacks(), enabled_metrics():
        mesh, stream, st = run_mesh_throughput(
            device, docs, shards, MESH_ROUNDS, MESH_OPS, args.seed)
        try:
            log(f"phase 19 mesh: {docs} docs over {shards} process workers "
                f"on {device} (shm transport), {MESH_ROUNDS} rounds of one "
                f"{MESH_OPS}-op change per doc, card {card}")
            log(f"  (a) {st['total_ops']} ops in {st['elapsed_s']:.3f} s: "
                f"{st['rate']:.0f} ops/s aggregate; solo shard-sized farm "
                f"({docs // shards} docs, this process) {st['solo_rate']:.0f}"
                f" ops/s; wall_scaling {st['wall_scaling']:.4f} with "
                f"{st['cores']} usable cores; spawn + warm-up of {shards} "
                f"workers {st['spawn_s']:.3f} s; changes applied "
                f"{st['applied']}; /dev/shm {free} bytes free, the rings "
                f"{need}")
            for s, t in st["traffic"].items():
                log(f"    shard {s}: {t['docs']} docs, dispatch "
                    f"{t['dispatch_s']:.3f} s, pipe payload "
                    f"{t['payload_bytes']} B / control {t['control_bytes']} "
                    f"B, rings {t['shm_bytes']} B, stalls {t['stalls']}")
            for what, prof in (("the workers' phases summed", st["prof"]),
                               ("the solo farm", st["solo_prof"])):
                log(f"  phase table ({what}, host clocks):")
                for line in prof.table().splitlines():
                    log("    " + line)
            parity_docs = min(MESH_PARITY_DOCS, docs)
            want = [[canon(res[d]) for d in range(parity_docs)]
                    for res in st.pop("results")]
            root = tempfile.mkdtemp(prefix="chip-smoke-flight-")
            try:
                ps = run_mesh_parity(device, parity_docs, shards, stream,
                                     MESH_ROUNDS, st["capacity"], want, root)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            log(f"  (b) {parity_docs} docs through the pickle transport and "
                f"the inline backend: every patch equal to (a)'s "
                f"({ps['parity_s']:.3f} s; spawn {ps['spawn_s']:.3f} s)")
            log(f"  (c) doc 0 migrated from shard {ps['migrated'][0]} to "
                f"{ps['migrated'][1]} after round 0: audit clean, patches "
                f"unchanged, equal to an unmigrated doc's; reconcile "
                f"{ps['reconcile']}")
            log(f"  (d) shard 1's worker SIGKILLed mid-apply: {ps['lost']} "
                f"docs lost in flight, respawned and re-hydrated, equal to "
                f"the inline mesh after re-delivery ({ps['recovery_s']:.3f} "
                f"s); crash dump holds {ps['worker_events']} of its events "
                f"({ps['blackbox_events']} from its black box)")
            catch_docs = min(MESH_CATCHUP_DOCS, docs)
            bk.reset_launch_counts()
            with recorded_bloom_launches() as (rec_build, rec_query):
                sweeps, catch_s = run_mesh_catchup(
                    device, mesh, catch_docs, st["capacity"],
                    lambda _msg: None)
            launches = dict(bk.LAUNCHES)
            log(f"  (e) a fresh replica of {catch_docs} docs caught up "
                f"through a SyncFarm over the mesh in {len(sweeps)} sweeps "
                f"({catch_s:.3f} s); kernel launches {launches}")
            log_sweeps(sweeps)
        finally:
            mesh.close()
        snap = get_metrics().as_dict()
    walked = {name: snap.get(name, {}).get("value", 0)
              for name in FALLBACK_COUNTERS}
    if any(walked.values()):
        raise RuntimeError(f"phase 19: the degraded walk ran {walked}")
    check_launched(table, launches, rec_build, rec_query, "mesh", "phase 19")
    log(f"  whole phase {time.perf_counter() - t_phase:.3f} s")


# phase 20: bench.py's device workload (bench_device, _child_main): docs x
# rounds x ops per round, capacity rounds x ops; and BASELINE.json's
# 100k-doc batch at the same per-doc shape
DENSE_DOCS, DENSE_BIG_DOCS, DENSE_ROUNDS, DENSE_OPS = 8192, 100_000, 8, 64
DENSE_KEYS = 64
# phase 20 (c): the dense-100k cell (its configuration and traffic, whose
# generator draws the rounds), the live rows a doc at which the kernel is
# timed, and the timed calls of the kernel and of the plain version
DENSE_CELL_CONFIG = os.path.join("benchmark", "configs", "dense-100k.json")
DENSE_CELL_TRAFFIC = os.path.join("benchmark", "traffic", "dense-fill-80.json")
DENSE_CELL_HELD = (5_000, 9_900)
DENSE_KERNEL_CALLS, DENSE_PLAIN_CALLS = 20, 5
# phase 20: docs each run's card rows are held against a CPU run on; the
# BatchTranscoder round's docs, rounds and ops per change
DENSE_CHECK_DOCS, TRANSCODER_DOCS, TRANSCODER_ROUNDS, TRANSCODER_OPS = (
    256, 64, 8, 6)


def dense_batches(docs, rounds, ops, seed):
    """bench.py's device workload as host arrays, drawn as ``bench_device``
    draws it: per round, keys in [0, 64), op = counter << 20 | 1 (one actor,
    counters running on across rounds), SET actions, random values, no
    preds. Returns one (key, op, action, value, pred) tuple per round."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        keys = rng.integers(0, DENSE_KEYS, (docs, ops)).astype(np.int32)
        ctrs = (r * ops + np.arange(1, ops + 1))[None, :] * np.ones(
            (docs, 1), np.int64)
        op = (ctrs.astype(np.int64) << 20) | 1
        values = rng.integers(0, 10**6, (docs, ops)).astype(np.int64)
        out.append((keys, op, np.zeros((docs, ops), np.int32), values,
                    np.full((docs, ops), -1, np.int64)))
    return out


def dense_live_bytes(held, new):
    """The bytes a dense merge needs, live rows only, as the benchmark's
    ``harness/roofline.py`` counts them: `held` live rows read, `held` +
    `new` written at 33 B, `new` change rows read at 32 B (both summed
    over the documents)."""
    return (2 * held + new) * 33 + new * 32


def dense_bound_ms(docs, capacity, rounds, ops):
    """The least time the card could take for phase 20's timed work, by
    bytes: each merge reads and writes the whole state (33 B a row: key
    4, op 8, action 4, value 8, pred 8, overwritten 1; num_ops 4 a doc)
    and reads its batch (32 B an op); the visibility pass reads the state
    and writes 22 B a row (key 4, op 8, visible 1, winner 1, total 8)."""
    state = docs * capacity * 33 + docs * 4
    merges = rounds * (2 * state + docs * ops * 32)
    return (merges + state + docs * capacity * 22) / HBM_BYTES_PER_S * 1e3


def run_dense(device, batches, capacity, warm=True):
    """Phase 20 (a)/(b): the dense whole-state merge as bench.py times it.
    The batches are staged on `device` first; with `warm`, one merge and
    one visibility pass on a throwaway state run before the clock. Then
    every round merges (``batched_apply_ops``) and one
    ``batched_visible_state`` follows, ending in a synchronize. Returns
    (state, visibility, seconds)."""
    from automerge_tpu_torch.tpu import engine

    docs = batches[0][0].shape[0]
    staged = [engine.changes_from_numpy(*b, device=device) for b in batches]
    if warm:
        w = engine.batched_apply_ops(
            engine.make_empty_state(docs, capacity, device=device), staged[0])
        engine.batched_visible_state(w)
        del w
    state = engine.make_empty_state(docs, capacity, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for batch in staged:
        state = engine.batched_apply_ops(state, batch)
    vis = engine.batched_visible_state(state)
    _sync(device)
    return state, vis, time.perf_counter() - t0


def dense_breakdown(device, batches, capacity, top=6):
    """One torch.profiler trace of phase 20's timed work on a fresh state
    (the merges of the staged batches and one visibility pass, ending in a
    synchronize), for the record: the host clock, the device's busy time
    and idle share, its op count and the device ops that take most of it,
    with the dense merge kernel's launches and time apart
    (``merge_kernel``). None, with the reason logged, when the profiler
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from automerge_tpu_torch.tpu import engine

    docs = batches[0][0].shape[0]
    staged = [engine.changes_from_numpy(*b, device=device) for b in batches]
    state = engine.make_empty_state(docs, capacity, device=device)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in staged:
                state = engine.batched_apply_ops(state, batch)
            engine.batched_visible_state(state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
    except Exception as exc:  # noqa: BLE001 - a record, not a check
        log(f"  dense breakdown: the profiler failed: {exc!r}")
        return None
    ops, launches, kernel = {}, 0, {"launches": 0, "ms": 0.0}
    for evt in events:
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        ops[evt.key] = ops.get(evt.key, 0.0) + dev_us / 1e3
        launches += evt.count
        if "dense_merge_kernel" in evt.key:
            kernel["launches"] += evt.count
            kernel["ms"] += dev_us / 1e3
    busy = sum(ops.values())
    return {
        "wall_ms": wall_ms, "device_ms": busy, "device_ops": launches,
        "merge_kernel": kernel,
        "device_idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
        "top": [[name[:72], ms, ms / busy if busy else None]
                for name, ms in sorted(ops.items(), key=lambda kv: -kv[1])
                [:top]],
    }


def dense_columns(state, vis, docs):
    """The 7 state columns and 5 visibility columns of the first `docs`
    docs, as host arrays."""
    return [np.asarray(c[:docs].cpu()) for c in (*state, *vis)]


def check_dense(device, batches, capacity, state, vis, what):
    """Docs are independent: the first ``DENSE_CHECK_DOCS`` docs of a run
    on `device` must equal a CPU run on those docs alone, every column
    exactly. Returns the number of docs compared."""
    n = min(DENSE_CHECK_DOCS, batches[0][0].shape[0])
    small = [tuple(c[:n] for c in b) for b in batches]
    cpu_state, cpu_vis, _ = run_dense("cpu", small, capacity, warm=False)
    names = ("key", "op", "action", "value", "pred", "overwritten",
             "num_ops", "vis.key", "vis.op", "visible", "winner",
             "value_total")
    for name, got, want in zip(names, dense_columns(state, vis, n),
                               dense_columns(cpu_state, cpu_vis, n)):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise RuntimeError(f"{what}: column {name} of the first {n} docs "
                               f"differs between {device} and the CPU")
    return n


def transcoder_stream(docs, rounds, ops, seed):
    """Seeded frontend op dicts for ``BatchTranscoder``: per round and doc
    one change of 1..`ops` ops by one of 3 actors, with deps on everything
    before it: sets (uint values and strings) on 8 keys of the root map
    and of nested maps, makeMap and makeTable children, deletes, counters
    on the root map and increments of them. Returns ``rounds`` lists of
    per-doc ``(actor, seq, start_op, ops)``, and per doc the root keys
    that hold counters."""
    rng = random.Random(seed)
    actors = ["aaaaaaaa", "bbbbbbbb", "cccccccc"]
    objects = [["_root"] for _ in range(docs)]
    last_op = [{} for _ in range(docs)]    # (obj, key) -> (opId, counter?)
    seqs = [dict.fromkeys(actors, 0) for _ in range(docs)]
    max_op = [0] * docs
    counters = [set() for _ in range(docs)]
    out = []
    for _ in range(rounds):
        per_doc = []
        for d in range(docs):
            actor = rng.choice(actors)
            seqs[d][actor] += 1
            start = ctr = max_op[d] + 1
            change_ops = []
            for _ in range(rng.randrange(1, ops + 1)):
                obj = rng.choice(objects[d])
                key = f"k{rng.randrange(8)}"
                prev = last_op[d].get((obj, key))
                pred = [prev[0]] if prev else []
                roll = rng.random()
                if prev and prev[1]:
                    if roll < 0.6:
                        change_ops.append({"action": "inc", "obj": obj,
                                           "key": key, "pred": pred,
                                           "value": rng.randrange(1, 10)})
                        ctr += 1
                    continue  # counters are only incremented
                if roll < 0.12:
                    action = "makeMap" if roll < 0.08 else "makeTable"
                    op = {"action": action, "obj": obj, "key": key,
                          "pred": pred}
                    objects[d].append(f"{ctr}@{actor}")
                elif roll < 0.22 and prev:
                    op = {"action": "del", "obj": obj, "key": key,
                          "pred": pred}
                elif roll < 0.3 and prev is None and obj == "_root":
                    op = {"action": "set", "obj": obj, "key": key,
                          "datatype": "counter", "pred": [],
                          "value": rng.randrange(100)}
                    counters[d].add(key)
                elif roll < 0.4:
                    op = {"action": "set", "obj": obj, "key": key,
                          "pred": pred, "value": f"s{rng.randrange(50)}"}
                else:
                    op = {"action": "set", "obj": obj, "key": key,
                          "datatype": "uint", "pred": pred,
                          "value": rng.randrange(1000)}
                if op["action"] == "del":
                    last_op[d].pop((obj, key), None)
                else:
                    last_op[d][(obj, key)] = (
                        f"{ctr}@{actor}", op.get("datatype") == "counter")
                change_ops.append(op)
                ctr += 1
            max_op[d] = ctr - 1
            per_doc.append((actor, seqs[d][actor], start, change_ops))
        out.append(per_doc)
    return out, counters


def run_transcoder(device, stream, counters, capacity=64, tpu=None):
    """One ``BatchTranscoder`` + ``BatchedMapEngine`` run over
    ``transcoder_stream``'s rounds (one ``apply_batch`` a round), decoded
    per doc by ``decode_visible``. `tpu` defaults to this package's
    ``automerge_tpu_torch.tpu`` on `device`; another package's ``tpu``
    module runs on its own default device. Returns the decoded docs."""
    if tpu is None:
        from automerge_tpu_torch import tpu

        engine = tpu.BatchedMapEngine(len(counters), capacity=capacity,
                                      device=device)
        kwargs = {"device": device}
    else:
        engine = tpu.BatchedMapEngine(len(counters), capacity=capacity)
        kwargs = {}
    tr = tpu.BatchTranscoder()
    for per_doc in stream:
        rows = [[(op, start + i, actor) for i, op in enumerate(change_ops)]
                for actor, _seq, start, change_ops in per_doc]
        engine.apply_batch(tr.changes_to_batch(rows, **kwargs))
    keys, ops, _visible, winners, values = engine.visible_state()
    return [
        tr.decode_visible(keys[d], ops[d], winners[d], values[d],
                          {tr.slot_id("_root", k) for k in counters[d]})
        for d in range(len(counters))
    ]


def time_dense_merge(apply, base, scratch, changes, calls):
    """Device ms of one ``apply(scratch, changes)``, the median of `calls`,
    each on a fresh copy of the state `base` in `scratch` (the copy is not
    timed): CUDA events on the current stream around the call."""
    import torch

    times = []
    for _ in range(calls):
        for s, b in zip(scratch, base):
            s.copy_(b)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        apply(scratch, changes)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def dense_cell_epoch(device, seed):
    """The dense-100k cell's configuration and one epoch of its traffic,
    drawn on `device` from `seed` by the cell's own generator
    (``benchmark/schemas/dense.py``: ``Epoch``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(root, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness import plugins

    with open(os.path.join(root, DENSE_CELL_CONFIG)) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, DENSE_CELL_TRAFFIC)) as fh:
        mix = json.load(fh)
    schema = plugins.load(root, "schemas", cfg["schema"])
    return cfg, schema.Epoch(cfg, mix, seed).draw(device)


def run_dense_cell_kernel(device, card, seed, held_at=DENSE_CELL_HELD):
    """Phase 20 (c): the dense merge kernel on the dense-100k cell's
    traffic (`dense_cell_epoch`: 12,500 docs x 14,000 rows, 80 change rows
    a round). Rounds merge into a kernel state and a plain-version state
    (``engine.apply_ops_plain``), which must be equal in all 7 columns
    after every round. When the live rows a document first reach each of
    `held_at`, both are timed on that round (``time_dense_merge``: the
    kernel ``DENSE_KERNEL_CALLS`` times, the plain version
    ``DENSE_PLAIN_CALLS``) beside the live-row bound, with the launch
    counts set to 0 just before each and read just after. Returns one row
    a held count."""
    import torch

    from automerge_tpu_torch.tpu import engine, merge_kernels

    t0 = time.perf_counter()
    cfg, epoch = dense_cell_epoch(device, seed)
    docs, rows, width = cfg["docs"], cfg["rows_per_doc"], epoch.width
    draw_s = time.perf_counter() - t0
    kern = engine.make_empty_state(docs, rows, device=device)
    plain = engine.make_empty_state(docs, rows, device=device)
    scratch = engine.make_empty_state(docs, rows, device=device)
    targets, out = list(held_at), []
    merged = 0
    for r, batch in enumerate(epoch.rounds):
        if not targets:
            break
        changes = engine.changes_from_numpy(*batch, device=device)
        held = int((kern.key != engine.PAD_KEY).sum())
        if held >= targets[0] * docs:
            targets.pop(0)
            new = int((changes.key != engine.PAD_KEY).sum())
            merge_kernels.reset_launch_counts()
            kernel_ms = time_dense_merge(engine.batched_apply_ops, plain,
                                         scratch, changes, DENSE_KERNEL_CALLS)
            launches = merge_kernels.LAUNCHES["dense_merge"] \
                / DENSE_KERNEL_CALLS
            merge_kernels.reset_launch_counts()
            plain_ms = time_dense_merge(engine.apply_ops_plain, plain,
                                        scratch, changes, DENSE_PLAIN_CALLS)
            if merge_kernels.LAUNCHES["dense_merge"]:
                raise RuntimeError("phase 20 (c): the plain version launched "
                                   "the dense merge kernel")
            bound_ms = dense_live_bytes(held, new) / HBM_BYTES_PER_S * 1e3
            out.append({"docs": docs, "rows": rows, "width": width,
                        "round": r, "held_per_doc": held / docs,
                        "new_per_doc": new / docs, "ms": kernel_ms,
                        "bound_ms": bound_ms,
                        "roofline_pct": 100 * bound_ms / kernel_ms,
                        "plain_ms": plain_ms, "launches": launches})
        engine.batched_apply_ops(kern, changes)
        engine.apply_ops_plain(plain, changes)
        merged += 1
        for name, a, b in zip(("key", "op", "action", "value", "pred",
                               "overwritten", "num_ops"), kern, plain):
            if not torch.equal(a, b):
                raise RuntimeError(
                    f"phase 20 (c): column {name} differs between the kernel "
                    f"and the plain version after round {r} at {docs} docs")
    if targets:
        raise RuntimeError(f"phase 20 (c): never reached {targets} live rows "
                           f"a document")
    for row in out:
        log(f"phase 20 (c) dense merge kernel on the dense-100k cell's "
            f"traffic, card {card}: {json.dumps(row)}")
    log(f"  kernel and plain version equal in all 7 columns after each of "
        f"{merged} rounds (rounds drawn in {draw_s:.3f} s; "
        f"{time.perf_counter() - t0:.3f} s)")
    del kern, plain, scratch, epoch
    return out


def dense_kernel_row(cell, launched):
    """The dense merge kernel's row of the kernel table: phase 20 (c)'s
    timings at its first held count, the later one under ``late``, and the
    launches of (a) and (b) under their tags."""
    def timing(row):
        return {k: row[k] for k in ("ms", "bound_ms", "plain_ms",
                                    "launches", "roofline_pct")} | {
            "shape": {k: row[k] for k in ("docs", "rows", "width",
                                          "held_per_doc", "new_per_doc")}}

    return {"name": "dense_merge", "route": "cuda",
            "source": "automerge_tpu_torch/csrc/dense_merge.cu",
            "replaces": None,
            "program": "automerge_tpu/tpu/engine.py:181 (XLA engine.apply_ops)",
            "max_abs_err": 0, **timing(cell[0]), "bound_by": "bytes",
            "library_ms": None, "late": timing(cell[-1]),
            **{tag: {"launches": n} for tag, n in launched.items()}}


def run_dense_phase(args, table, card, device):
    """Phase 20 (see the module docstring); adds the dense merge kernel's
    row to the kernel `table`."""
    import torch

    from automerge_tpu_torch.obs.prof import enabled_observatory, \
        get_observatory
    from automerge_tpu_torch.tpu import merge_kernels

    t_phase = time.perf_counter()
    capacity = DENSE_ROUNDS * DENSE_OPS
    obs = get_observatory()
    rates, launched_by = {}, {}
    for tag, docs in (("a", DENSE_DOCS), ("b", DENSE_BIG_DOCS)):
        t0 = time.perf_counter()
        batches = dense_batches(docs, DENSE_ROUNDS, DENSE_OPS, args.seed)
        gen_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        merge_kernels.reset_launch_counts()
        with enabled_observatory():
            obs.reset()
            state, vis, elapsed = run_dense(device, batches, capacity)
            applied = obs.program("engine.apply_ops").dispatches
            visible = obs.program("engine.visible_cmp").dispatches
            obs.reset()
        peak = torch.cuda.max_memory_allocated()
        launched = launched_by[f"dense_{tag}"] = \
            merge_kernels.LAUNCHES["dense_merge"]
        if applied != DENSE_ROUNDS + 1 or visible != 2 or launched != applied:
            raise RuntimeError(
                f"phase 20 ({tag}): {applied} engine.apply_ops and {visible} "
                f"engine.visible_cmp dispatches and {launched} dense merge "
                f"kernel launches for {DENSE_ROUNDS + 1} merges and 2 "
                f"visibility passes issued")
        total = docs * DENSE_ROUNDS * DENSE_OPS
        num_ops = state.num_ops.cpu().numpy()
        if not (num_ops == DENSE_ROUNDS * DENSE_OPS).all():
            raise RuntimeError(f"phase 20 ({tag}): num_ops off the ops "
                               f"merged")
        rows = int((state.key != (2**31 - 1)).sum())
        winners = int(vis[3].sum())
        if rows != total or any(tuple(c.shape) != (docs, capacity)
                                for c in (*state[:6], *vis)):
            raise RuntimeError(f"phase 20 ({tag}): {rows} rows held, want "
                               f"{total}, or a column off [{docs}, "
                               f"{capacity}]")
        t1 = time.perf_counter()
        n = check_dense(device, batches, capacity, state, vis,
                        f"phase 20 ({tag})")
        check_s = time.perf_counter() - t1
        rates[tag] = total / elapsed
        bound = dense_bound_ms(docs, capacity, DENSE_ROUNDS, DENSE_OPS)
        log(f"phase 20 ({tag}) dense whole-state merge (bench.py's device "
            f"workload): {docs} docs x {DENSE_ROUNDS} rounds x {DENSE_OPS} "
            f"ops, capacity {capacity}, card {card}")
        log(f"  {total} ops in {elapsed:.6f} s ({DENSE_ROUNDS} merges + one "
            f"visibility pass, synchronized): {total / elapsed:.1f} ops/s; "
            f"bytes bound {bound:.4f} ms ({elapsed * 1e3 / bound:.1f}x); "
            f"{winners} winning rows; peak device memory {peak} B "
            f"({peak / 2**30:.3f} GiB); batches drawn in {gen_s:.3f} s; "
            f"engine.apply_ops dispatches {applied} = dense merge kernel "
            f"launches = merges issued "
            f"(warm-up included); first {n} docs equal to a CPU run, all 12 "
            f"columns ({check_s:.3f} s)")
        del state, vis
        trace = dense_breakdown(device, batches, capacity)
        if trace is not None:
            log(f"  trace (torch.profiler, one more run): {json.dumps(trace)}")
        del batches
    cell = run_dense_cell_kernel(device, card, args.seed)
    table["kernels"].append(dense_kernel_row(cell, launched_by))
    # the engine-level API: BatchTranscoder + BatchedMapEngine, card vs CPU
    t0 = time.perf_counter()
    stream, counters = transcoder_stream(TRANSCODER_DOCS, TRANSCODER_ROUNDS,
                                         TRANSCODER_OPS, args.seed)
    on_card = run_transcoder(device, stream, counters)
    on_cpu = run_transcoder("cpu", stream, counters)
    if canon(on_card) != canon(on_cpu):
        raise RuntimeError("phase 20: the BatchTranscoder round decodes "
                           "differently on the card and the CPU")
    log(f"  BatchTranscoder + BatchedMapEngine: {TRANSCODER_DOCS} docs x "
        f"{TRANSCODER_ROUNDS} rounds decode to the same documents on the "
        f"card and the CPU ({time.perf_counter() - t0:.3f} s)")
    # the port's amlint on the card's host
    t0 = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.analysis"],
        capture_output=True, text=True, timeout=300)
    if lint.returncode != 0:
        raise RuntimeError(f"phase 20: python -m automerge_tpu_torch.analysis "
                           f"exited {lint.returncode}: "
                           f"{(lint.stdout + lint.stderr)[-2000:]}")
    log(f"  python -m automerge_tpu_torch.analysis: rc 0, "
        f"{lint.stdout.strip().splitlines()[-1]} "
        f"({time.perf_counter() - t0:.3f} s)")
    log(f"  whole phase {time.perf_counter() - t_phase:.3f} s; "
        f"ops/s (a) {rates['a']:.1f}, (b) {rates['b']:.1f}; dense merge "
        f"kernel ms a call (c) " + ", ".join(
            f"{row['ms']:.4f} at {row['held_per_doc']:.0f} held"
            for row in cell))


# ---------------------------------------------------------------------- #
# phase 21: the per-document fault domains and the causal gate on the card

#: (a) bench.py --faults's shape at its defaults (BENCH_ROUNDS, BENCH_OPS):
#: one actor's stream of 8 rounds x one 64-op change, every doc the same
FAULT_ROUNDS, FAULT_OPS = 8, 64
FAULT_PCTS = (0, 10, 25)
#: (a)'s docs: a thousand small documents per process (cut from 4,096 to
#: keep the script inside its time limit)
FAULT_DOCS = 1024
#: bench.py --faults's default (BENCH_FAULT_DOCS): (b) and (c) run at this
#: size, and (a)'s whole-doc ``get_patch`` check reads this many docs
FAULT_PATCH_DOCS = 512
#: (d) each replica's changes of phase 3's traffic arrive in swapped pairs,
#: so every other delivery defers in the causal gate
GATE_DOCS = 64
GATE_ORDER = (1, 0, 3, 2, 5, 4, 7, 6)
#: (e) the SyncFarm sweep's channels and the two that send a malformed
#: message (a peer that does is dropped, as a server closes its channel)
SYNC_CHANNELS, SYNC_BAD = 16, (5, 12)
QUARANTINE_COUNTERS = ("farm.quarantine.entered", "farm.quarantine.shed",
                       "farm.quarantine.released")
REJECTED = ("sync.messages.rejected",)


def fault_stream(rounds, ops, seed):
    """bench.py's ``_make_change_stream`` rebuilt with the port's
    columnar: one actor's `rounds` changes of `ops` sets on root keys in
    [0, 64) (a set names the actor's previous op on its key as pred), each
    change depending on the one before."""
    from automerge_tpu_torch.columnar import decode_change_columns, encode_change

    rng = random.Random(seed)
    actor = "aaaaaaaa"
    buffers, last, max_op, deps = [], {}, 0, []
    for r in range(rounds):
        start_op = max_op + 1
        body = []
        for ctr in range(start_op, start_op + ops):
            key = f"k{rng.randrange(64)}"
            body.append({"action": "set", "obj": "_root", "key": key,
                         "datatype": "uint", "value": rng.randrange(10**6),
                         "pred": [last[key]] if key in last else []})
            last[key] = f"{ctr}@{actor}"
        max_op = start_op + ops - 1
        buf = encode_change({"actor": actor, "seq": r + 1,
                             "startOp": start_op, "time": 0, "deps": deps,
                             "ops": body})
        deps = [decode_change_columns(buf)["hash"]]
        buffers.append(buf)
    return buffers


def fault_deliveries(docs, pct, stream):
    """bench.py --faults's deliveries: round r gives every doc stream[r],
    except that `pct` % of the docs, spread by stride, get it through a
    ``BYTE_CORPUS`` corrupter, each poisoned doc taking the corpus in turn
    (corrupter (d + r) mod 5). Returns (rounds, sorted poisoned docs)."""
    from automerge_tpu_torch.testing import faults

    n_poison = max(0, min(docs, round(docs * pct / 100)))
    stride = max(docs // n_poison, 1) if n_poison else 1
    poisoned = {i * stride for i in range(n_poison)}
    corrupters = [c for _, c, _ in faults.BYTE_CORPUS]
    rounds = []
    for r, buf in enumerate(stream):
        bad = [bytes(c(buf)) for c in corrupters]
        rounds.append([[bad[(d + r) % len(bad)]] if d in poisoned else [buf]
                       for d in range(docs)])
    return rounds, sorted(poisoned)


def record_result(rec, result):
    """A delivery's outcomes (status, error class, kind, offending hashes,
    fallback) and patches, for the card-vs-CPU and port-vs-JAX checks."""
    rec.append(repr([(o.status, type(o.error).__name__, o.error_kind,
                      tuple(o.offending_hashes), o.fallback)
                     for o in result.outcomes]))
    rec.extend(canon(p) for p in result)


def quarantine_causes():
    from automerge_tpu_torch.obs.metrics import get_metrics

    return {name.rsplit(".", 1)[-1]: entry["value"]
            for name, entry in get_metrics().as_dict().items()
            if name.startswith("farm.quarantine.causes.")}


def run_faults(device, docs, pct, seed, prof=None, record=None):
    """Phase 21 (a) at one poison share: a ``TorchDocFarm`` of `docs` docs
    (``quarantine_threshold=None``, ``isolation="doc"``) takes
    `fault_deliveries` round by round with the metrics on, as
    ``bench_faults`` does; the rounds are timed to a synchronize. Returns
    (farm, stats): healthy-doc ops/s, seconds, quarantined deliveries,
    the quarantine causes this run counted, the rounds and the poisoned
    docs."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.obs.metrics import enabled_metrics
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    prof = prof or PhaseProfile(enabled=False)
    stream = fault_stream(FAULT_ROUNDS, FAULT_OPS, seed)
    rounds, poisoned = fault_deliveries(docs, pct, stream)
    farm = TorchDocFarm(docs, capacity=FAULT_ROUNDS * FAULT_OPS,
                        quarantine_threshold=None, device=device)
    causes0 = quarantine_causes()
    quarantined = 0
    _sync(device)
    t0 = time.perf_counter()
    with counting_fallbacks(), enabled_metrics(), use_profile(prof):
        for delivery in rounds:
            result = farm.apply_changes(delivery)
            quarantined += len(result.quarantined)
            if record is not None:
                record_result(record, result)
    _sync(device)
    elapsed = time.perf_counter() - t0
    causes = {k: v - causes0.get(k, 0) for k, v in quarantine_causes().items()
              if v != causes0.get(k, 0)}
    healthy = docs - len(poisoned)
    return farm, {
        "pct": pct, "ops_per_s": healthy * FAULT_ROUNDS * FAULT_OPS / elapsed,
        "s": elapsed, "healthy": healthy, "poisoned": poisoned,
        "quarantined_deliveries": quarantined, "causes": causes,
        "rounds": rounds, "stream": stream,
    }


def check_pages(farm, clean, poisoned, what):
    """The allocator holds exactly the pages the page tables name (each
    once, never the PAD page: no delta page leaked), a healthy doc the
    clean farm's page count and rows, a poisoned doc none. Returns the
    allocated pages."""
    eng, ceng = farm.engine, clean.engine
    owned = [p for table in eng.page_table for p in table]
    if len(owned) != len(set(owned)) or 0 in owned or \
            len(owned) != eng.pages.allocated:
        raise RuntimeError(f"{what}: the allocator holds {eng.pages.allocated}"
                           f" pages, the page tables name {len(owned)}")
    bad = set(poisoned)
    for d in range(farm.num_docs):
        want = (0, 0) if d in bad else (len(ceng.page_table[d]),
                                        int(ceng.lengths[d]))
        if (len(eng.page_table[d]), int(eng.lengths[d])) != want:
            raise RuntimeError(f"{what}: doc {d} holds "
                               f"{len(eng.page_table[d])} pages and "
                               f"{int(eng.lengths[d])} rows, want {want}")
    return eng.pages.allocated


def check_faults(farm, clean, clean_patches, poisoned, device, what):
    """Every healthy doc reads as the clean farm's doc of the same index,
    every poisoned doc as a doc that received nothing: for every doc its
    heads, its committed log and its rows of the full-state readback
    (``_read_visibility``), for the first ``len(clean_patches)`` docs also
    the whole-doc ``get_patch``; and the pages match (`check_pages`)."""
    from automerge_tpu_torch import TorchDocFarm

    empty = canon(TorchDocFarm(1, capacity=8, device=device).get_patch(0))
    n = farm.num_docs
    bad = set(poisoned)
    healthy = np.array([d not in bad for d in range(n)])
    got, want = farm._read_visibility(), clean._read_visibility()
    for name, g, w in zip(("keys", "ops", "visible", "totals", "actions"),
                          got, want):
        if g.shape[1] != w.shape[1] or \
                not np.array_equal(g[healthy], w[:n][healthy]):
            raise RuntimeError(f"{what}: the healthy docs' readback "
                               f"({name}) differs from the clean run's")
    if not (got[0][~healthy] == np.iinfo(np.int32).max).all():
        raise RuntimeError(f"{what}: a poisoned doc holds rows")
    for d in range(n):
        patch = canon(farm.get_patch(d)) if d < len(clean_patches) else None
        if d in bad:
            if farm.get_heads(d) or farm.get_all_changes(d) or \
                    patch not in (None, empty):
                raise RuntimeError(f"{what}: poisoned doc {d} holds state")
        elif farm.get_heads(d) != clean.get_heads(d) or \
                len(farm.get_all_changes(d)) != \
                len(clean.get_all_changes(d)) or \
                (patch is not None and patch != clean_patches[d]):
            raise RuntimeError(f"{what}: healthy doc {d} differs from the "
                               "clean run's")
    return check_pages(farm, clean, poisoned, what)


def run_shedding(device, docs, seed, clean, clean_patches, record=None):
    """Phase 21 (b): (a)'s 10 % deliveries into a farm with the default
    quarantine threshold (3): each poisoned doc is quarantined after its
    third failed delivery and its later deliveries are shed; then
    ``release_quarantine()`` and one clean delivery (the whole stream to
    each released doc, nothing to the others) must bring every doc to the
    clean farm's state. Returns stats."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.errors import QuarantinedError
    from automerge_tpu_torch.obs.metrics import enabled_metrics

    stream = fault_stream(FAULT_ROUNDS, FAULT_OPS, seed)
    rounds, poisoned = fault_deliveries(docs, 10, stream)
    farm = TorchDocFarm(docs, capacity=FAULT_ROUNDS * FAULT_OPS,
                        device=device)
    threshold = farm.quarantine_threshold
    c0 = counts(QUARANTINE_COUNTERS)
    t0 = time.perf_counter()
    with counting_fallbacks(), enabled_metrics():
        for r, delivery in enumerate(rounds):
            result = farm.apply_changes(delivery)
            if record is not None:
                record_result(record, result)
            if sorted(result.quarantined) != poisoned:
                raise RuntimeError(f"(b) round {r}: quarantined "
                                   f"{sorted(result.quarantined)}")
            shed = [d for d in poisoned if isinstance(
                result.outcomes[d].error, QuarantinedError)]
            if shed != (poisoned if r >= threshold else []):
                raise RuntimeError(f"(b) round {r}: shed {len(shed)} docs")
        if sorted(farm.quarantine) != poisoned:
            raise RuntimeError("(b) the poisoned docs were not quarantined")
        released = sorted(farm.release_quarantine())
        catch_up = [list(stream) if d in set(poisoned) else []
                    for d in range(docs)]
        result = farm.apply_changes(catch_up)
        if record is not None:
            record_result(record, result)
    _sync(device)
    elapsed = time.perf_counter() - t0
    moved = {k: v - c0[k] for k, v in counts(QUARANTINE_COUNTERS).items()}
    n = len(poisoned)
    want = {"farm.quarantine.entered": n,
            "farm.quarantine.shed": n * (FAULT_ROUNDS - threshold),
            "farm.quarantine.released": n}
    if released != poisoned or moved != want or result.quarantined:
        raise RuntimeError(f"(b) released {len(released)} docs, counters "
                           f"{moved}, want {want}")
    check_faults(farm, clean, clean_patches, [], device, "(b)")
    return {"s": elapsed, "threshold": threshold, "counters": moved,
            "rounds": rounds, "catch_up": catch_up, "farm": farm}


def batch_delivery(docs, stream, seed):
    """Phase 21 (c)'s delivery: the stream's next change for every doc,
    except one doc (drawn from `seed`) whose change overflows the
    merge-key packing range. Returns (delivery, that doc)."""
    from automerge_tpu_torch.columnar import decode_change_columns
    from automerge_tpu_torch.testing import faults
    from automerge_tpu_torch.tpu.rga import MAX_COUNTER

    deps = [decode_change_columns(stream[-1])["hash"]]
    nxt = faults.make_change("aaaaaaaa", len(stream) + 1,
                             len(stream) * FAULT_OPS + 1, deps,
                             [faults.set_op("k0", 1)])
    k = int(np.random.default_rng(seed).integers(docs))
    over = faults.counter_overflow("aaaaaaaa", len(stream) + 1, MAX_COUNTER,
                                   deps)
    return [[over] if d == k else [nxt] for d in range(docs)], k


def run_batch_isolation(farm, stream, seed):
    """Phase 21 (c): under ``isolation="batch"`` one doc over the packing
    limit rejects the whole call before anything commits: the call raises
    ``PackingLimitError``, and the full-readback oracle
    (``_read_visibility``), every doc's heads and committed log read the
    same before and after. Returns (that doc, the error)."""
    from automerge_tpu_torch.errors import PackingLimitError

    delivery, k = batch_delivery(farm.num_docs, stream, seed)
    before = farm._read_visibility()
    heads = [farm.get_heads(d) for d in range(farm.num_docs)]
    logs = [len(farm.get_all_changes(d)) for d in range(farm.num_docs)]
    try:
        farm.apply_changes(delivery, isolation="batch")
    except PackingLimitError as exc:
        err = exc
    else:
        raise RuntimeError("(c) the batch-isolated call committed")
    after = farm._read_visibility()
    if any(not np.array_equal(a, b) for a, b in zip(before, after)):
        raise RuntimeError("(c) the readback moved under a rejected call")
    if [farm.get_heads(d) for d in range(farm.num_docs)] != heads or \
            [len(farm.get_all_changes(d))
             for d in range(farm.num_docs)] != logs:
        raise RuntimeError("(c) a doc committed under a rejected call")
    return k, err


@functools.lru_cache(maxsize=2)
def gate_deliveries(docs, seed):
    """Phase 21 (d)'s deliveries: phase 3's traffic (8 replicas x 8
    changes x 16 ops per doc), one change per replica per delivery in the
    order `GATE_ORDER`: change 1 arrives before the change 0 it depends
    on, and so on in pairs. Built once for the phase's runs, so no caller
    changes them."""
    edits = make_edits(docs, MAP_REPLICAS, MAP_CHANGES, MAP_OPS, seed)
    return [[[edits[r][c][d] for r in range(MAP_REPLICAS)]
             for d in range(docs)] for c in GATE_ORDER]


def run_gate(device, docs, seed, mode, record):
    """Phase 21 (d): `gate_deliveries` into a farm of the given
    ``gate_mode``; every patch goes to `record`. Each first delivery of a
    pair must defer every change (one pending per replica), each second
    must commit both. Returns (farm, seconds)."""
    from automerge_tpu_torch import TorchDocFarm

    farm = TorchDocFarm(docs, capacity=MAP_REPLICAS * MAP_CHANGES * MAP_OPS,
                        gate_mode=mode, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for t, delivery in enumerate(gate_deliveries(docs, seed)):
        result = farm.apply_changes(delivery)
        record_result(record, result)
        pending = {p["pendingChanges"] for p in result}
        want = MAP_REPLICAS if t % 2 == 0 else 0
        if pending != {want} or result.quarantined:
            raise RuntimeError(f"(d) {mode} delivery {t}: pending {pending}, "
                               f"want {want}")
    _sync(device)
    elapsed = time.perf_counter() - t0
    for d in range(docs):
        record.append(canon(farm.get_patch(d)))
        if len(farm.get_all_changes(d)) != MAP_REPLICAS * MAP_CHANGES:
            raise RuntimeError(f"(d) {mode}: doc {d} lacks changes")
    return farm, elapsed


def run_have_filters(device, docs, seed, record):
    """Phase 21 (e), first half: ``batched_have_filters`` over `docs`
    single-document backends, each holding replica 1's changes of phase
    3's traffic for its doc (every odd backend's last sync at its change
    3, every eighth's at its own heads: an empty filter). Every filter
    must equal the sequential ``BloomFilter``'s bytes; the filters go to
    `record`. Returns the seconds of the call."""
    from automerge_tpu_torch import backend as Backend
    from automerge_tpu_torch import sync as Sync
    from automerge_tpu_torch.columnar import decode_change_meta_cached
    from automerge_tpu_torch.tpu.sync_batch import batched_have_filters

    edits = make_edits(docs, 2, MAP_CHANGES, MAP_OPS, seed + 21)[1]
    backends = [Backend.apply_changes(
        Backend.init(), [edits[c][d] for c in range(MAP_CHANGES)])[0]
        for d in range(docs)]
    last_syncs = [Backend.get_heads(backends[d]) if d % 8 == 7 else
                  [decode_change_meta_cached(edits[3][d])["hash"]]
                  if d % 2 else [] for d in range(docs)]
    _sync(device)
    t0 = time.perf_counter()
    haves = batched_have_filters(backends, last_syncs, device=device)
    elapsed = time.perf_counter() - t0
    for d, have in enumerate(haves):
        hashes = [decode_change_meta_cached(c)["hash"]
                  for c in Backend.get_changes(backends[d], last_syncs[d])]
        if have != {"lastSync": last_syncs[d],
                    "bloom": Sync.BloomFilter(hashes).bytes}:
            raise RuntimeError(f"(e) backend {d}'s have filter differs from "
                               "the sequential BloomFilter")
        record.append(have["bloom"])
    if docs >= 8 and not any(h["bloom"] == b"" for h in haves):
        raise RuntimeError("(e) no empty have filter")
    return elapsed


def run_bad_peers(device, channels, seed, record):
    """Phase 21 (e), second half: `channels` single-document backends
    holding replica 1's changes of phase 3's traffic sync with a server
    farm holding replica 0's, through a ``SyncFarm``, until no message
    moves. The channels in `SYNC_BAD` send a truncated first message and
    are dropped. Every other channel must converge (equal heads and
    whole-doc patches); the server must count one ``sync.messages.rejected``
    per bad channel, keep those channels' states and hold none of their
    changes. Every message and patch goes to `record`. Returns stats."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm
    from automerge_tpu_torch import backend as Backend
    from automerge_tpu_torch import sync as Sync
    from automerge_tpu_torch.obs.metrics import enabled_metrics
    from automerge_tpu_torch.testing import faults

    edits = make_edits(channels, 2, MAP_CHANGES, MAP_OPS, seed + 21)
    server = TorchDocFarm(channels, capacity=2 * MAP_CHANGES * MAP_OPS,
                          device=device)
    server.apply_changes([[edits[0][c][d] for c in range(MAP_CHANGES)]
                          for d in range(channels)])
    clients = [Backend.apply_changes(
        Backend.init(), [edits[1][c][d] for c in range(MAP_CHANGES)])[0]
        for d in range(channels)]
    sf = SyncFarm(server)
    s_states = [SyncFarm.init_state() for _ in range(channels)]
    c_states = [Sync.init_sync_state() for _ in range(channels)]
    bad = {c for c in SYNC_BAD if c < channels}
    live = list(range(channels))
    rejected0 = counts(REJECTED)[REJECTED[0]]
    sweeps = []
    t0 = time.perf_counter()
    with counting_fallbacks(), enabled_metrics():
        for _ in range(64):
            batch = []
            for d in live:
                c_states[d], msg = Sync.generate_sync_message(clients[d],
                                                              c_states[d])
                if msg is not None:
                    batch.append((d, faults.truncated(msg, keep=3)
                                  if d in bad else msg))
            got = sf.receive_messages(
                [(d, s_states[d], msg) for d, msg in batch]) if batch else []
            for (d, msg), (state, patch) in zip(batch, got):
                if d in bad and (state != s_states[d] or patch is not None):
                    raise RuntimeError(f"(e) bad channel {d} moved state")
                s_states[d] = state
                record.append(msg)
                record.append(canon(patch))
            live = [d for d in live if d not in bad]
            out = sf.generate_messages([(d, s_states[d]) for d in live])
            moved = len(batch)
            for d, (state, msg) in zip(live, out):
                s_states[d] = state
                record.append(msg)
                if msg is None:
                    continue
                moved += 1
                clients[d], c_states[d], patch = Sync.receive_sync_message(
                    clients[d], c_states[d], msg)
                record.append(canon(patch))
            sweeps.append(moved)
            if moved == 0:
                break
        else:
            raise RuntimeError("(e) the sync did not quiesce in 64 sweeps")
    _sync(device)
    elapsed = time.perf_counter() - t0
    rejected = counts(REJECTED)[REJECTED[0]] - rejected0
    if rejected != len(bad):
        raise RuntimeError(f"(e) {rejected} messages rejected, want "
                           f"{len(bad)}")
    for d in range(channels):
        if d in bad:
            if len(server.get_all_changes(d)) != MAP_CHANGES:
                raise RuntimeError(f"(e) bad channel {d}'s changes landed")
            continue
        patch = canon(server.get_patch(d))
        if sorted(Backend.get_heads(clients[d])) != sorted(
                server.get_heads(d)) or canon(
                    Backend.get_patch(clients[d])) != patch:
            raise RuntimeError(f"(e) channel {d} did not converge")
        record.append(patch)
    return {"s": elapsed, "sweeps": sweeps, "rejected": rejected,
            "converged": channels - len(bad), "server": server}


def run_faults_phase(args, table, card, device, docs=FAULT_DOCS):
    """Phase 21 (see the module docstring) with (a) at `docs` docs. The
    objects earlier phases left alive are moved out of the cyclic
    collector's reach for the phase (``gc.freeze``): its passes over them
    would otherwise land in whichever host phase allocates when they fall
    due, as bench.py's own process does not carry them."""
    t0 = time.perf_counter()
    gc.collect()
    gc.freeze()
    try:
        parts = faults_phase(args, table, card, device, docs)
    finally:
        gc.unfreeze()
    log(f"  whole phase {time.perf_counter() - t0:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))


def faults_phase(args, table, card, device, docs):
    """Runs phase 21; returns the seconds of its parts."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.columnar import decode_change_cached
    from automerge_tpu_torch.profiling import PhaseProfile
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    small = min(docs, FAULT_PATCH_DOCS)
    bk.reset_launch_counts()
    fallbacks = fallback_counts()
    # the whole stream into a small farm first warms the farm path and the
    # decode LRU for the three runs alike (bench.py warms with the first
    # change, so its clean run meets the others' changes cold)
    warm = TorchDocFarm(16, capacity=FAULT_ROUNDS * FAULT_OPS, device=device)
    for buf in fault_stream(FAULT_ROUNDS, FAULT_OPS, args.seed):
        warm.apply_changes([[buf]] * 16)
    del warm
    lap("warm")
    # (a) the degradation curve
    runs = {}
    for pct in FAULT_PCTS:
        prof = PhaseProfile()
        farm, stats = run_faults(device, docs, pct, args.seed, prof=prof)
        stats["prof"] = prof
        if not runs:
            clean = farm
            clean_patches = [canon(clean.get_patch(d)) for d in range(small)]
        t_check = time.perf_counter()
        stats["pages"] = check_faults(farm, clean, clean_patches,
                                      stats["poisoned"], device,
                                      f"(a) {pct} %")
        stats["check_s"] = time.perf_counter() - t_check
        check_no_fallback(fallbacks, [farm], f"phase 21 (a) {pct} %")
        runs[pct] = stats
    del farm
    lap("(a)")
    log(f"phase 21 fault domains: (a) bench.py --faults's shape, {docs} docs "
        f"x {FAULT_ROUNDS} rounds x one {FAULT_OPS}-op change, "
        f"isolation=\"doc\", no shedding, card {card}")
    for pct, st in runs.items():
        totals = st["prof"].totals_by_path()
        farm_s = sum(t for path, (t, _) in totals.items() if "/" not in path)
        log(f"  {pct} % poisoned: {st['healthy']} healthy docs at "
            f"{st['ops_per_s']:.1f} ops/s (vs_clean "
            f"{st['ops_per_s'] / runs[0]['ops_per_s']:.4f}), "
            f"{st['s']:.3f} s; {st['quarantined_deliveries']} quarantined "
            f"deliveries, causes {st['causes']}; {st['pages']} pages held "
            f"(no leak); every healthy doc equals the clean run and every "
            f"poisoned doc is empty in heads, log and readback, the first "
            f"{small} in get_patch too ({st['check_s']:.2f} s)")
        log("    shares " + json.dumps(
            {k: round(totals.get(k, (0.0, 0))[0] / farm_s, 4)
             for k in ("decode", "gate_verdicts", "patch_assembly")}))
    log("  phase table (the 10 % run, host clock):")
    for line in runs[10]["prof"].table().splitlines():
        log("    " + line)
    # (b) shedding and release, at bench.py's default size
    shed = run_shedding(device, small, args.seed, clean, clean_patches)
    log(f"  (b) {small} docs, threshold {shed['threshold']}: the 10 % "
        f"deliveries' poisoned docs shed from delivery "
        f"{shed['threshold'] + 1}, released, then one clean delivery: every "
        f"doc equals the clean run; counters {shed['counters']}; "
        f"{shed['s']:.3f} s")
    del clean
    lap("(b)")
    # (c) isolation="batch", on (b)'s farm, whose docs all hold the stream
    k, err = run_batch_isolation(shed["farm"], runs[0]["stream"], args.seed)
    log(f"  (c) isolation=\"batch\" at {small} docs: doc {k} over the "
        f"packing range rejects the call ({type(err).__name__}: {err}); "
        f"_read_visibility, heads and logs unchanged")
    del shed
    lap("(c)")
    # (d) the gate, columnar and oracle on the card, columnar on the CPU;
    # the deliveries' decodes are cached first, for every run alike
    for delivery in gate_deliveries(GATE_DOCS, args.seed):
        for bufs in delivery:
            for buf in bufs:
                decode_change_cached(buf)
    records, times = {}, {}
    for dev, mode in ((device, "columnar"), (device, "oracle"),
                      ("cpu", "columnar")):
        records[dev, mode] = []
        _, times[dev, mode] = run_gate(dev, GATE_DOCS, args.seed, mode,
                                       records[dev, mode])
    first = records[device, "columnar"]
    if any(r != first for r in records.values()):
        raise RuntimeError("(d) the gate's patches differ across modes or "
                           "devices")
    log(f"  (d) phase 3's traffic at {GATE_DOCS} docs in swapped pairs "
        f"(every other delivery defers all 8 replicas' changes): columnar "
        f"{times[device, 'columnar']:.3f} s, oracle "
        f"{times[device, 'oracle']:.3f} s on the card, columnar "
        f"{times['cpu', 'columnar']:.3f} s on the CPU; {len(first)} "
        f"outcome lists and patches identical")
    lap("(d)")
    # (e) the batched have filters (card vs CPU) and a SyncFarm sweep with
    # malformed peers
    with recorded_bloom_launches() as (rec_build, rec_query):
        on_card, on_cpu = [], []
        have_s = run_have_filters(device, GATE_DOCS, args.seed, on_card)
        peers = run_bad_peers(device, SYNC_CHANNELS, args.seed, [])
    launches = dict(bk.LAUNCHES)
    run_have_filters("cpu", GATE_DOCS, args.seed, on_cpu)
    if on_card != on_cpu:
        raise RuntimeError("(e) the card's have filters differ from the CPU's")
    check_no_fallback(fallbacks, [peers["server"]], "phase 21")
    log(f"  (e) batched_have_filters over {GATE_DOCS} backends: "
        f"{have_s * 1e3:.2f} ms, every filter equal to the sequential "
        f"BloomFilter's and to the CPU's; a {SYNC_CHANNELS}-channel SyncFarm "
        f"sweep with channels {list(SYNC_BAD)} malformed: "
        f"{peers['converged']} converged, {peers['rejected']} rejected, "
        f"messages per sweep {peers['sweeps']} ({peers['s']:.3f} s); kernel "
        f"launches {launches}")
    check_launched(table, launches, rec_build, rec_query, "faults",
                   "phase 21")
    lap("(e)")
    return parts


# ---------------------------------------------------------------------- #
# phase 22: the farm held to OpSet on the JAX suite's own traffic, the
# counter configuration of BASELINE.json, sync v2 and the instruments

# (b) tests/test_farm.py's differential traffic: docs, rounds, drain
# rounds, seed (test_heavy_concurrency_and_delay's) and the farm capacity
DIFF_DOCS, DIFF_ROUNDS, DIFF_DRAIN, DIFF_SEED = 512, 12, 3, 4
DIFF_DELAY, DIFF_CAPACITY = 0.5, 256
# the (round, doc) pairs of that traffic at which the farm's incremental
# patch differs from OpSet's in both packages alike: edits inside an
# object that holds a root key in conflict with plain values, where OpSet
# lists the plain values without the object and the farm lists nothing at
# that key (ROADMAP queue C). The whole-doc patches agree at the end
DIFF_KNOWN = frozenset(
    [(r, 366) for r in (3, 4, 6, 7, 8, 9, 10, 11, 12)]
    + [(r, 449) for r in (4, 5, 6, 10, 11)])
# (c) BASELINE.json configs[2] per doc: actors, changes per actor, inc ops
# per change; the docs on the card; the OpSet cut (inc ops per change,
# docs) and the docs held to a CPU farm
COUNTER_ACTORS, COUNTER_CHANGES, COUNTER_INCS = 64, 25, 64
COUNTER_DOCS = 16
COUNTER_CUT_INCS, COUNTER_CUT_DOCS, COUNTER_CPU_DOCS = 1, 2, 2
COUNTER_ROW_BYTES = 33  # key i32, op i64, action i32, value i64, pred i64, bool
# (d) test_sync_v2.py's TestFarmBatchedFingerprints
V2_FARM_DOCS, V2_FARM_SWEEPS = 4, 12


def port_pkg(device):
    """The port's farm, ``OpSet`` and columnar under the names the phase's
    scenarios use (``tests/test_torch_farm_smoke.py`` runs them over the
    JAX package too)."""
    from automerge_tpu_torch import TorchDocFarm, columnar
    from automerge_tpu_torch.opset import OpSet

    return argparse.Namespace(
        farm=functools.partial(TorchDocFarm, device=device), OpSet=OpSet,
        columnar=columnar)


def farm_change(P, actor, seq, start_op, deps, ops):
    """tests/test_farm.py's ``make_change``: (buffer, hash)."""
    buf = P.columnar.encode_change(
        {"actor": actor, "seq": seq, "startOp": start_op, "time": 0,
         "deps": sorted(deps), "ops": ops})
    return buf, P.columnar.decode_change_columns(buf)["hash"]


def uint_set(key, value, pred=(), obj="_root"):
    return {"action": "set", "obj": obj, "key": key, "datatype": "uint",
            "value": value, "pred": list(pred)}


def counter_set(key, value):
    return {"action": "set", "obj": "_root", "key": key,
            "datatype": "counter", "value": value, "pred": []}


def held(rec, got, want, what):
    """The farm's patch equals OpSet's; appends it to `rec`."""
    if got != want:
        raise RuntimeError(f"{what}: the farm's patch {got} differs from "
                           f"OpSet's {want}")
    rec.append(canon(got))


def expect(ok, what):
    if not ok:
        raise RuntimeError(what)


# (a) the nine cases of tests/test_farm.py's TestFarmBasics, each farm
# call held to the same call on OpSet


def basics_single_set_patch(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf, _ = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("x", 7)])
    held(rec, farm.apply_changes([[buf]])[0], opset.apply_changes([buf]),
         "single set")


def basics_queued_change_waits_for_deps(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf1, h1 = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("x", 1)])
    buf2, _ = farm_change(P, "aaaaaaaa", 2, 2, [h1],
                          [uint_set("x", 2, ["1@aaaaaaaa"])])
    got2 = farm.apply_changes([[buf2]])[0]
    held(rec, got2, opset.apply_changes([buf2]), "queued change")
    expect(got2["pendingChanges"] == 1 and farm.get_missing_deps(0) == [h1],
           "queued change: not pending on its dependency")
    got1 = farm.apply_changes([[buf1]])[0]
    held(rec, got1, opset.apply_changes([buf1]), "dependency arrives")
    expect(got1["pendingChanges"] == 0, "dependency arrives: still pending")


def basics_duplicate_change_is_idempotent(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf, _ = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("x", 1)])
    farm.apply_changes([[buf]])
    opset.apply_changes([buf])
    held(rec, farm.apply_changes([[buf]])[0], opset.apply_changes([buf]),
         "duplicate change")


def basics_concurrent_conflict_map(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf_a, _ = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("k", 1)])
    buf_b, _ = farm_change(P, "bbbbbbbb", 1, 1, [], [uint_set("k", 2)])
    got = farm.apply_changes([[buf_a, buf_b]])[0]
    held(rec, got, opset.apply_changes([buf_a, buf_b]), "map conflict")
    expect(set(got["diffs"]["props"]["k"]) == {"1@aaaaaaaa", "1@bbbbbbbb"},
           "map conflict: both values not visible")


def basics_multi_pred_conflict_resolution(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf_a, ha = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("k", 1)])
    buf_b, hb = farm_change(P, "bbbbbbbb", 1, 1, [], [uint_set("k", 2)])
    buf_c, _ = farm_change(P, "aaaaaaaa", 2, 2, [ha, hb], [
        uint_set("k", 3, ["1@aaaaaaaa", "1@bbbbbbbb"])])
    held(rec, farm.apply_changes([[buf_a, buf_b]])[0],
         opset.apply_changes([buf_a, buf_b]), "multi-pred: the conflict")
    got = farm.apply_changes([[buf_c]])[0]
    held(rec, got, opset.apply_changes([buf_c]), "multi-pred: resolution")
    expect(list(got["diffs"]["props"]["k"]) == ["2@aaaaaaaa"],
           "multi-pred: the conflict survived its resolution")


def basics_nested_make_map_patch(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf, _ = farm_change(P, "aaaaaaaa", 1, 1, [], [
        {"action": "makeMap", "obj": "_root", "key": "cfg", "pred": []},
        uint_set("x", 5, obj="1@aaaaaaaa")])
    held(rec, farm.apply_changes([[buf]])[0], opset.apply_changes([buf]),
         "nested makeMap")


def basics_counter_accumulation_patch(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf1, h1 = farm_change(P, "aaaaaaaa", 1, 1, [], [counter_set("c", 10)])
    buf2, _ = farm_change(P, "aaaaaaaa", 2, 2, [h1], [
        {"action": "inc", "obj": "_root", "key": "c", "value": 3,
         "pred": ["1@aaaaaaaa"]}])
    held(rec, farm.apply_changes([[buf1]])[0], opset.apply_changes([buf1]),
         "counter: set")
    got = farm.apply_changes([[buf2]])[0]
    held(rec, got, opset.apply_changes([buf2]), "counter: inc")
    expect(got["diffs"]["props"]["c"]["1@aaaaaaaa"]["value"] == 13,
           "counter: 10 + 3 is not 13")


def basics_multi_pred_inc_on_conflicting_counters(P, rec):
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    buf_a, ha = farm_change(P, "aaaaaaaa", 1, 1, [], [counter_set("c", 10)])
    buf_b, hb = farm_change(P, "bbbbbbbb", 1, 1, [], [counter_set("c", 100)])
    buf_c, _ = farm_change(P, "cccccccc", 1, 2, [ha, hb], [
        {"action": "inc", "obj": "_root", "key": "c", "value": 7,
         "pred": ["1@aaaaaaaa", "1@bbbbbbbb"]}])
    held(rec, farm.apply_changes([[buf_a, buf_b]])[0],
         opset.apply_changes([buf_a, buf_b]), "conflicting counters")
    held(rec, farm.apply_changes([[buf_c]])[0], opset.apply_changes([buf_c]),
         "inc on conflicting counters")
    held(rec, farm.get_patch(0), opset.get_patch(),
         "conflicting counters: whole doc")


def basics_seq_reuse_raises(P, rec):
    farm = P.farm(1, capacity=16)
    buf1, _ = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("x", 1)])
    buf1b, _ = farm_change(P, "aaaaaaaa", 1, 1, [], [uint_set("y", 2)])
    farm.apply_changes([[buf1]])
    try:
        farm.apply_changes([[buf1b]], isolation="batch")
    except ValueError as exc:
        raised = str(exc)
    else:
        raised = ""
    expect("sequence number" in raised,
           f"seq reuse under isolation='batch' raised {raised!r}")
    outcome = farm.apply_changes([[buf1b]]).outcomes[0]
    expect(outcome.status == "quarantined"
           and isinstance(outcome.error, ValueError)
           and "sequence number" in str(outcome.error)
           and len(farm.get_all_changes(0)) == 1,
           f"seq reuse under isolation='doc': {outcome}")
    rec.append(repr((raised, outcome.status, str(outcome.error))))


FARM_BASICS = (
    basics_single_set_patch, basics_queued_change_waits_for_deps,
    basics_duplicate_change_is_idempotent, basics_concurrent_conflict_map,
    basics_multi_pred_conflict_resolution, basics_nested_make_map_patch,
    basics_counter_accumulation_patch,
    basics_multi_pred_inc_on_conflicting_counters, basics_seq_reuse_raises,
)


def run_farm_basics(P):
    """The nine cases over package namespace `P`; returns the record."""
    rec = []
    for case in FARM_BASICS:
        case(P, rec)
    return rec


# (b) tests/test_farm.py's Workload and run_farm_differential's loop


def _lamport(op_id):
    ctr, actor = op_id.split("@")
    return (int(ctr), actor)


def visible_index(diffs, obj="_root", out=None, objects=None):
    """tests/test_farm.py's ``visible_index``: a whole-doc patch diff as
    {(obj, key): [(opId, diff)]} and the live object ids."""
    if out is None:
        out, objects = {}, {"_root": "map"}
    for key, values in diffs.get("props", {}).items():
        entries = sorted(values.items(), key=lambda kv: _lamport(kv[0]))
        if entries:
            out[(obj, key)] = entries
        for _op_id, diff in entries:
            if isinstance(diff, dict) and "objectId" in diff:
                objects[diff["objectId"]] = diff["type"]
                visible_index(diff, diff["objectId"], out, objects)
    return out, objects


class FarmWorkload:
    """tests/test_farm.py's ``Workload`` over the port's columnar (the
    same draws in the same order, so the same buffers for a seed: the
    differential's concurrent rounds from 1-2 of 3 actors against one
    snapshot, counters, nested maps and tables, deletes, and deliveries
    delayed by 1-2 rounds with `delay_prob` and shuffled)."""

    def __init__(self, seed, actors=("aaaaaaaa", "bbbbbbbb", "cccccccc"),
                 with_counters=True, with_nesting=True, delay_prob=0.25):
        self.P = port_pkg("cpu")
        self.rng = random.Random(seed)
        self.actors = actors
        self.with_counters = with_counters
        self.with_nesting = with_nesting
        self.delay_prob = delay_prob
        self.seqs = dict.fromkeys(actors, 0)
        self.last_hash = dict.fromkeys(actors, None)
        self.max_op = 0
        self.in_flight = []
        self.round = 0

    def _ops_against(self, index, objects, n_ops):
        rng, ops = self.rng, []
        for _ in range(n_ops):
            obj = rng.choice(sorted(objects))
            key = f"k{rng.randrange(5)}"
            entries = index.get((obj, key), [])
            preds = [op_id for op_id, _ in entries]
            counter_ids = [op_id for op_id, d in entries
                           if isinstance(d, dict)
                           and d.get("datatype") == "counter"]
            roll = rng.random()
            if counter_ids:
                ops.append({"action": "inc", "obj": obj, "key": key,
                            "value": rng.randrange(1, 10),
                            "pred": [counter_ids[-1]]})
            elif self.with_nesting and roll < 0.18:
                action = "makeMap" if rng.random() < 0.7 else "makeTable"
                ops.append({"action": action, "obj": obj, "key": key,
                            "pred": preds})
            elif roll < 0.3 and preds:
                ops.append({"action": "del", "obj": obj, "key": key,
                            "pred": preds})
            elif self.with_counters and roll < 0.42 and not preds:
                ops.append({"action": "set", "obj": obj, "key": key,
                            "datatype": "counter",
                            "value": rng.randrange(50), "pred": []})
            else:
                ops.append({"action": "set", "obj": obj, "key": key,
                            "datatype": "uint",
                            "value": rng.randrange(1000), "pred": preds})
        return ops

    def next_round(self, oracle):
        """This round's changes against the oracle's current state; returns
        the buffers due for delivery this round."""
        self.round += 1
        index, objects = visible_index(oracle.get_patch()["diffs"])
        heads = list(oracle.heads)
        for actor in self.rng.sample(self.actors, self.rng.randrange(1, 3)):
            self.seqs[actor] += 1
            start_op = self.max_op + 1
            ops = self._ops_against(index, objects, self.rng.randrange(1, 4))
            deps = set(heads)
            if self.last_hash[actor]:
                deps.add(self.last_hash[actor])
            buf, hash_ = farm_change(self.P, actor, self.seqs[actor],
                                     start_op, deps, ops)
            self.last_hash[actor] = hash_
            self.max_op = start_op + len(ops) - 1
            due = self.round + (self.rng.randrange(1, 3)
                                if self.rng.random() < self.delay_prob else 0)
            self.in_flight.append((due, buf))
        due_now = [buf for r, buf in self.in_flight if r <= self.round]
        self.in_flight = [(r, buf) for r, buf in self.in_flight
                          if r > self.round]
        self.rng.shuffle(due_now)
        return due_now

    def drain(self):
        out = [buf for _, buf in self.in_flight]
        self.in_flight = []
        self.rng.shuffle(out)
        return out


def diff_traffic(doc_ids, rounds, seed, **workload_kw):
    """run_farm_differential's deliveries (`rounds` rounds, then
    ``DIFF_DRAIN`` drain rounds) to the docs `doc_ids` (doc d's workload
    seeded ``seed + 17 d``, as there) with each round's OpSet patches, the
    oracle's state driving the generation as there. Returns (deliveries
    [round][doc], patches [round][doc], the OpSets)."""
    from automerge_tpu_torch.opset import OpSet

    opsets = [OpSet() for _ in doc_ids]
    loads = [FarmWorkload(seed + 17 * d, **workload_kw) for d in doc_ids]
    deliveries, want = [], []
    for rnd in range(rounds + DIFF_DRAIN):
        per_doc = [load.next_round(opset) if rnd < rounds else load.drain()
                   for load, opset in zip(loads, opsets)]
        want.append([opset.apply_changes(bufs)
                     for opset, bufs in zip(opsets, per_doc)])
        deliveries.append(per_doc)
    return deliveries, want, opsets


def known_divergences(doc_ids):
    """``DIFF_KNOWN`` as (round, index into `doc_ids`) pairs."""
    at = {d: i for i, d in enumerate(doc_ids)}
    return {(rnd, at[d]) for rnd, d in DIFF_KNOWN if d in at}


def run_farm_diff(device, deliveries, want, opsets, known=frozenset(),
                  prof=None, record=None):
    """The deliveries through one farm, every round's patch of every doc
    held to OpSet's, except that the patches at the (round, doc) pairs
    `known` must differ from it (the divergence both packages' farms
    share, ``DIFF_KNOWN``); then every doc's whole patch, heads and missing
    deps. `record` (a list) collects every patch. Returns (farm, the
    seconds of the apply_changes calls)."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    prof = prof or PhaseProfile(enabled=False)
    docs = len(opsets)
    farm = TorchDocFarm(docs, capacity=DIFF_CAPACITY, device=device)
    seconds = 0.0
    for rnd, per_doc in enumerate(deliveries):
        t0 = time.perf_counter()
        with use_profile(prof):
            got = farm.apply_changes(per_doc)
        seconds += time.perf_counter() - t0
        for d in range(docs):
            if (got[d] != want[rnd][d]) != ((rnd, d) in known):
                raise RuntimeError(
                    f"farm-diff round {rnd} doc {d}: the farm's patch "
                    f"{got[d]} {'equals' if (rnd, d) in known else 'differs from'}"
                    f" OpSet's {want[rnd][d]}")
        if record is not None:
            record.extend(canon(p) for p in got)
    for d, opset in enumerate(opsets):
        if farm.get_patch(d) != opset.get_patch() or \
                farm.get_heads(d) != opset.heads or \
                farm.get_missing_deps(d) != opset.get_missing_deps():
            raise RuntimeError(f"farm-diff doc {d}: the whole-doc patch, "
                               "heads or missing deps differ from OpSet's")
    return farm, seconds


# (c) BASELINE.json configs[2]: "Counter CRDT: 64 actors, 100k concurrent
# increments"


def counter_actor(a):
    return f"{a + 16:02x}" * 8


def counter_stream(actors, changes, incs, seed):
    """One change by actor 0 makes the root counter ``c``; then each actor
    makes `changes` changes of `incs` ``inc`` ops of 1 on it (pred: the
    counter's op id), each change on the actor's previous one. Returns the
    rounds: round 0 the counter's change, round r every actor's r-th
    change in a seeded shuffle."""
    P = port_pkg("cpu")
    rng = random.Random(seed)
    creator = counter_actor(0)
    create, first = farm_change(P, creator, 1, 1, [], [counter_set("c", 0)])
    target = f"1@{creator}"
    inc = [{"action": "inc", "obj": "_root", "key": "c", "value": 1,
            "pred": [target]}] * incs
    last = [first] * actors
    rounds = [[create]]
    for r in range(changes):
        bufs = []
        for a in range(actors):
            buf, last[a] = farm_change(P, counter_actor(a),
                                       r + 1 + (a == 0), 2 + r * incs,
                                       [last[a]], inc)
            bufs.append(buf)
        rng.shuffle(bufs)
        rounds.append(bufs)
    return rounds


def counter_value(patch, what):
    """The counter's value in a patch that shows it."""
    entry = patch["diffs"]["props"]["c"][f"1@{counter_actor(0)}"]
    if entry.get("datatype") != "counter":
        raise RuntimeError(f"{what}: c is no counter: {entry}")
    return entry["value"]


def run_counters(device, docs, rounds, per_round, prof=None, record=None,
                 opset=None):
    """Every round to every doc of one farm: after round r every doc's
    patch reads the counter at r x `per_round`. `record` (a list) keeps
    docs 0-1's patches; `opset`, when given, takes the same rounds and
    every doc's patch must equal its. Returns (farm, the seconds of the
    apply_changes calls)."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    prof = prof or PhaseProfile(enabled=False)
    farm = TorchDocFarm(docs, capacity=1 + (len(rounds) - 1) * per_round,
                        device=device)
    seconds = 0.0
    for r, bufs in enumerate(rounds):
        t0 = time.perf_counter()
        with use_profile(prof):
            result = farm.apply_changes([bufs] * docs)
        seconds += time.perf_counter() - t0
        want = opset.apply_changes(bufs) if opset is not None else None
        for d, patch in enumerate(result):
            value = counter_value(patch, f"counters round {r} doc {d}")
            if value != r * per_round:
                raise RuntimeError(f"counters round {r} doc {d}: the counter "
                                   f"reads {value}, want {r * per_round}")
            if want is not None and patch != want:
                raise RuntimeError(f"counters round {r} doc {d}: the farm's "
                                   f"patch {patch} differs from OpSet's "
                                   f"{want}")
        if record is not None:
            record.extend(canon(p) for p in list(result)[:COUNTER_CPU_DOCS])
    return farm, seconds


# (d) tests/test_sync_v2.py's TestFarmBatchedFingerprints


def v2_pair(device):
    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    P = port_pkg(device)
    pair = []
    for actor, keys in (("aaaaaaaa", ("a", "x")), ("bbbbbbbb", ("b",))):
        farm = TorchDocFarm(V2_FARM_DOCS, capacity=256, device=device)
        for d in range(V2_FARM_DOCS):
            buf, _ = farm_change(P, actor, 1, 1, [], [
                uint_set(f"{k}{d}", v) for v, k in enumerate(keys)])
            per_doc = [[] for _ in range(V2_FARM_DOCS)]
            per_doc[d] = [buf]
            farm.apply_changes(per_doc)
        pair.append(SyncFarm(farm))
    return pair


def run_v2_sweeps(device, record):
    """The two cases: sweeps over 4 v2 channels until quiet, at most one
    ``sync.fingerprint_ranges`` dispatch per ``generate_messages`` call
    (the port's observatory), every doc converged; a single sweep with
    every channel probing is one dispatch; an empty query list none.
    Returns the dispatches of each generate call of the first case."""
    from automerge_tpu_torch import SyncFarm
    from automerge_tpu_torch.obs.prof import (
        enabled_observatory,
        get_observatory,
    )
    from automerge_tpu_torch.tpu.fingerprint import FingerprintIndex

    n, protocols = V2_FARM_DOCS, ["v2"] * V2_FARM_DOCS
    prog = get_observatory().programs()["sync.fingerprint_ranges"]
    sa, sb = v2_pair(device)
    states = {id(sa): [SyncFarm.init_state() for _ in range(n)],
              id(sb): [SyncFarm.init_state() for _ in range(n)]}
    per_call = []
    with enabled_observatory():
        for _ in range(V2_FARM_SWEEPS):
            moved = False
            for src, dst in ((sa, sb), (sb, sa)):
                before = prog.dispatches
                out = src.generate_messages(
                    list(zip(range(n), states[id(src)])), protocols=protocols)
                per_call.append(prog.dispatches - before)
                states[id(src)] = [s for s, _ in out]
                sends = [(d, states[id(dst)][d], m)
                         for d, (_, m) in enumerate(out) if m is not None]
                record.extend(m for _, _, m in sends)
                if sends:
                    recv = dst.receive_messages(sends, protocols=protocols)
                    for (d, _, _), (state, _p) in zip(sends, recv):
                        states[id(dst)][d] = state
                moved = bool(sends)
            if not moved:
                break
        for d in range(n):
            if sa.farm.get_heads(d) != sb.farm.get_heads(d):
                raise RuntimeError(f"(d) v2 doc {d} did not converge")
            record.append(canon(sa.farm.get_patch(d)))
        if not 0 < sum(per_call) <= 2 * V2_FARM_SWEEPS or max(per_call) > 1:
            raise RuntimeError(f"(d) fingerprint dispatches per generate "
                               f"call {per_call}: want at most one each")
        fresh, _ = v2_pair(device)
        before = prog.dispatches
        out = fresh.generate_messages(
            [(d, SyncFarm.init_state()) for d in range(n)],
            protocols=protocols)
        probing = prog.dispatches - before
        before = prog.dispatches
        empty = FingerprintIndex(device=device).fingerprint_ranges([])
        idle = prog.dispatches - before
    if probing != 1 or any(m is None for _, m in out) or empty or idle:
        raise RuntimeError(f"(d) one sweep with every channel probing made "
                           f"{probing} dispatches; the empty query list "
                           f"{idle}")
    record.extend(m for _, m in out)
    return per_call


# (e) tests/test_obs.py's farm and engine counts


def run_instrument_counts(device):
    """test_farm_and_engine_metrics_count_real_work: 5 docs x 2 rounds x 4
    ops, each package's counts as the JAX test reads them. Returns them."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.obs.__main__ import _change_stream
    from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics

    names = ("farm.rows.transcoded", "farm.rows.padding",
             "farm.changes.applied", "engine.device.dispatches",
             "engine.jit.cache_hits", "engine.jit.recompiles")
    reg = get_metrics()
    with counting_fallbacks(), enabled_metrics():
        before = counts(names)
        occupancy = reg.histogram("farm.batch.occupancy").count
        farm = TorchDocFarm(5, capacity=96, device=device)
        for buf in _change_stream("aaaaaaaa", 2, 4, seed=0):
            farm.apply_changes([[buf]] * 5)
        got = {k: v - before[k] for k, v in counts(names).items()}
        got["farm.batch.occupancy"] = (
            reg.histogram("farm.batch.occupancy").count - occupancy)
        got["farm.pad_waste_ratio"] = reg.gauge("farm.pad_waste_ratio").value
    want = {"farm.rows.transcoded": 40, "farm.rows.padding": 0,
            "farm.changes.applied": 10, "engine.device.dispatches": 6,
            "farm.batch.occupancy": 2, "farm.pad_waste_ratio": 0.0}
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    hits = got["engine.jit.cache_hits"] + got["engine.jit.recompiles"]
    if wrong or hits != got["engine.device.dispatches"]:
        raise RuntimeError(f"(e) instrument counts (got, want): {wrong}; "
                           f"hits + recompiles {hits}")
    return got


def visibility_times(farm):
    """The farm's visibility program over every doc at its current width
    (``paged_visible_plain``, as the engine dispatches it), and inside it
    ``visible_docs``'s ``scatter_add_`` of the live increments onto their
    targets, on the farm's own rows, against the same scatter onto
    distinct positions; device ms per call by CUDA events. Returns
    (times, [docs, width])."""
    import torch

    from automerge_tpu_torch.tpu.engine import (
        _I64_MAX,
        _MKEY_OP_BITS,
        ACTION_INC,
        PAD_KEY,
        _merge_key,
    )
    from automerge_tpu_torch.tpu.paging import _gather_pages, paged_visible_plain

    eng = farm.engine
    size = eng.pages.page_size
    width = eng._width(int(eng.lengths.max()))
    gidx = eng._page_map(eng.page_table, width, eng._pow2(farm.num_docs),
                         fill=0)
    times = {"visibility_ms": _time_cuda(
        lambda: paged_visible_plain(eng.slab, gidx, page_size=size),
        iters=5)}
    key, op, action, value, pred, _over = _gather_pages(eng.slab, gidx, size)
    # the scatter's operands as visible_docs builds them (every target
    # live: no increment's counter is overwritten here)
    mkey = _merge_key(key, op)
    is_inc = (key != PAD_KEY) & (action == ACTION_INC)
    target = torch.where(is_inc & (pred >= 0),
                         (key.long() << _MKEY_OP_BITS) | pred.clamp(min=0),
                         torch.full_like(pred, _I64_MAX))
    tpos = torch.searchsorted(mkey, target).clamp(max=width - 1)
    vals = torch.where(is_inc, value, torch.zeros_like(value))
    spread = torch.arange(width, device=tpos.device).expand_as(tpos)
    for name, pos in (("scatter_ms", tpos), ("spread_scatter_ms", spread)):
        times[name] = _time_cuda(
            lambda pos=pos: torch.zeros_like(vals).scatter_add_(1, pos, vals),
            iters=20)
    # bytes: positions and values read, the zeroed output written
    times["scatter_bound_ms"] = 3 * vals.numel() * 8 / HBM_BYTES_PER_S * 1e3
    return times, list(key.shape)


def phase_share(prof, name):
    totals = prof.totals_by_path()
    farm_s = sum(t for path, (t, _) in totals.items() if "/" not in path)
    return totals.get(name, (0.0, 0))[0] / farm_s if farm_s else 0.0


def log_phase_table(prof, title):
    log(f"  phase table ({title}, host clock):")
    for line in prof.table().splitlines():
        log("    " + line)


def run_farm_phase(args, card, device, diff_docs=DIFF_DOCS,
                   counter_docs=COUNTER_DOCS):
    """Phase 22 (see the module docstring); logs the whole phase with its
    parts."""
    t0 = time.perf_counter()
    gc.collect()
    gc.freeze()
    try:
        parts = farm_phase(args, card, device, diff_docs, counter_docs)
    finally:
        gc.unfreeze()
    log(f"  whole phase {time.perf_counter() - t0:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))


def farm_phase(args, card, device, diff_docs, counter_docs):
    """Runs phase 22; returns the seconds of its parts."""
    import torch

    from automerge_tpu_torch.obs.flight import enabled_flight
    from automerge_tpu_torch.opset import OpSet
    from automerge_tpu_torch.profiling import PhaseProfile

    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    fallbacks = fallback_counts()
    # (a) the nine hand cases on the card, each call held to OpSet; the
    # same records on the CPU
    on_card = run_farm_basics(port_pkg(device))
    if on_card != run_farm_basics(port_pkg("cpu")):
        raise RuntimeError("(a) the card's farm-basics records differ from "
                           "the CPU's")
    log(f"phase 22 the farm held to OpSet, card {card}")
    log(f"  (a) farm-basics: the {len(FARM_BASICS)} cases of "
        f"tests/test_farm.py's TestFarmBasics on the card, {len(on_card)} "
        f"patches and outcomes equal to OpSet's and to the CPU's")
    lap("(a)")
    # (b) the differential at phase 3's doc count, card vs OpSet and vs
    # the CPU
    doc_ids = range(diff_docs)
    deliveries, want, opsets = diff_traffic(doc_ids, DIFF_ROUNDS, DIFF_SEED,
                                            delay_prob=DIFF_DELAY)
    known = known_divergences(doc_ids)
    lap("(b) traffic")
    prof = PhaseProfile()
    on_card, on_cpu = [], []
    farm, diff_s = run_farm_diff(device, deliveries, want, opsets, known,
                                 prof, record=on_card)
    rows = int(farm.engine.lengths.sum())
    changes = sum(len(b) for per_doc in deliveries for b in per_doc)
    check_no_fallback(fallbacks, [farm], "phase 22 (b)")
    del farm
    lap("(b) card")
    run_farm_diff("cpu", deliveries, want, opsets, known, record=on_cpu)
    if on_card != on_cpu:
        raise RuntimeError("(b) the card's patches differ from the CPU's")
    log(f"  (b) farm-diff-{diff_docs}: tests/test_farm.py's differential "
        f"traffic (seed {DIFF_SEED}, 3 actors, counters, nesting, deletes, "
        f"delay_prob {DIFF_DELAY}) over {diff_docs} docs x {DIFF_ROUNDS} "
        f"rounds + {DIFF_DRAIN} drain rounds: {changes} changes, {rows} op "
        f"rows committed in {diff_s:.3f} s of apply_changes "
        f"({rows / diff_s:.1f} rows/s); every round's patch of every doc "
        f"equal to OpSet's but at the {len(known)} (round, doc) pairs where "
        f"both packages' farms differ from it ({sorted(known)}), all "
        f"{len(on_card)} equal to a CPU farm's; every whole patch, heads and "
        f"missing deps equal to OpSet's (traffic and OpSet "
        f"{parts['(b) traffic']:.3f} s)")
    log_phase_table(prof, "farm-diff")
    del deliveries, want, opsets, on_card, on_cpu
    lap("(b) cpu")
    # (c) BASELINE.json configs[2] on every doc
    per_round = COUNTER_ACTORS * COUNTER_INCS
    rounds = counter_stream(COUNTER_ACTORS, COUNTER_CHANGES, COUNTER_INCS,
                            args.seed)
    doc_rows = 1 + COUNTER_ACTORS * COUNTER_CHANGES * COUNTER_INCS
    log(f"  (c) counters-64x100k: BASELINE.json configs[2] per doc, "
        f"{COUNTER_ACTORS} actors x {COUNTER_CHANGES} changes x "
        f"{COUNTER_INCS} inc ops on one counter ({doc_rows - 1} concurrent "
        f"increments) on {counter_docs} docs; expected slab "
        f"{counter_docs} x {doc_rows} rows x {COUNTER_ROW_BYTES} B = "
        f"{counter_docs * doc_rows * COUNTER_ROW_BYTES / 1e6:.1f} MB before "
        f"page padding, slab doubling and the merge's temporaries")
    _sync(device)
    on_gpu = torch.device(device).type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    prof = PhaseProfile()
    on_card = []
    with enabled_flight() as flight:
        flight.clear()
        farm, counter_s = run_counters(device, counter_docs, rounds,
                                       per_round, prof, record=on_card)
        _sync(device)
        grows = sum(1 for e in flight.snapshot()
                    if e.get("event") == "engine.slab.grow")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB" if on_gpu
            else "not measured")
    rows = int(farm.engine.lengths.sum())
    if rows != counter_docs * doc_rows:
        raise RuntimeError(f"(c) the farm holds {rows} rows, want "
                           f"{counter_docs * doc_rows}")
    final = COUNTER_CHANGES * per_round
    for d in range(counter_docs):
        value = counter_value(farm.get_patch(d), f"(c) doc {d}")
        if value != final:
            raise RuntimeError(f"(c) doc {d}'s whole patch reads {value}, "
                               f"want {final}")
    eng = farm.engine
    owned = [p for table in eng.page_table for p in table]
    if len(owned) != len(set(owned)) or 0 in owned or \
            len(owned) != eng.pages.allocated:
        raise RuntimeError(f"(c) the allocator holds {eng.pages.allocated} "
                           f"pages, the page tables name {len(owned)}")
    check_no_fallback(fallbacks, [farm], "phase 22 (c)")
    incs = counter_docs * (doc_rows - 1)
    log(f"  (c) {incs} increments in {counter_s:.3f} s of apply_changes "
        f"({incs / counter_s:.1f} increments/s); every doc read "
        f"{per_round} x r after round r and {final} at the end; {rows} rows, "
        f"{eng.pages.allocated} pages held of {eng.pages.num_pages} "
        f"(page size {eng.pages.page_size}), no page leaked; "
        f"{grows} engine.slab.grow events; visibility "
        f"{phase_share(prof, 'visibility'):.1%} of the farm phases; peak "
        f"device memory {peak}")
    log_phase_table(prof, "counters")
    if on_gpu:
        times, shape = visibility_times(farm)
        log(f"  (c) visibility program at {shape} (docs x width) on the "
            f"farm's rows, CUDA events: whole program "
            f"{times['visibility_ms']:.4f} ms; its scatter_add_ of "
            f"{per_round * COUNTER_CHANGES} increments a doc onto one "
            f"position {times['scatter_ms']:.4f} ms, onto distinct "
            f"positions {times['spread_scatter_ms']:.4f} ms, bytes bound "
            f"{times['scatter_bound_ms']:.4f} ms")
    del farm
    lap("(c) card")
    on_cpu = []
    farm, cpu_s = run_counters("cpu", COUNTER_CPU_DOCS, rounds, per_round,
                               record=on_cpu)
    if on_cpu != on_card:
        raise RuntimeError(f"(c) docs 0-{COUNTER_CPU_DOCS - 1}'s patches on "
                           "the card differ from a CPU farm's")
    del farm, rounds
    lap("(c) cpu")
    cut = counter_stream(COUNTER_ACTORS, COUNTER_CHANGES, COUNTER_CUT_INCS,
                         args.seed)
    farm, cut_s = run_counters(device, COUNTER_CUT_DOCS, cut,
                               COUNTER_ACTORS * COUNTER_CUT_INCS,
                               opset=OpSet())
    check_no_fallback(fallbacks, [farm], "phase 22 (c)")
    log(f"  (c) docs 0-{COUNTER_CPU_DOCS - 1}: every round's patch equal to "
        f"a CPU farm's ({cpu_s:.3f} s there); the cut {COUNTER_ACTORS} "
        f"actors x {COUNTER_CHANGES} x {COUNTER_CUT_INCS} increments on "
        f"{COUNTER_CUT_DOCS} docs: every round's patch equal to OpSet's "
        f"(farm {cut_s:.3f} s)")
    del farm, cut
    lap("(c) opset")
    # (d) sync v2 over the farm on the card, card vs CPU
    on_card, on_cpu = [], []
    per_call = run_v2_sweeps(device, on_card)
    run_v2_sweeps("cpu", on_cpu)
    if on_card != on_cpu:
        raise RuntimeError("(d) the card's v2 messages or patches differ "
                           "from the CPU's")
    log(f"  (d) sync v2 over {V2_FARM_DOCS} channels: converged, "
        f"sync.fingerprint_ranges dispatches per generate call {per_call}; "
        f"one sweep with every channel probing 1, the empty query list 0; "
        f"messages and patches equal to the CPU's")
    lap("(d)")
    # (e) the farm's and the engine's counts on the card
    got = run_instrument_counts(device)
    log(f"  (e) instruments of tests/test_obs.py's two-call case on the "
        f"card: {got}")
    lap("(e)")
    return parts


# ---------------------------------------------------------------------- #
# phase 23: BASELINE.json configs[3], "Table + nested list: 3-way
# concurrent branch merge (fuzz_test corpus)"

# the docs: 128, cut from the 512 of phases 3 and 22 (configs[4]'s 1k-doc
# batch, cut) to keep the script inside its time limit (512 docs took
# 123.7 s beside an H100 on an 8-core host, 256 docs 73.5 s); per doc: the base's rows and items a row;
# epochs, change() calls per branch an epoch and edits a change (1 to
# BRANCH_EDITS); the farms' capacity and the docs held to a CPU farm
BRANCH_DOCS, BRANCH_ROWS, BRANCH_ITEMS = 128, 8, 4
BRANCH_EPOCHS, BRANCH_CHANGES, BRANCH_EDITS = 4, 4, 3
BRANCH_CAPACITY, BRANCH_CPU_DOCS = 512, 64
BRANCH_BASE = "0ba5e000"
BRANCH_ACTORS = ("aaaaaaaa", "bbbbbbbb", "cccccccc")
BRANCH_TIME = 1_700_000_000
# an edit's kind and its weight (percent) when it is drawn
BRANCH_MIX = {"title": 30, "insert": 30, "delete": 15, "overwrite": 15,
              "add": 5, "remove": 5}


def branch_row(rng, tag):
    return {"title": f"row {tag}", "done": rng.random() < 0.5,
            "items": [f"{tag}.{j}" for j in range(BRANCH_ITEMS)]}


def branch_edit(rng, x, tag):
    """One edit of the board in `x` (a change's root), of a kind drawn
    from ``BRANCH_MIX`` on a row drawn at random; `tag` is what it
    writes. An item edit on an empty list inserts, and any edit of an
    empty board adds a row. No edit empties a list or the board: both
    packages' frontends read an object that the change has emptied from
    the document as it was before the change (``get_object`` takes the
    updated object only if it is truthy), so a later edit of it in the
    same change fails (ROADMAP queue C). Removing the last row retitles
    it instead, and deleting the last item overwrites it. Returns (the
    kind drawn, the kind made)."""
    board = x["board"]
    ids = sorted(board.ids)
    kind = rng.choices(list(BRANCH_MIX), list(BRANCH_MIX.values()))[0]
    if kind == "add" or not ids:
        board.add(branch_row(rng, tag))
        return kind, "add"
    row_id = rng.choice(ids)
    if kind == "remove" and len(ids) > 1:
        board.remove(row_id)
        return kind, "remove"
    row = board.by_id(row_id)
    if kind in ("title", "remove"):
        row["title"] = tag
        return kind, "title"
    items = row["items"]
    n = len(items)
    if kind == "insert" or n == 0:
        items.insert(rng.randrange(n + 1), tag)
        return kind, "insert"
    if kind == "delete" and n > 1:
        items.delete_at(rng.randrange(n))
        return kind, "delete"
    items[rng.randrange(n)] = tag
    return kind, "overwrite"


def branch_doc(api, seed):
    """One doc of phase 23's corpus (`api` the package whose API builds
    it, its uuid factory pinned by the caller): a base client makes the
    root Table ``board``, then its rows (the frontend refuses rows in the
    change that creates the table); three branch clients load the base
    and make ``BRANCH_EPOCHS`` epochs of ``BRANCH_CHANGES`` changes each.
    After each epoch every branch's ``get_changes`` since the epoch
    began, deduplicated by hash (it repeats changes the branch merged
    before), makes the epoch's delivery (the base's changes lead the
    first), and each branch applies the other two's. Returns
    (deliveries, the three branches' ``save()`` bytes after the last
    epoch, stats: repeats dropped, edits made of each kind, edits steered
    from the kind drawn)."""
    columnar = importlib.import_module(f"{api.__name__}.columnar")
    rng = random.Random(seed)
    made = dict.fromkeys(BRANCH_MIX, 0)
    steered = 0

    def edit(x, tag):
        nonlocal steered
        drawn, kind = branch_edit(rng, x, tag)
        made[kind] += 1
        steered += drawn != kind

    base = api.change(api.init(BRANCH_BASE),
                      {"time": BRANCH_TIME, "message": "board"},
                      lambda x: x.__setitem__("board", api.Table()))
    base = api.change(base, {"time": BRANCH_TIME, "message": "rows"},
                      lambda x: [x["board"].add(branch_row(rng, i))
                                 for i in range(BRANCH_ROWS)])
    first = api.get_all_changes(base)
    branches = [api.apply_changes(api.init(actor), first)[0]
                for actor in BRANCH_ACTORS]
    seen = {columnar.decode_change_meta(b, True)["hash"] for b in first}
    deliveries, repeats = [], 0
    for e in range(BRANCH_EPOCHS):
        began = list(branches)
        for b in range(len(branches)):
            for k in range(BRANCH_CHANGES):
                tags = [f"{b}.{e}.{k}.{i}"
                        for i in range(rng.randint(1, BRANCH_EDITS))]
                branches[b] = api.change(
                    branches[b], {"time": BRANCH_TIME + 1 + e},
                    lambda x, tags=tags: [edit(x, t) for t in tags])
        new = []
        for b, doc in enumerate(branches):
            mine = []
            for buf in api.get_changes(began[b], doc):
                h = columnar.decode_change_meta(buf, True)["hash"]
                if h in seen:
                    repeats += 1
                else:
                    seen.add(h)
                    mine.append(buf)
            new.append(mine)
        deliveries.append((list(first) if e == 0 else [])
                          + [buf for mine in new for buf in mine])
        branches = [api.apply_changes(doc, [buf for o, mine in enumerate(new)
                                            if o != b for buf in mine])[0]
                    for b, doc in enumerate(branches)]
    return deliveries, [api.save(doc) for doc in branches], {
        "repeats": repeats, "edits": made, "steered": steered}


def run_branch_corpus(docs, seed, api=None):
    """Phase 23's corpus: doc `d` by ``branch_doc`` seeded `seed` + `d`,
    over `api` (default: this package's), its Table row ids from a uuid
    factory seeded with its seed. Returns (deliveries [epoch][doc], the
    branches' ``save()`` bytes after the last epoch [doc][branch], stats:
    the repeats ``get_changes`` returned, the edits made of each kind,
    those steered from the kind drawn, and seconds)."""
    if api is None:
        import automerge_tpu_torch as api
    uuid_module = importlib.import_module(f"{api.__name__}.uuid")
    t0 = time.perf_counter()
    per_doc = []
    try:
        for d in range(docs):
            ids = random.Random(f"row ids {seed + d}")
            uuid_module.set_factory(lambda: f"{ids.getrandbits(128):032x}")
            per_doc.append(branch_doc(api, seed + d))
    finally:
        uuid_module.reset_factory()
    stats = {"repeats": sum(s["repeats"] for _, _, s in per_doc),
             "edits": {k: sum(s["edits"][k] for _, _, s in per_doc)
                       for k in BRANCH_MIX},
             "steered": sum(s["steered"] for _, _, s in per_doc),
             "s": time.perf_counter() - t0}
    deliveries = [list(epoch) for epoch in zip(*(d for d, _, _ in per_doc))]
    return deliveries, [saves for _, saves, _ in per_doc], stats


def branch_reference(deliveries):
    """Every delivery of phase 23's corpus through one port ``OpSet`` per
    doc. Returns (patches [epoch][doc], the OpSets, the documents after
    each delivery [epoch][doc]: each OpSet's whole-document patch read
    through ``Frontend.apply_patch``, with its heads)."""
    from automerge_tpu_torch import Frontend
    from automerge_tpu_torch.opset import OpSet

    opsets = [OpSet() for _ in deliveries[0]]
    want, docs = [], []
    for epoch in deliveries:
        want.append([o.apply_changes(bufs) for o, bufs in zip(opsets, epoch)])
        docs.append([(Frontend.apply_patch(Frontend.init(), o.get_patch()),
                      o.heads) for o in opsets])
    return want, opsets, docs


def run_branch_merge(device, deliveries, want, prof=None, record=None,
                     make_farm=None, after=None):
    """The three-way merge: each epoch's delivery to every doc in one
    ``apply_changes`` call to one farm (`make_farm(docs, capacity)`, by
    default a ``TorchDocFarm`` on `device`), timed to a synchronize;
    every doc's patch must equal `want`'s (``branch_reference``) and no
    delivery may be quarantined. The lists make every doc a walk document,
    whose incremental patch is its embedded ``OpSet``'s, made on the host:
    what the card computed shows in whole-document reads, which
    `after(epoch, farm)` may make after each epoch, outside the timed
    window. `record` (a list) collects every patch. Returns (farm, the
    seconds of each call)."""
    from automerge_tpu_torch.profiling import PhaseProfile, use_profile

    if make_farm is None:
        from automerge_tpu_torch import TorchDocFarm

        def make_farm(n, capacity):
            return TorchDocFarm(n, capacity=capacity, device=device)

    prof = prof or PhaseProfile(enabled=False)
    farm = make_farm(len(deliveries[0]), BRANCH_CAPACITY)
    latency = []
    for e, per_doc in enumerate(deliveries):
        _sync(device)
        t0 = time.perf_counter()
        with use_profile(prof):
            result = farm.apply_changes(per_doc)
        _sync(device)
        latency.append(time.perf_counter() - t0)
        if result.quarantined:
            raise RuntimeError(f"branch-merge epoch {e}: docs "
                               f"{result.quarantined} quarantined")
        for d, patch in enumerate(result):
            if patch != want[e][d]:
                raise RuntimeError(
                    f"branch-merge epoch {e} doc {d}: the farm's patch "
                    f"{patch} differs from OpSet's {want[e][d]}")
        if record is not None:
            record.extend(canon(p) for p in result)
        if after is not None:
            after(e, farm)
    return farm, latency


def check_whole(farm, reference, what, api=None, keep=0):
    """Phase 23 (b), after a delivery: every doc's whole-document patch
    from the farm (the card's ranks and visibility mirror), read through
    ``Frontend.apply_patch``, equals the reference's (`reference` [doc]
    of (document, heads), ``branch_reference``'s), and its heads are the
    reference's. Returns the first `keep` docs' whole patches
    (``canon``)."""
    if api is None:
        import automerge_tpu_torch as api

    kept = []
    for d, (want, heads) in enumerate(reference):
        patch = farm.get_patch(d)
        if d < keep:
            kept.append(canon(patch))
        if not api.equals(api.Frontend.apply_patch(api.Frontend.init(),
                                                   patch), want):
            raise RuntimeError(f"{what}: doc {d}: the farm's whole document "
                               "differs from OpSet's")
        if farm.get_heads(d) != heads:
            raise RuntimeError(f"{what}: doc {d}: the farm's heads differ "
                               "from OpSet's")
    return kept


def check_branches(farm, saves, what, api=None):
    """Phase 23 (b), after the last delivery: every branch document,
    loaded from its ``save()`` bytes (`saves` [doc][branch]), equals the
    farm's whole-document patch read through ``Frontend.apply_patch``, and
    its heads are the farm's."""
    if api is None:
        import automerge_tpu_torch as api

    backend = api.get_backend()
    for d, row in enumerate(saves):
        farm_doc = api.Frontend.apply_patch(api.Frontend.init(),
                                            farm.get_patch(d))
        heads = farm.get_heads(d)
        for b, data in enumerate(row):
            saved = api.load(data)
            if not api.equals(saved, farm_doc):
                raise RuntimeError(f"{what}: doc {d} branch {b}: its saved "
                                   "document differs from the farm's")
            state = api.Frontend.get_backend_state(saved, "check_branches")
            if backend.get_heads(state) != heads:
                raise RuntimeError(f"{what}: doc {d} branch {b}: heads "
                                   "differ from the farm's")


@contextlib.contextmanager
def timed_rga_ranks(device):
    """Routes ``batched_rga_rank`` through CUDA events while the block
    runs; yields a tally: ``calls``, and after the block ``ms``, the
    device time of every call (None off the card)."""
    import torch

    from automerge_tpu_torch.tpu import rga

    fn, events = rga.batched_rga_rank, []
    on_gpu = torch.device(device).type == "cuda"
    tally = {"calls": 0, "ms": None}

    def timed(*args):
        tally["calls"] += 1
        if not on_gpu:
            return fn(*args)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args)
        end.record()
        events.append((start, end))
        return out

    rga.batched_rga_rank = timed
    try:
        yield tally
    finally:
        rga.batched_rga_rank = fn
    if on_gpu:
        torch.cuda.synchronize()
        tally["ms"] = sum(s.elapsed_time(e) for s, e in events)


def run_branch_catchup(device, farm, docs, rec):
    """Phase 23 (d): a fresh replica farm catches up with `farm` over the
    Bloom sync until no message moves; every doc's heads and whole patch
    must then match. Returns (replica, sweeps)."""
    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    replica = TorchDocFarm(docs, capacity=BRANCH_CAPACITY, device=device)
    sweeps = sync_until_quiet(device, SyncFarm(farm), [SyncFarm(replica)],
                              docs, rec)
    check_converged([farm, replica], docs)
    return replica, sweeps


def check_no_quarantine(farms, what):
    """Phase 23 (e): no farm failed a delivery or holds a quarantined doc."""
    for f in farms:
        if f.quarantine or any(f.fault_counts):
            raise RuntimeError(f"{what}: docs {sorted(f.quarantine)} "
                               f"quarantined, failed deliveries "
                               f"{[d for d, n in enumerate(f.fault_counts) if n]}")


def run_branch_phase(args, table, card, device, docs=BRANCH_DOCS):
    """Phase 23 (see the module docstring) on `docs` docs; logs the whole
    phase with its parts."""
    t0 = time.perf_counter()
    gc.collect()
    gc.freeze()
    try:
        parts = branch_phase(args, table, card, device, docs)
    finally:
        gc.unfreeze()
    log(f"  whole phase {time.perf_counter() - t0:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))


def branch_phase(args, table, card, device, docs):
    """Runs phase 23; returns the seconds of its parts."""
    import torch

    from automerge_tpu_torch.profiling import PhaseProfile
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    fallbacks = fallback_counts()
    deliveries, saves, stats = run_branch_corpus(docs, args.seed)
    lap("corpus")
    want, _opsets, reference = branch_reference(deliveries)
    lap("reference")
    changes = sum(len(bufs) for epoch in deliveries for bufs in epoch)
    nbytes = sum(len(b) for epoch in deliveries for bufs in epoch
                 for b in bufs)
    log(f"phase 23 branch-merge-{docs}: BASELINE.json configs[3] (a Table "
        f"of {BRANCH_ROWS} rows, each with a {BRANCH_ITEMS}-item list; "
        f"{len(BRANCH_ACTORS)} branches x {BRANCH_EPOCHS} epochs x "
        f"{BRANCH_CHANGES} changes of 1-{BRANCH_EDITS} edits) on {docs} "
        f"docs, card {card}")
    log(f"  corpus through the API: {changes} changes, {nbytes} bytes, "
        f"{stats['repeats']} repeats of get_changes dropped by hash "
        f"({stats['s']:.3f} s); edits made {stats['edits']}, "
        f"{stats['steered']} of them steered from the kind drawn; OpSet "
        f"reference {parts['reference']:.3f} s")
    on_gpu = torch.device(device).type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    prof = PhaseProfile()
    on_card, whole_card = [], []
    cpu_docs = min(BRANCH_CPU_DOCS, docs)
    ranks = {"calls": 0, "ms": None, "s": 0.0}

    def converged(e, farm):
        # (b) after every delivery, the farm's whole-document patch, whose
        # elements the card ranks, against OpSet's; after the last, every
        # branch saved and loaded against it too
        t = time.perf_counter()
        with timed_rga_ranks(device) as tally:
            whole_card.append(check_whole(farm, reference[e],
                                          f"phase 23 (b) epoch {e}",
                                          keep=cpu_docs))
            if e == len(deliveries) - 1:
                check_branches(farm, saves, "phase 23 (b)")
        ranks["calls"] += tally["calls"]
        if tally["ms"] is not None:
            ranks["ms"] = (ranks["ms"] or 0.0) + tally["ms"]
        ranks["s"] += time.perf_counter() - t

    bk.reset_launch_counts()
    # (a) the four three-way deliveries, every patch held to OpSet's
    farm, latency = run_branch_merge(device, deliveries, want, prof,
                                     record=on_card, after=converged)
    merge_s = sum(latency)
    rows = int(farm.engine.lengths.sum())
    log(f"  (a) {rows} op rows committed in {merge_s:.3f} s of "
        f"apply_changes to a synchronize ({rows / merge_s:.1f} op rows/s); "
        f"per delivery {[round(s, 4) for s in latency]} s; every patch of "
        f"every doc equal to OpSet's (on walk documents the embedded "
        f"OpSet's, made on the host); nothing quarantined")
    log_phase_table(prof, "branch-merge")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB" if on_gpu
            else "not measured")
    eng = farm.engine
    ms = ranks["ms"]
    log(f"  (b) after each of the {len(deliveries)} deliveries, every "
        f"doc's whole-document patch from the farm equals OpSet's, heads "
        f"too; after the last, every branch's saved document ({docs} x "
        f"{len(BRANCH_ACTORS)}) equals it, with the farm's heads "
        f"({ranks['s']:.3f} s); batched_rga_rank {ranks['calls']} calls, "
        f"{ms if ms is None else round(ms, 4)} device ms (CUDA events); "
        f"{eng.pages.allocated} pages held of {eng.pages.num_pages} (page "
        f"size {eng.pages.page_size}); peak device memory {peak}")
    del saves, reference
    lap("(a), (b)")
    # (c) the first docs through a CPU farm, byte for byte: its incremental
    # patches and, after each delivery, its whole-document patches
    on_cpu, whole_cpu = [], []
    run_branch_merge("cpu", [epoch[:cpu_docs] for epoch in deliveries],
                     [epoch[:cpu_docs] for epoch in want], record=on_cpu,
                     after=lambda _e, f: whole_cpu.append(
                         [canon(f.get_patch(d)) for d in range(cpu_docs)]))
    if on_cpu != [p for e in range(len(deliveries))
                  for p in on_card[e * docs:e * docs + cpu_docs]]:
        raise RuntimeError(f"(c) docs 0-{cpu_docs - 1}'s patches on the "
                           "card differ from a CPU farm's")
    if whole_cpu != whole_card:
        raise RuntimeError(f"(c) docs 0-{cpu_docs - 1}'s whole-document "
                           "patches on the card differ from a CPU farm's")
    log(f"  (c) docs 0-{cpu_docs - 1}: every delivery's patches and the "
        f"whole-document patches after it equal to a CPU farm's")
    del deliveries, want, on_card, on_cpu, whole_card, whole_cpu
    lap("(c)")
    # (d) a fresh replica catches up over the Bloom sync
    with recorded_bloom_launches() as (rec_build, rec_query):
        replica, sweeps = run_branch_catchup(device, farm, docs,
                                             lambda _msg: None)
    launches = dict(bk.LAUNCHES)
    log(f"  (d) a fresh replica caught up in {len(sweeps)} sweeps, "
        f"{sum(sw.moved for sw in sweeps)} messages, "
        f"{sum(sw.bytes for sw in sweeps)} bytes, "
        f"{sum(sw.seconds for sw in sweeps):.3f} s; heads and whole patches "
        f"equal; kernel launches {launches}")
    check_launched(table, launches, rec_build, rec_query, "branch",
                   "phase 23")
    # (e) no fallback, no quarantine
    check_no_fallback(fallbacks, [farm, replica], "phase 23")
    check_no_quarantine([farm, replica], "phase 23")
    lap("(d), (e)")
    return parts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=512)
    parser.add_argument("--replicas", type=int, default=MAP_REPLICAS)
    parser.add_argument("--changes", type=int, default=MAP_CHANGES)
    parser.add_argument("--ops", type=int, default=MAP_OPS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--text-docs", type=int, default=256)
    parser.add_argument("--farm-text-docs", type=int, default=2)
    parser.add_argument("--v2-docs", type=int, default=64)
    parser.add_argument("--fault-docs", type=int, default=64)
    parser.add_argument("--store-docs", type=int, default=STORE_DOCS)
    parser.add_argument("--serve-clients", type=int, default=SERVE_CLIENTS)
    parser.add_argument("--api-docs", type=int, default=API_DOCS)
    parser.add_argument("--cli-docs", type=int, default=CLI_DOCS)
    parser.add_argument("--mesh-docs", type=int, default=MESH_DOCS)
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
    """Phases 1-23 on the card (see the module docstring); raises on the
    first check that fails."""
    import shutil
    import tempfile

    import torch

    from automerge_tpu_torch import kernels, native
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

    # 3. main path (the native codecs decode on the card's host)
    if not native.available():
        raise RuntimeError(f"the native codecs are off: {native.load_error}")
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
    totals = prof.totals_by_path()
    farm_s = sum(t for path, (t, _) in totals.items() if "/" not in path)
    log(f"  native codecs on: {native.available()} ({native.library_path()});"
        f" decode {totals.get('decode', (0.0, 0))[0] / farm_s:.1%} of the "
        f"farm phases")
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
        fallbacks = fallback_counts()
        f4, api_clients, _ = run_api(dev, 8, API_CLIENTS, API_ROUNDS,
                                     args.seed, record=rec)
        rec.append(repr(check_api(f4, api_clients, f"phase 4 ({dev})")))
        check_no_fallback(fallbacks, [f4], f"phase 4 ({dev})")
        meshes = {}
        for backend in ("inline", "process"):
            run_mesh_small(dev, backend, args.seed,
                           meshes.setdefault(backend, []))
        if meshes["inline"] != meshes["process"]:
            raise RuntimeError(f"phase 4 ({dev}): the process mesh differs "
                               "from the inline mesh")
        rec.extend(meshes["inline"])
        state, vis, _ = run_dense(
            dev, dense_batches(16, DENSE_ROUNDS, DENSE_OPS, args.seed),
            DENSE_ROUNDS * DENSE_OPS, warm=False)
        rec.extend(c.tobytes() for c in dense_columns(state, vis, 16))
        fallbacks = fallback_counts()
        f4, _ = run_faults(dev, 16, 25, args.seed, record=rec)
        for mode in ("columnar", "oracle"):
            run_gate(dev, 16, args.seed, mode, rec)
        run_have_filters(dev, 16, args.seed, rec)
        peers = run_bad_peers(dev, 16, args.seed, rec)
        check_no_fallback(fallbacks, [f4, peers["server"]],
                          f"phase 4 ({dev})")
    if on_card != on_cpu:
        first = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu))
                     if a != b) if len(on_card) == len(on_cpu) else "length"
        raise RuntimeError(f"card and CPU runs differ (first at {first})")
    log(f"phase 4 card vs CPU at 16 docs (v1 sync, mixed v1/v2 sync, 16 "
        f"supervised channels, a store round trip with a torn tail, 64 "
        f"served clients at 30 % chaos with a store attached, 8 docs x "
        f"{API_CLIENTS} API clients x {API_ROUNDS} rounds against a farm, "
        f"a {MESH_SMALL[0]}-doc mesh of {MESH_SMALL[1]} shards inline and "
        f"over process workers, 16 docs of phase 20's dense merge, 16 "
        f"docs of phase 21's fault run at 25 % poison, gate in both modes, "
        f"have filters and sync sweep with malformed peers): "
        f"{len(on_card)} messages, patches, frames, "
        f"saved sessions, reports and store files identical "
        f"({time.perf_counter() - t0:.2f} s)")

    del f4, clients, pairs, api_clients

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
        args.text_docs, min(TEXT_SAMPLE, args.text_docs), replace=False))
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

    # 17. the public API's clients against the farm, observatory on
    programs17, api_rate = run_api_phase(args, table, card, device)

    # 18. the obs CLI on the card, then its ledger modes
    run_cli_phase(args, programs17, api_rate, device)

    # 19. the doc-sharded mesh: process workers on the card
    run_mesh_phase(args, table, card, device)

    # 20. the engine-level API: bench.py's dense whole-state merge, then
    # BASELINE's 100k-doc batch, a BatchTranscoder round, the port's amlint
    run_dense_phase(args, table, card, device)

    # 21. the per-document fault domains, the causal gate, the batched have
    # filters and a sync sweep with malformed peers
    run_faults_phase(args, table, card, device)

    # 22. the farm held to OpSet on the JAX suite's cases and traffic,
    # BASELINE's counter configuration, sync v2 and the instruments
    run_farm_phase(args, card, device)

    # 23. BASELINE's table-and-nested-list three-way branch merge
    run_branch_phase(args, table, card, device)

    log(card)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

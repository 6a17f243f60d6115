#!/usr/bin/env python3
"""Chip smoke run of automerge_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build the CUDA kernels from ``automerge_tpu_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, started together), timed;
2. hold each kernel against its plain PyTorch version on the card,
   bit-exact, at edge shapes;
3. the main path: a server ``TorchDocFarm`` of 1,024 map/counter documents
   and 8 replica farms of the same documents. Each replica makes 8 changes
   of 16 ops to every document (sets on 64 root keys; increments on the
   counter its first change creates), then the replicas sync with the
   server over the Bloom protocol (``SyncFarm``) until no message moves:
   one ``generate_messages`` call over all 8,192 server channels per
   sweep, one ``receive_messages`` call per replica. Every farm must end
   with equal heads and equal whole-document patches, and both Bloom
   kernels must have launched. The kernels are then held against their
   plain versions again on the inputs of their largest main-path launch,
   and timed there (CUDA events);
4. the same scenario at 16 documents, once on the card and once on the
   CPU: every sync message and every patch must be byte-identical.

The line before the last is the kernel table (JSON); the last line is
``{"ok": true, "device": {...}}``. Weights are the documents themselves,
made from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------- #
# the scenario: replicas edit, then sync with the server until quiescent


def make_edits(docs, replicas, changes, ops, seed):
    """Per replica, per change index, one change buffer per document: the
    first change sets the replica's counter and 15 root keys, later ones
    increment that counter and set 15 root keys (a set names the
    replica's previous op on its key as pred)."""
    from automerge_tpu_torch.columnar import decode_change_columns, encode_change

    rng = np.random.default_rng(seed)
    out = []
    for r in range(replicas):
        actor = f"{r + 1:02x}" * 16
        per_change = []
        heads = [[] for _ in range(docs)]
        last = [dict() for _ in range(docs)]
        keys = rng.integers(0, 64, size=(changes, docs, ops - 1))
        vals = rng.integers(0, 1 << 20, size=(changes, docs, ops - 1))
        incs = rng.integers(1, 10, size=(changes, docs))
        for c in range(changes):
            start = c * ops + 1
            bufs = []
            for d in range(docs):
                if c == 0:
                    first = {"action": "set", "obj": "_root", "key": "ctr",
                             "value": 0, "datatype": "counter", "pred": []}
                else:
                    first = {"action": "inc", "obj": "_root", "key": "ctr",
                             "value": int(incs[c, d]), "pred": [f"1@{actor}"]}
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
                 prof=None):
    """Builds the farms, applies the replicas' edits, syncs to quiescence.
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

        s_states = [[SyncFarm.init_state() for _ in range(docs)]
                    for _ in range(replicas)]
        r_states = [[SyncFarm.init_state() for _ in range(docs)]
                    for _ in range(replicas)]
        t_sync = time.perf_counter()
        for _sweep in range(32):
            t_sweep = time.perf_counter()
            moved = 0
            # replicas -> server: one receive call per replica (distinct docs)
            for r in range(replicas):
                out = rsyncs[r].generate_messages(
                    [(d, r_states[r][d]) for d in range(docs)])
                batch = []
                for d, (state, msg) in enumerate(out):
                    r_states[r][d] = state
                    rec(msg)
                    if msg is not None:
                        batch.append((d, s_states[r][d], msg))
                moved += len(batch)
                if batch:
                    for (d, _, _), (state, patch) in zip(
                            batch, ssync.receive_messages(batch)):
                        s_states[r][d] = state
                        rec(canon(patch) if patch is not None else None)
            # server -> replicas: every channel in one generate call
            out = ssync.generate_messages(
                [(d, s_states[r][d]) for r in range(replicas)
                 for d in range(docs)])
            for r in range(replicas):
                batch = []
                for d in range(docs):
                    state, msg = out[r * docs + d]
                    s_states[r][d] = state
                    rec(msg)
                    if msg is not None:
                        batch.append((d, r_states[r][d], msg))
                moved += len(batch)
                if batch:
                    for (d, _, _), (state, patch) in zip(
                            batch, rsyncs[r].receive_messages(batch)):
                        r_states[r][d] = state
                        rec(canon(patch) if patch is not None else None)
            _sync(device)
            stats["sweeps"].append((time.perf_counter() - t_sweep, moved))
            if moved == 0:
                break
        else:
            raise RuntimeError("sync did not quiesce in 32 sweeps")
        stats["sync_s"] = time.perf_counter() - t_sync
    rows1 = sum(int(f.engine.lengths.sum()) for f in [server, *farms])
    stats["merged_rows"] = rows1 - rows0
    return [server, *farms], stats


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


# ---------------------------------------------------------------------- #
# kernels: exactness, timing, bounds


def _time_cuda(fn, iters=50):
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
    1, a word count that is not a multiple of 32, a 10,000-entry filter
    (3,125 words), and a candidate count that is not a power of two."""
    import torch

    rng = np.random.default_rng(7)
    cases = [  # (batch, entries, words, candidates, counts)
        (4, 3, 1, 5, [0, 1, 0, 1]),
        (3, 64, 20, 33, [64, 40, 0]),
        (2, 10_000, 3125, 1001, [10_000, 9_999]),
        (5, 12, 16, 9, [12, 7, 1, 0, 3]),
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


def build_bound(xyz, counts, num_words):
    live = int(counts.clamp(max=xyz.shape[1]).long().sum().item())
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


class LargestLaunch:
    """Wraps a kernel entry of sync_batch to keep a copy of the inputs of
    its largest call (by element count) during the main path."""

    def __init__(self, fn):
        self.fn = fn
        self.size = -1
        self.args = None

    def __call__(self, *args):
        size = sum(a.numel() for a in args if hasattr(a, "numel"))
        if size > self.size:
            self.size = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a
                              for a in args)
        return self.fn(*args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=1024)
    parser.add_argument("--replicas", type=int, default=8)
    parser.add_argument("--changes", type=int, default=8)
    parser.add_argument("--ops", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # the decode LRUs (columnar.py) are deployment settings, sized here to
    # the run's working set: every distinct change is re-read by 9 farms
    # and thousands of channels per sweep, and the defaults (8,192 changes,
    # 16,384 metas) hold an eighth of the 65,536 changes of the full size
    cap = str(2 * args.docs * args.replicas * args.changes)
    os.environ.setdefault("AM_DECODE_CACHE_CHANGES", cap)
    os.environ.setdefault("AM_DECODE_CACHE_METAS", cap)
    os.environ.setdefault("AM_DECODE_CACHE_BYTES", str(1 << 30))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one H100",
              file=sys.stderr)
        return 2
    try:
        from automerge_tpu_torch import kernels
        from automerge_tpu_torch.profiling import PhaseProfile
        from automerge_tpu_torch.tpu import bloom_kernels as bk
        from automerge_tpu_torch.tpu import sync_batch
    except ImportError as exc:
        print(f"chip_smoke: the automerge_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2

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
    rec_build = LargestLaunch(sync_batch.bloom_build)
    rec_query = LargestLaunch(sync_batch.bloom_query)
    sync_batch.bloom_build, sync_batch.bloom_query = rec_build, rec_query
    prof = PhaseProfile()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    farms, stats = run_scenario(device, args.docs, args.replicas,
                                args.changes, args.ops, args.seed, prof=prof)
    launches = dict(bk.LAUNCHES)
    main_s = time.perf_counter() - t0
    sync_batch.bloom_build, sync_batch.bloom_query = rec_build.fn, rec_query.fn
    t0 = time.perf_counter()
    check_converged(farms, args.docs)
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
    for i, (dt, moved) in enumerate(sweeps):
        log(f"  sweep {i}: {dt * 1e3:.1f} ms, {moved} messages")
    log(f"  merged rows during sync: {stats['merged_rows']} "
        f"({stats['merged_rows'] / stats['sync_s']:.0f} ops/s); server rows "
        f"{server_rows}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"  kernel launches: {launches}")
    log("  phase table (main path, host clock):")
    for line in prof.table().splitlines():
        log("    " + line)

    # kernels at the main path's largest launch: exactness, time, bound
    xyz, counts, num_words = rec_build.args
    words, modulo, build_err = check_build(xyz, counts, num_words)
    q_words, q_mod, q_counts, query = rec_query.args
    query_err = check_query(q_words, q_mod, q_counts, query)
    b_bound, b_bytes, _ = build_bound(xyz, counts, num_words)
    q_bound, q_bytes, _ = query_bound(q_words, q_counts, query)
    table = {"kernels": [
        {"name": "bloom_build", "route": "cuda",
         "source": "automerge_tpu_torch/csrc/bloom.cu",
         "replaces": "automerge_tpu/tpu/pallas_kernels.py:258",
         "launches": launches["bloom_build"], "max_abs_err": build_err,
         "ms": _time_cuda(lambda: bk.bloom_build(xyz, counts, num_words)),
         "plain_ms": _time_cuda(
             lambda: bk.bloom_build_plain(xyz, counts, num_words), iters=10),
         "bound_ms": b_bound, "bound_by": "bytes", "library_ms": None,
         "shape": {"B": xyz.shape[0], "E": xyz.shape[1], "W": num_words,
                   "bytes": b_bytes}},
        {"name": "bloom_query", "route": "cuda",
         "source": "automerge_tpu_torch/csrc/bloom.cu",
         "replaces": "automerge_tpu/tpu/pallas_kernels.py:113",
         "launches": launches["bloom_query"], "max_abs_err": query_err,
         "ms": _time_cuda(
             lambda: bk.bloom_query(q_words, q_mod, q_counts, query)),
         "plain_ms": _time_cuda(
             lambda: bk.bloom_query_plain(q_words, q_mod, q_counts, query),
             iters=10),
         "bound_ms": q_bound, "bound_by": "bytes", "library_ms": None,
         "shape": {"B": q_words.shape[0], "C": query.shape[1],
                   "W": q_words.shape[1], "bytes": q_bytes}},
    ]}
    del farms

    # 4. the same scenario at 16 docs: card vs CPU, byte for byte
    t0 = time.perf_counter()
    on_card, on_cpu = [], []
    farms_c, _ = run_scenario("cuda", 16, args.replicas, args.changes,
                              args.ops, args.seed, record=on_card)
    farms_h, _ = run_scenario("cpu", 16, args.replicas, args.changes,
                              args.ops, args.seed, record=on_cpu)
    on_card.extend(check_converged(farms_c, 16))
    on_cpu.extend(check_converged(farms_h, 16))
    if on_card != on_cpu:
        first = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu))
                     if a != b) if len(on_card) == len(on_cpu) else "length"
        raise RuntimeError(f"card and CPU runs differ (first at {first})")
    log(f"phase 4 card vs CPU at 16 docs: {len(on_card)} messages and "
        f"patches identical ({time.perf_counter() - t0:.2f} s)")

    log(card)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

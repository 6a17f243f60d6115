"""The ``dense`` loop: the port's dense whole-state engine
(``tpu/engine.py``) over every document of the stream at once, BASELINE's
batched ``applyChanges``. One step is one round and one call: it uploads
the round's rows from pinned host memory (``changes_from_numpy``) and
merges them (``batched_apply_ops``), timed on the host clock until a
synchronize. An epoch's first round starts from a fresh
``make_empty_state``; every few rounds (the stream's samples) the call
also runs ``batched_visible_state`` and reads back the visible rows of the
sampled documents, as a server answers the ``getPatch`` calls its clients
wait on. Each call into the program is named with the driver's span
(``dense.reset``, ``dense.upload``, ``dense.merge``, ``dense.visibility``,
``dense.readback``).

The loop judges its runs itself (`check`): after the window it merges the
rest of the last epoch, untimed, and holds the whole state of every
document, and every read-back row, to ``reference/dense.py``. Its control
(`build_control`) is that reference with the broken guarantee in the
engine's place. It reports end-to-end metrics of its own (`end_to_end`)
and hands the readers the bytes of the traced merges and visibility passes
(`readings`)."""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from harness import cells, roofline
from harness.check import CheckResult

#: documents the check hands the reference at a time, and its threads
CHECK_BLOCK, CHECK_THREADS = 1024, 8


def farm_count(stream) -> int:
    return 1


class Engine:
    """The port's dense entry points, as the loop calls them; the control
    and the fault tests put others in their place."""

    def __init__(self, docs, capacity, device):
        from automerge_tpu_torch.tpu import engine

        self.engine = engine
        self.docs, self.capacity, self.device = docs, capacity, device

    def empty(self):
        return self.engine.make_empty_state(self.docs, self.capacity,
                                            device=self.device)

    def upload(self, columns):
        return self.engine.changes_from_numpy(*columns, device=self.device)

    def apply(self, state, batch):
        return self.engine.batched_apply_ops(state, batch)

    def visible(self, state):
        return self.engine.batched_visible_state(state)

    def read(self, vis, docs):
        """The 5 visibility columns of documents `docs`, on the host."""
        import torch

        idx = torch.as_tensor(docs, device=self.device)
        return [c.index_select(0, idx).cpu().numpy() for c in vis]

    def columns(self, state, vis):
        """The 7 state and 5 visibility columns of every document, on the
        host."""
        return [c.cpu().numpy() for c in (*state, *vis)]


class ControlEngine:
    """The reference in the engine's place, with the control's broken
    guarantee (``lww``): a state is the list of rounds handed to it."""

    def __init__(self, ref_mod, capacity):
        self.ref_mod, self.capacity = ref_mod, capacity

    def empty(self):
        return []

    def upload(self, columns):
        return columns

    def apply(self, state, batch):
        state.append(batch)
        return state

    def visible(self, state):
        return list(state)

    def _merge(self, rounds, docs=None):
        cols = [np.concatenate([b[c] if docs is None else b[c][docs]
                                for b in rounds], axis=1) for c in range(5)]
        return self.ref_mod.merge(*cols, self.capacity, lww=True)

    def read(self, vis, docs):
        out = self._merge(vis, docs)
        return [out[name] for name in self.ref_mod.VISIBLE]

    def columns(self, state, vis):
        out = self._merge(state)
        return [out[name] for name in self.ref_mod.STATE
                + self.ref_mod.VISIBLE]


def build(cfg, mix, stream, device):
    """The engine, with the stream's rounds drawn on `device` (on the
    card into pinned host memory)."""
    epoch = stream.changes.epoch.draw(device)
    return [Engine(stream.docs, epoch.capacity, device)], None


def build_control(cfg, mix, stream, ref_mod):
    import torch

    epoch = stream.changes.epoch.draw(
        "cuda" if torch.cuda.is_available() else "cpu")
    return [ControlEngine(ref_mod, epoch.capacity)], None


class Driver(cells.Driver):
    def __init__(self, stream, mix, farms, syncs=None, device="cuda"):
        super().__init__(stream, mix, farms, syncs, device)
        self.engine = farms[0]
        self.epoch = stream.changes.epoch
        # rows the documents hold before each round
        self.held = np.concatenate([[0], np.cumsum(self.epoch.rows)[:-1]])
        self.state = None
        self.merged = 0         # rounds merged into the state
        self.readbacks = []     # (rounds merged, docs, 5 columns)
        self.window_rounds = 0
        self.window_ops = 0
        # the traced steps' merges and visibility passes, and the bytes
        # their bounds count
        self.traced = {"merges": 0, "merge_bytes": 0, "passes": 0,
                       "visibility_bytes": 0}

    def run_step(self, step) -> None:
        r, sample = step
        eng = self.engine
        t0 = time.perf_counter()
        if r == 0:
            with self.span("dense.reset"):
                self.state = None
                self.state = eng.empty()
        with self.span("dense.upload"):
            batch = eng.upload(self.epoch.rounds[r])
        with self.span("dense.merge"):
            self.state = eng.apply(self.state, batch)
        rows = None
        if sample is not None:
            with self.span("dense.visibility"):
                vis = eng.visible(self.state)
            with self.span("dense.readback"):
                rows = eng.read(vis, sample)
            del vis
        cells.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.merged = r + 1
        held, new = int(self.held[r]), int(self.epoch.rows[r])
        if rows is not None:
            self.readbacks.append((r + 1, sample, rows))
        if self.tracing:
            t = self.traced
            t["merges"] += 1
            t["merge_bytes"] += roofline.dense_merge_bytes(held, new)
            if rows is not None:
                t["passes"] += 1
                t["visibility_bytes"] += roofline.dense_visibility_bytes(
                    held + new)
        if self.in_window:
            self.apply_ms.append(dt * 1e3)
            self.program_s += dt
            self.rows += new
            self.window_ops += int(self.epoch.ops[r])
            self.window_rounds += 1

    def finals(self):
        """The 12 columns of every document (visibility by the same
        ``batched_visible_state``) once the last epoch is merged to its end
        (the rounds the window left, untimed)."""
        while self.merged < self.epoch.rounds_per_epoch:
            self.step()
        vis = self.engine.visible(self.state)
        cols = self.engine.columns(self.state, vis)
        self.state = None
        return {"columns": cols}

    def end_to_end(self, window_s):
        """The cell's own end-to-end metrics: the ops merged in the window
        over its seconds, and the 95th percentile of its round calls."""
        return {"dense_merged_ops_per_s": self.window_ops / window_s,
                "dense_round_p95_ms": (float(np.percentile(
                    np.asarray(self.apply_ms, np.float64), 95))
                    if self.apply_ms else None)}

    def readings(self):
        return dict(self.traced)


ControlDriver = Driver


def _differ(got, want):
    """Per document: whether column `got` differs from `want` (all of
    them where the shapes differ)."""
    if got.shape != want.shape:
        return np.ones(want.shape[0], bool)
    bad = got != want
    return bad.reshape(bad.shape[0], -1).any(axis=1)


def _by_blocks(fn, docs):
    """[fn(block)] over blocks of `docs` (an index array), a thread each
    (NumPy's sorts and gathers leave the interpreter lock, so the
    reference of every document takes seconds, not minutes)."""
    blocks = [docs[i:i + CHECK_BLOCK] for i in range(0, len(docs),
                                                      CHECK_BLOCK)]
    with ThreadPoolExecutor(min(CHECK_THREADS, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, blocks))


def check(ref_mod, stream, driver, finals):
    """The dense loop's output check (the four numbers of
    ``harness/check.py``, each with the limit 0):

    - ``state_mismatches``: documents whose 7 state or 5 visibility
      columns, once the last epoch is merged to its end, differ from the
      reference's state of all the epoch's rounds (every document);
    - ``patch_mismatches``: read-back documents, of every readback, whose
      visibility rows differ from the reference's at that round;
    - ``failed_changes``: documents whose ``num_ops`` is not the number of
      rows handed to them;
    - ``unquiesced_epochs``: 0 (no sync).
    """
    epoch = stream.changes.epoch
    res = CheckResult()
    names = ref_mod.STATE + ref_mod.VISIBLE
    got = dict(zip(names, finals["columns"]))

    def final(block):
        want = ref_mod.merge(*epoch.columns(epoch.rounds_per_epoch, block),
                             epoch.capacity)
        return [_differ(got[n][block], want[n]) for n in names]

    differ = [np.concatenate(c) for c in zip(*_by_blocks(
        final, np.arange(stream.docs)))]
    for name, d in zip(names, differ):
        if d.any():
            res.note(f"state: column {name} differs in {int(d.sum())} "
                     f"documents (first {int(np.argmax(d))})")
    res.states = stream.docs
    res.state_mismatches = int(np.logical_or.reduce(differ).sum())
    res.failed = int(differ[names.index("num_ops")].sum())

    by_round = {}
    for rounds, docs, rows in driver.readbacks:
        by_round.setdefault(rounds, []).append((docs, rows))
    for rounds, reads in sorted(by_round.items()):
        docs = np.unique(np.concatenate([d for d, _ in reads]))
        parts = _by_blocks(lambda block, n=rounds: ref_mod.merge(
            *epoch.columns(n, block), epoch.capacity), docs)
        ref = {n: np.concatenate([p[n] for p in parts])
               for n in ref_mod.VISIBLE}
        for sample, rows in reads:
            at = np.searchsorted(docs, sample)
            wrong = np.zeros(len(sample), bool)
            for name, col in zip(ref_mod.VISIBLE, rows):
                wrong |= _differ(col, ref[name][at])
            res.patches += len(sample)
            if wrong.any():
                res.patch_mismatches += int(wrong.sum())
                res.note(f"read-back after round {rounds}: "
                         f"{int(wrong.sum())} of {len(sample)} documents "
                         f"differ (first {int(sample[np.argmax(wrong)])})")
    res.attempted = driver.window_rounds * stream.docs
    return res

"""What every window driver shares. A traffic mix's ``loop`` names a
module ``loops/<loop>.py`` (found through `plugins`) that builds the
system under test for a stream (``build``), says how many farms it holds
(``farm_count``) and drives the window (``Driver``, a subclass of
`Driver` here that defines ``run_step``; ``ControlDriver`` is the one the
control runs with the reference in the program's place). Drivers hand a
stream's steps to the system and record, from what its calls return,
everything the metrics and the output check read. No driver reads the
program's state inside the window."""
from __future__ import annotations

import contextlib
import pickle
import time
from typing import NamedTuple


class StreamExhausted(RuntimeError):
    """The window outlasted the generated stream."""


class Snapshot(NamedTuple):
    """One patch a farm call returned for one document, with its clock
    and heads copied at once (the farm may reuse them), and the changes
    delivered to that document by the call when the driver knows them
    (None in a sync, where the protocol chooses)."""

    farm: int
    doc: int
    clock: dict
    deps: list
    max_op: int
    pending: int
    props: dict
    delivered: list | None


class Records:
    """The driver's snapshots in call order, each kept pickled. Bytes are
    not on the collector's heap: a full collection in the window walks
    none of the harness's record of every patch, only the program's
    objects, and a record keeps nothing of the program's alive. Iterates
    as `Snapshot`s."""

    def __init__(self):
        self._blobs: list[bytes] = []

    def append(self, snap: Snapshot) -> None:
        self._blobs.append(pickle.dumps(tuple(snap), pickle.HIGHEST_PROTOCOL))

    def __iter__(self):
        for blob in self._blobs:
            yield Snapshot(*pickle.loads(blob))

    def __len__(self) -> int:
        return len(self._blobs)


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """Runs the steps of `stream` (traffic.Stream) on `farms` (farm 0 the
    server; 1.. the replicas of a sync). `syncs`, for a sync, holds a
    ``SyncFarm`` over each farm. A loop's driver defines `run_step`; every
    call into the program goes through `_apply` or is timed alike."""

    def __init__(self, stream, mix, farms, syncs=None, device="cuda"):
        self.stream = stream
        self.mix = mix
        self.farms = farms
        self.syncs = syncs or []
        self.device = device
        self.pos = 0
        self.in_window = False
        self.tracing = False     # steps run under the device trace
        self.records = Records()
        self.index = stream.changes.by_author()
        self.known = {}          # (farm, doc) -> {actor: seq}
        self.quarantined = []    # (farm, doc, [change index]) lost
        # window tallies
        self.rows = 0
        self.apply_ms: list[float] = []
        self.made: list[int] = []        # changes made in the window
        self.lag_ms: list[float] = []
        self.sync_bytes = 0
        self.sweeps = 0
        self.epochs = 0
        self.generate_s = 0.0
        self.program_s = 0.0             # time inside the program's calls
        self.unquiesced = 0              # sync epochs given up
        # a traced run names each program call for the device trace
        self.span = lambda name: contextlib.nullcontext()

    # ------------------------------------------------------------------ #

    def step(self) -> None:
        if self.pos >= len(self.stream.steps):
            raise StreamExhausted(
                f"the stream's {len(self.stream.steps)} steps ran out "
                "before the window closed: raise the traffic's 'steps'")
        step = self.stream.steps[self.pos]
        self.pos += 1
        self.run_step(step)

    def run_step(self, step) -> None:
        """Hands one step, [(source, [change index, ...])], to the
        system."""
        raise NotImplementedError

    def _per_doc(self, idxs):
        ch = self.stream.changes
        per_doc = [[] for _ in range(self.stream.docs)]
        for i in idxs:
            per_doc[ch.doc[i]].append(ch.data[i])
        return per_doc

    def _apply(self, f, idxs, delivered):
        per_doc = self._per_doc(idxs)
        t0 = time.perf_counter()
        with self.span("farm.apply_changes"):
            result = self.farms[f].apply_changes(per_doc)
            synchronize(self.device)
        dt = time.perf_counter() - t0
        if self.in_window:
            self.apply_ms.append(dt * 1e3)
            self.program_s += dt
        by_doc = {}
        if delivered:
            ch = self.stream.changes
            for i in idxs:
                by_doc.setdefault(ch.doc[i], []).append(i)
        for d, bufs in enumerate(per_doc):
            if bufs:
                self._observe(f, d, result[d], by_doc.get(d))
        for d in result.quarantined:
            self.quarantined.append((f, d, by_doc.get(d)))

    def _observe(self, f, d, patch, delivered=None):
        clock = dict(patch["clock"])
        self.records.append(Snapshot(
            f, d, clock, list(patch["deps"]), patch["maxOp"],
            patch["pendingChanges"], patch["diffs"]["props"], delivered))
        known = self.known.setdefault((f, d), {})
        if self.in_window:
            nops = self.stream.changes.nops
            for actor, seq in clock.items():
                for s in range(known.get(actor, 0) + 1, seq + 1):
                    self.rows += nops[self.index[(actor, s)]]
        known.update(clock)

    # ------------------------------------------------------------------ #

    def finals(self):
        """After the window: every touched document's whole state on
        every farm, read through ``get_patch``: {(farm, doc): (clock,
        heads, props)}."""
        docs = sorted({d for (_, d) in self.known})
        out = {}
        for f, farm in enumerate(self.farms):
            for d in docs:
                p = farm.get_patch(d)
                out[(f, d)] = (dict(p["clock"]), sorted(p["deps"]),
                               p["diffs"]["props"])
        return out

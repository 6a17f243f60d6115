"""Flight recorder: a bounded ring of structured events for
postmortems that do not require re-running the workload.

Metrics (obs/metrics.py) answer "how much"; spans answer "where did the
time go". Neither answers "what exactly happened, in what order, just
before the service degraded" — that is this module. Subsystems append
compact structured events (session retransmits and backoff, watchdog
escalations, quarantine enter/release with the offending change hashes,
batcher flush decisions, engine recompiles with their shape buckets,
page-slab growth) into one process-wide ring buffer:

- **bounded and allocation-cheap**: a ``collections.deque(maxlen=N)`` of
  small tuples; recording when enabled is one append, recording when
  disabled is a single attribute test (call sites guard kwargs packing
  with ``if _FLIGHT.enabled:``, the same convention as ``_METRICS``);
- **causally ordered**: every event carries a process-global monotonic
  sequence number, so the dump renders a total order even when call sites
  stamp it with different clocks (sessions pass their injected —
  possibly simulated — clock; host layers default to the recorder's);
- **snapshot-dumped on faults**: ``trigger(reason)`` writes the whole
  ring as JSON lines into ``dump_dir`` (``AM_FLIGHT_DIR`` or explicit),
  bounded to ``MAX_AUTO_DUMPS`` files per process. The farm triggers on
  quarantine entry and device faults, the session layer on channel
  quarantine and watchdog resets — so a `DeviceFaultError` at 3am leaves
  a timeline behind, not just counters.
- **mesh-mergeable**: a recorder can be tagged with a ``(shard, epoch)``
  origin (mesh workers are; ``epoch`` is the spawn generation, so a
  respawned worker's restarted local seq cannot collide with its previous
  life). Workers ``ship()`` their unshipped tail over the result pipe and
  the controller ``absorb()``\\s it into the unified timeline, assigning
  fresh controller seqs while preserving the origin key ``(epoch, shard,
  wseq)``. Merged dumps therefore order deterministically: controller seq
  first, origin key as the tiebreaker when independently-numbered dumps
  are concatenated.

This is the port's own copy of the JAX package's ``obs/flight.py`` (a
host-only module), with its own process-wide recorder. The mesh workers'
black-box files come with the port of ``parallel/``; ``render_timeline``
renders a dump as a causally ordered timeline.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Iterator

#: ring capacity (events); old events fall off the front
DEFAULT_CAPACITY = 4096
#: auto-dump files per process: a quarantine storm must not fill a disk
MAX_AUTO_DUMPS = 8


class FlightRecorder:
    """One process-wide ring of structured events. See module docstring."""

    __slots__ = ("enabled", "clock", "dump_dir", "dump_paths", "shard",
                 "epoch", "_ring", "_seq", "_shipped")

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=None):
        self.enabled = False
        self.clock = clock if clock is not None else time.monotonic
        self.dump_dir = os.environ.get("AM_FLIGHT_DIR") or None
        self.dump_paths: list[str] = []
        #: origin tag for mesh workers; None on the controller / solo host
        self.shard: int | None = None
        #: spawn generation of the tagged worker (bumped on respawn)
        self.epoch = 0
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._shipped = 0

    # -------------------------------------------------------------- #
    # recording

    def record(self, event: str, t: float | None = None, **fields) -> None:
        """Appends one event. ``t`` is the caller's clock reading (pass the
        injected clock's value from clocked subsystems so simulated-time
        runs produce simulated-time timelines); None stamps the recorder's
        own clock. Hot call sites guard with ``if recorder.enabled:`` so
        the disabled path never packs kwargs."""
        if not self.enabled:
            return
        self._seq += 1
        self._ring.append(
            (self._seq, self.clock() if t is None else t, event, fields)
        )

    def trigger(self, reason: str, t: float | None = None, **fields
                ) -> str | None:
        """Records a ``flight.trigger`` event and snapshot-dumps the ring
        to ``dump_dir`` (one JSONL file per trigger, bounded by
        ``MAX_AUTO_DUMPS``). Returns the dump path, or None when disabled,
        undumpable (no dump_dir) or over the dump budget."""
        if not self.enabled:
            return None
        self.record("flight.trigger", t=t, reason=reason, **fields)
        if self.dump_dir is None or len(self.dump_paths) >= MAX_AUTO_DUMPS:
            return None
        path = os.path.join(
            self.dump_dir,
            f"amflight-{os.getpid()}-{len(self.dump_paths) + 1:02d}.jsonl",
        )
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.to_jsonl())
        self.dump_paths.append(path)
        return path

    # -------------------------------------------------------------- #
    # the mesh telemetry channel: worker ship -> controller absorb

    def ship(self) -> list[dict]:
        """The unshipped tail as event dicts, advancing the ship mark.

        This is the flight half of the worker shipping buffer: called once
        per pipe response (result frames and heartbeats alike) and sent
        alongside the ``metrics_delta``. Cheap when idle or disabled: a
        counter compare, no allocation. Events that fell off the bounded
        ring before shipping are lost by design (same budget as dumps)."""
        if self._seq == self._shipped:
            return []
        mark = self._shipped
        self._shipped = self._seq
        return [e for e in self.snapshot() if e["seq"] > mark]

    def absorb(self, events: list[dict], dedup: bool = False) -> int:
        """Merges shipped (or black-box-recovered) worker events into this
        ring, assigning fresh controller seqs so the unified timeline has
        one total order; each event keeps its origin key ``(shard, epoch,
        wseq)`` and the worker's own clock reading. ``dedup=True`` (the
        black-box recovery path) skips events whose origin key is already
        in the ring — the worker may have live-shipped part of its tail
        before dying. No-op when disabled. Returns the absorbed count."""
        if not self.enabled:
            return 0
        seen = (
            {entry[4] for entry in self._ring if len(entry) == 5}
            if dedup else None
        )
        absorbed = 0
        for e in events:
            origin = (e.get("shard"), e.get("epoch", 0),
                      e.get("wseq", e.get("seq", 0)))
            if seen is not None and origin in seen:
                continue
            self._seq += 1
            absorbed += 1
            self._ring.append(
                (self._seq, e.get("t", 0.0), e.get("event", ""),
                 e.get("fields") or {}, origin)
            )
        return absorbed

    # -------------------------------------------------------------- #
    # reading

    def snapshot(self) -> list[dict]:
        """The ring as a list of dicts, oldest first (causal order).

        Untagged recorders (the single-process case) produce exactly the
        pre-mesh shape; shard-tagged recorders and absorbed worker events
        add ``shard``/``epoch``/``wseq`` origin keys."""
        out = []
        for entry in self._ring:
            seq, t, kind, fields = entry[:4]
            e = {"seq": seq, "t": t, "event": kind, "fields": fields}
            if len(entry) == 5:  # absorbed from a worker
                e["shard"], e["epoch"], e["wseq"] = entry[4]
            elif self.shard is not None:  # this recorder IS a worker's
                e["shard"], e["epoch"], e["wseq"] = self.shard, self.epoch, seq
            out.append(e)
        return out

    def tail(self, n: int = 16) -> list[dict]:
        """The newest ``n`` events (causal order within the slice)."""
        events = self.snapshot()
        return events[-n:]

    def to_jsonl(self) -> str:
        lines = [
            json.dumps(event, sort_keys=True, default=str)
            for event in self.snapshot()
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        """Empties the ring and the per-run dump budget (the sequence
        counter keeps climbing so post-clear events still order after
        pre-clear dumps)."""
        self._ring.clear()
        self.dump_paths = []


# ---------------------------------------------------------------------- #
# dump loading + timeline rendering (the `--flight` CLI path)

def _merge_key(e: dict) -> tuple:
    """Deterministic order for merged multi-process timelines: primary is
    the (controller) seq — identical to the pre-mesh sort for
    single-process dumps — tie-broken by the origin key ``(epoch, shard,
    local_seq)`` so independently-numbered dumps concatenated together
    (e.g. a controller dump plus a dead worker's black box) interleave
    without per-process seq collisions scrambling the order."""
    shard = e.get("shard")
    return (e.get("seq", 0), e.get("epoch", 0),
            -1 if shard is None else shard, e.get("wseq", 0))


def load_jsonl(text: str) -> list[dict]:
    """Parses a dump back into event dicts, sorted causally (see
    ``_merge_key``; plain single-process dumps sort by seq exactly as
    before)."""
    events = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            events.append(json.loads(line))
    events.sort(key=_merge_key)
    return events


def render_timeline(events: list[dict]) -> str:
    """Causally-ordered human-readable timeline of a dump. A shard column
    appears once any event carries a mesh origin tag (controller-local
    rows show ``-``); untagged dumps render byte-identically to the
    pre-mesh format."""
    if not events:
        return "(no flight events)"
    width = max(len(e.get("event", "")) for e in events)
    tagged = any("shard" in e for e in events)
    header = f"{'seq':>6}  "
    if tagged:
        header += f"{'shard':>5}  "
    header += f"{'t':>12}  {'event'.ljust(width)}  fields"
    lines = [header]
    for e in events:
        fields = e.get("fields") or {}
        detail = " ".join(f"{k}={fields[k]}" for k in sorted(fields))
        row = f"{e.get('seq', 0):>6}  "
        if tagged:
            shard = e.get("shard")
            row += f"{'-' if shard is None else shard:>5}  "
        row += (
            f"{e.get('t', 0.0):>12.6f}  "
            f"{e.get('event', '').ljust(width)}  {detail}"
        )
        lines.append(row)
    return "\n".join(lines)


# ---------------------------------------------------------------------- #
# the process-wide recorder (disabled until a workload opts in)

_GLOBAL = FlightRecorder()


def get_flight() -> FlightRecorder:
    """The process-wide flight recorder every instrumented module uses."""
    return _GLOBAL


@contextlib.contextmanager
def enabled_flight(recorder: FlightRecorder | None = None,
                   dump_dir: str | None = None) -> Iterator[FlightRecorder]:
    """Enables a recorder (the process-wide one by default) for the
    dynamic extent, restoring the previous enabled state and dump_dir."""
    rec = recorder if recorder is not None else _GLOBAL
    was_enabled, was_dir = rec.enabled, rec.dump_dir
    rec.enabled = True
    if dump_dir is not None:
        rec.dump_dir = dump_dir
    try:
        yield rec
    finally:
        rec.enabled = was_enabled
        rec.dump_dir = was_dir

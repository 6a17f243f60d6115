"""Zero-copy mesh data plane: shared-memory column rings.

Under the pickle transport the process-backend mesh ships every delivery
as a pickled column batch over the worker pipe (``mesh.pipe.<s>.*``). The
columns are flat bytes on both ends, so that serialization is pure waste.
This module is the shared-memory replacement: a pair of bounded
single-producer/single-consumer rings per shard —

- the **send ring** (controller produces, worker consumes) carries the
  per-delivery column batches (``[(local_doc, change_buffers...)]``),
- the **result ring** (worker produces, controller consumes) carries the
  apply result frame (patch blob + struct-encoded outcome tuples),

and the pipe carries only compact control frames: op, a :class:`SlotRef`
(slot id + generation + length), metric deltas and flight tails. Pickle
stays available as the byte-for-byte parity oracle (``mesh_transport=
"pickle"``) and the automatic fallback when POSIX shared memory is not
available (:func:`shm_available`).

Ring anatomy (one ``multiprocessing.shared_memory`` segment per ring):
an int64 header — magic, slot count, slot capacity, then four words per
slot ``(state, generation, used_bytes, reserved)`` — followed by the slot
data region. Slot lifecycle is an explicit three-state handshake::

    FREE --acquire (producer, bumps generation)--> PRODUCER_HELD
         --accept  (consumer, checks generation)--> CONSUMER_HELD
         --release (consumer)--------------------> FREE

The pipe provides ordering (a SlotRef is only ever read after its control
frame arrives), so the header words need no cross-process atomics beyond
aligned int64 stores. Bounded capacity gives natural backpressure: a
producer that finds no FREE slot spins with a short sleep (the caller
meters the stall) or gives up after ``timeout`` and falls back to the
inline pickle path — the rings can degrade, never deadlock.

The generation counter is the crash story: a worker killed while a slot
is PRODUCER_HELD leaves the header intact, so the controller reclaims
exactly the held slots (:meth:`ColumnRing.reclaim`) and a stale SlotRef
from before the crash can never alias a reused slot — ``accept`` checks
the generation and refuses. Respawned workers re-attach to the same
segments by name; clean shutdown unlinks every segment so nothing leaks
in ``/dev/shm``. Segment names start ``amt-`` (``ring_name``), so they never
match the JAX package's ``am-*`` rings or its suites' leak checks.

Worker-import discipline: this module is imported by the worker process
(`parallel/workers.py`), so it is stdlib-only and touches no controller
state, no metrics registry and no jax — callers on both sides do their
own metering. Payload encoding in here is ``struct``, never pickle, so
bulk column payloads do not regrow a pickle dependency on this path; the
frames are byte-for-byte the JAX package's (tests/test_torch_mesh_shm.py).

This is the port's own copy of the JAX package's ``parallel/shm.py``
(stdlib-only): no torch, and no jax.
"""
# amlint: mesh-data-plane
from __future__ import annotations

import os
import secrets
import struct
import time
from multiprocessing import shared_memory

from ..errors import DecodeError, DeviceFaultError

__all__ = [
    "SlotRef",
    "ColumnRing",
    "RingStall",
    "shm_available",
    "create_ring",
    "attach_ring",
    "encode_columns",
    "decode_columns",
    "encode_result",
    "decode_result",
    "DEFAULT_SLOTS",
    "DEFAULT_SLOT_BYTES",
]

_MAGIC = 0x414D5348  # "AMSH"

#: slot states — the explicit acquire/accept/release handshake
FREE, PRODUCER_HELD, CONSUMER_HELD = 0, 1, 2

#: header layout: 3 ring words + 4 words per slot, then 64B-aligned data
_RING_WORDS = 3
_SLOT_WORDS = 4
_W_STATE, _W_GEN, _W_USED, _W_RESERVED = 0, 1, 2, 3

DEFAULT_SLOTS = 8
DEFAULT_SLOT_BYTES = 256 * 1024


class RingStall(DeviceFaultError):
    """Producer could not acquire a slot before ``timeout`` — the ring is
    full (consumer is behind). Callers catch this and take the inline
    pickle fallback; it never propagates past the transport layer."""

    kind = "device_fault"


def ring_sizes() -> tuple[int, int]:
    """(slots, slot_bytes) from env knobs, with bounds sanity."""
    slots = max(2, int(os.environ.get("AM_MESH_SHM_SLOTS", str(DEFAULT_SLOTS))))
    slot_bytes = max(
        4096, int(os.environ.get("AM_MESH_SHM_SLOT_BYTES", str(DEFAULT_SLOT_BYTES)))
    )
    return slots, slot_bytes


_AVAILABLE: bool | None = None


def shm_available() -> bool:
    """True when POSIX shared memory actually works on this host (probed
    once with a tiny create/attach/unlink round trip, then cached)."""
    global _AVAILABLE
    if _AVAILABLE is None:
        try:
            seg = shared_memory.SharedMemory(create=True, size=4096)
            try:
                seg.buf[0] = 7
                # attach-side register is a dedup no-op in the tracker's
                # name set — creator and attacher are the same process
                peer = shared_memory.SharedMemory(name=seg.name)
                ok = peer.buf[0] == 7
                peer.close()
            finally:
                seg.close()
                seg.unlink()
            _AVAILABLE = bool(ok)
        except (OSError, ValueError, FileNotFoundError):
            _AVAILABLE = False
    return _AVAILABLE


def ring_name(tag: str) -> str:
    """A fresh, collision-safe segment name (``amt-<pid>-<nonce>-<tag>``:
    the prefix keeps the port's segments out of ``/dev/shm/am-*``)."""
    return f"amt-{os.getpid()}-{secrets.token_hex(4)}-{tag}"


class SlotRef:
    """Picklable control-frame handle to one published slot: what crosses
    the pipe instead of the payload. All fields are plain ``int`` at
    construction so flight events and JSONL dumps never see np.int64."""

    __slots__ = ("slot", "generation", "nbytes")

    def __init__(self, slot, generation, nbytes):
        self.slot = int(slot)
        self.generation = int(generation)
        self.nbytes = int(nbytes)

    def __getstate__(self):
        return (self.slot, self.generation, self.nbytes)

    def __setstate__(self, state):
        self.slot, self.generation, self.nbytes = state

    def __repr__(self):
        return (
            f"SlotRef(slot={self.slot}, generation={self.generation}, "
            f"nbytes={self.nbytes})"
        )


class ColumnRing:
    """One bounded SPSC ring over one shared-memory segment.

    Exactly one process produces (``acquire``/``publish``) and exactly one
    consumes (``accept``/``release``); the mesh runs one send ring and one
    result ring per shard, so each ring has a fixed producer and consumer.
    The creating side owns the segment lifetime (``unlink``); attachers
    only map it.
    """

    def __init__(self, seg: shared_memory.SharedMemory, nslots: int,
                 slot_bytes: int, owner: bool):
        self._seg = seg
        self.nslots = int(nslots)
        self.slot_bytes = int(slot_bytes)
        self.owner = owner
        self.closed = False
        self.stalls = 0  # producer-side acquire waits (caller meters)
        header_words = _RING_WORDS + _SLOT_WORDS * self.nslots
        self._data_off = ((header_words * 8 + 63) // 64) * 64

    # -- construction -------------------------------------------------- #

    @classmethod
    def create(cls, tag: str, nslots: int, slot_bytes: int) -> "ColumnRing":
        header_words = _RING_WORDS + _SLOT_WORDS * nslots
        data_off = ((header_words * 8 + 63) // 64) * 64
        size = data_off + nslots * slot_bytes
        seg = shared_memory.SharedMemory(
            name=ring_name(tag), create=True, size=size
        )
        ring = cls(seg, nslots, slot_bytes, owner=True)
        hdr = ring._header()
        hdr[0] = _MAGIC
        hdr[1] = nslots
        hdr[2] = slot_bytes
        for s in range(nslots):
            base = _RING_WORDS + _SLOT_WORDS * s
            hdr[base + _W_STATE] = FREE
            hdr[base + _W_GEN] = 0
            hdr[base + _W_USED] = 0
            hdr[base + _W_RESERVED] = 0
        return ring

    @classmethod
    def attach(cls, name: str) -> "ColumnRing":
        # Attaching registers the name with the resource_tracker (a 3.10
        # stdlib wart) — but mesh workers are POSIX-spawn children, which
        # inherit the controller's tracker fd, so the register is a set
        # dedup no-op and the owner's unlink unregisters exactly once.
        # Un-registering here instead would clobber the owner's entry in
        # the shared set and make that unlink a tracker KeyError.
        seg = shared_memory.SharedMemory(name=name)
        hdr = seg.buf.cast("q")
        magic, nslots, slot_bytes = hdr[0], hdr[1], hdr[2]
        del hdr
        if magic != _MAGIC:
            seg.close()
            raise DecodeError(f"shm segment {name!r} is not a column ring")
        return cls(seg, nslots, slot_bytes, owner=False)

    @property
    def name(self) -> str:
        return self._seg.name

    def _header(self):
        return self._seg.buf.cast("q")

    def _slot_base(self, slot: int) -> int:
        return _RING_WORDS + _SLOT_WORDS * slot

    # -- producer side ------------------------------------------------- #

    def acquire(self, timeout: float = 0.5,
                poll_s: float = 0.0005) -> tuple[int, int]:
        """Claims a FREE slot, bumping its generation: returns
        ``(slot, generation)``. Waits up to ``timeout`` for the consumer
        to free one (counted in ``self.stalls``), then raises
        :class:`RingStall` so the caller can fall back inline."""
        hdr = self._header()
        try:
            deadline = None
            stalled = False
            while True:
                for s in range(self.nslots):
                    base = self._slot_base(s)
                    if hdr[base + _W_STATE] == FREE:
                        gen = int(hdr[base + _W_GEN]) + 1
                        hdr[base + _W_GEN] = gen
                        hdr[base + _W_USED] = 0
                        hdr[base + _W_STATE] = PRODUCER_HELD
                        return s, gen
                if deadline is None:
                    deadline = time.monotonic() + timeout
                if not stalled:
                    stalled = True
                    self.stalls += 1
                if time.monotonic() >= deadline:
                    raise RingStall(
                        f"ring {self.name}: no free slot after {timeout}s "
                        f"({self.nslots} slots, consumer behind)"
                    )
                time.sleep(poll_s)
        finally:
            del hdr

    def slot_view(self, slot: int) -> memoryview:
        """The writable data region of one slot (full capacity)."""
        off = self._data_off + slot * self.slot_bytes
        return self._seg.buf[off:off + self.slot_bytes]

    def publish(self, slot: int, generation: int, nbytes: int) -> SlotRef:
        """Seals an acquired slot at ``nbytes`` and returns the control
        frame to ship over the pipe."""
        hdr = self._header()
        try:
            base = self._slot_base(slot)
            hdr[base + _W_USED] = nbytes
        finally:
            del hdr
        return SlotRef(slot, generation, nbytes)

    def abandon(self, slot: int) -> None:
        """Producer backs out of an acquired slot (e.g. payload turned
        out oversize): straight back to FREE, generation already burned."""
        hdr = self._header()
        try:
            hdr[self._slot_base(slot) + _W_STATE] = FREE
        finally:
            del hdr

    # -- consumer side ------------------------------------------------- #

    def accept(self, ref: SlotRef) -> memoryview:
        """Validates a control frame against the header (held by the
        producer, generation matches — a stale ref from before a crash
        reclaim refuses here) and takes consumer ownership. Returns a
        view of the published bytes; pair with :meth:`release`."""
        if ref.slot < 0 or ref.slot >= self.nslots:
            raise DecodeError(f"ring {self.name}: slot {ref.slot} out of range")
        hdr = self._header()
        try:
            base = self._slot_base(ref.slot)
            state = int(hdr[base + _W_STATE])
            gen = int(hdr[base + _W_GEN])
            used = int(hdr[base + _W_USED])
            if state != PRODUCER_HELD or gen != ref.generation:
                raise DeviceFaultError(
                    f"ring {self.name}: stale slot ref (slot {ref.slot} "
                    f"state={state} gen={gen}, ref gen={ref.generation})"
                )
            if used != ref.nbytes or used > self.slot_bytes:
                raise DecodeError(
                    f"ring {self.name}: slot {ref.slot} length mismatch "
                    f"(header {used}, ref {ref.nbytes})"
                )
            hdr[base + _W_STATE] = CONSUMER_HELD
        finally:
            del hdr
        off = self._data_off + ref.slot * self.slot_bytes
        return self._seg.buf[off:off + used]

    def release(self, slot: int) -> None:
        """Consumer is done with the payload: slot returns to FREE."""
        if self.closed:
            return
        hdr = self._header()
        try:
            hdr[self._slot_base(slot) + _W_STATE] = FREE
        finally:
            del hdr

    # -- supervision --------------------------------------------------- #

    def reclaim(self, held_by_producer_only: bool = False) -> int:
        """Frees slots after a peer crash; returns how many. With
        ``held_by_producer_only`` (the result ring after a worker crash)
        only PRODUCER_HELD slots free — CONSUMER_HELD ones belong to live
        controller-side lazy patches and stay valid across the respawn."""
        freed = 0
        hdr = self._header()
        try:
            for s in range(self.nslots):
                base = self._slot_base(s)
                state = hdr[base + _W_STATE]
                if state == FREE:
                    continue
                if held_by_producer_only and state == CONSUMER_HELD:
                    continue
                hdr[base + _W_STATE] = FREE
                freed += 1
        finally:
            del hdr
        return freed

    def slots_in_use(self) -> int:
        hdr = self._header()
        try:
            return sum(
                1 for s in range(self.nslots)
                if hdr[self._slot_base(s) + _W_STATE] != FREE
            )
        finally:
            del hdr

    def close(self, unlink: bool | None = None) -> None:
        """Drops the mapping; the owning side also unlinks the segment so
        nothing is left behind in /dev/shm."""
        if self.closed:
            return
        self.closed = True
        try:
            self._seg.close()
        except BufferError:
            return  # an exported view still pins the mapping; owner retries
        if unlink if unlink is not None else self.owner:
            try:
                self._seg.unlink()
            except FileNotFoundError:
                pass


def create_ring(tag: str) -> ColumnRing:
    slots, slot_bytes = ring_sizes()
    return ColumnRing.create(tag, slots, slot_bytes)


def attach_ring(name: str) -> ColumnRing:
    return ColumnRing.attach(name)


# ---------------------------------------------------------------------- #
# payload codecs — struct, never pickle (AM504): the column batches are
# flat bytes already, so framing is counts + lengths + raw concatenation.

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def measure_columns(groups) -> int:
    """Encoded size of one ``[(local_doc, (change_buf, ...)), ...]``
    delivery batch — checked against slot capacity before acquiring."""
    n = 8  # group count
    for _loc, bufs in groups:
        n += 16 + 8 * len(bufs)  # loc + nbufs + per-buffer lengths
        for b in bufs:
            n += len(b)
    return n


def encode_columns_into(view: memoryview, groups) -> int:
    """Writes the batch straight into a mapped slot; returns bytes used."""
    _U64.pack_into(view, 0, len(groups))
    off = 8
    for loc, bufs in groups:
        _U64.pack_into(view, off, loc)
        _U64.pack_into(view, off + 8, len(bufs))
        off += 16
        for b in bufs:
            _U64.pack_into(view, off, len(b))
            off += 8
        for b in bufs:
            view[off:off + len(b)] = b
            off += len(b)
    return off


def encode_columns(groups) -> bytes:
    buf = bytearray(measure_columns(groups))
    encode_columns_into(memoryview(buf), groups)
    return bytes(buf)


def decode_columns(view) -> list:
    """Inverse of :func:`encode_columns_into`; copies the buffers out of
    the slot (the slot is released right after, the farm keeps bytes)."""
    view = memoryview(view)
    (ngroups,) = _U64.unpack_from(view, 0)
    off = 8
    groups = []
    for _ in range(ngroups):
        loc, nbufs = _U64.unpack_from(view, off)[0], _U64.unpack_from(view, off + 8)[0]
        off += 16
        lengths = [_U64.unpack_from(view, off + 8 * i)[0] for i in range(nbufs)]
        off += 8 * nbufs
        bufs = []
        for ln in lengths:
            bufs.append(bytes(view[off:off + ln]))
            off += ln
        groups.append((int(loc), tuple(bufs)))
    return groups


# result frame: u64 patch-blob length | patch blob | u32 outcome count |
# outcome records. Outcomes are the farm's 5-tuple wire form
# ``(status, exc_blob, error_kind, offending_hashes, fallback)``,
# struct-framed with a flags byte (the overwhelmingly common
# ``("applied", None, None, (), False)`` costs 8 bytes).

_F_FALLBACK, _F_BLOB, _F_KIND = 1, 2, 4


def _put_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += _U32.pack(len(b))
    out += b


def _get_str(view, off: int) -> tuple[str, int]:
    (n,) = _U32.unpack_from(view, off)
    off += 4
    return str(view[off:off + n], "utf-8"), off + n


def encode_result(patches_blob: bytes, outcome_wires) -> bytes:
    out = bytearray(_U64.pack(len(patches_blob)))
    out += patches_blob
    out += _U32.pack(len(outcome_wires))
    for status, blob, kind, offending, fallback in outcome_wires:
        flags = (_F_FALLBACK if fallback else 0) \
            | (_F_BLOB if blob is not None else 0) \
            | (_F_KIND if kind is not None else 0)
        out.append(flags)
        _put_str(out, status)
        if blob is not None:
            out += _U64.pack(len(blob))
            out += blob
        if kind is not None:
            _put_str(out, kind)
        out += _U32.pack(len(offending))
        for h in offending:
            hb = h.encode("utf-8") if isinstance(h, str) else bytes(h)
            out.append(0 if isinstance(h, str) else 1)
            out += _U32.pack(len(hb))
            out += hb
    return bytes(out)


def decode_result(view) -> tuple[tuple[int, int], list]:
    """Returns ``((patches_off, patches_len), outcome_wires)`` — the
    patch blob is described by offsets, not copied, so the caller can
    hold the slot and unpickle straight from the mapped segment."""
    view = memoryview(view)
    (blob_len,) = _U64.unpack_from(view, 0)
    patches = (8, int(blob_len))
    off = 8 + int(blob_len)
    (count,) = _U32.unpack_from(view, off)
    off += 4
    wires = []
    for _ in range(count):
        flags = view[off]
        off += 1
        status, off = _get_str(view, off)
        blob = None
        if flags & _F_BLOB:
            (n,) = _U64.unpack_from(view, off)
            off += 8
            blob = bytes(view[off:off + n])
            off += n
        kind = None
        if flags & _F_KIND:
            kind, off = _get_str(view, off)
        (noff,) = _U32.unpack_from(view, off)
        off += 4
        offending = []
        for _h in range(noff):
            tag = view[off]
            off += 1
            (n,) = _U32.unpack_from(view, off)
            off += 4
            raw = bytes(view[off:off + n])
            off += n
            offending.append(str(raw, "utf-8") if tag == 0 else raw)
        wires.append((status, blob, kind, tuple(offending),
                      bool(flags & _F_FALLBACK)))
    return patches, wires

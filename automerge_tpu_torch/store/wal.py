"""amstore — crash-consistent write-ahead persistence for the doc farm.

One ``ShardStore`` owns one directory and makes a single guarantee:
**acked ⇒ durable**. `TorchDocFarm.apply_changes` appends every committed
change to the active write-ahead segment and runs a group-commit fsync
barrier *before* the patches are returned, so any crash after an ack can
be replayed from disk, and any crash before one loses at most work the
caller never saw acknowledged.

Directory layout::

    MANIFEST.json       compaction state, committed via atomic_write:
                        {"generation", "cold": [...], "compacted_through"}
    wal-00000003.open   the active segment (append + group-commit fsync)
    wal-00000002.seg    sealed segments (footer frame, then atomic rename)
    cold-g0002-000.seg  compacted doc-grouped chunks (generation g)
    quarantine.json     farm quarantine sidecar (causes + failure counts)
    corrupt/            checksum-corrupt segments, moved aside for forensics

Frame format (all segment files): ``u32le length | sha256(payload) |
payload`` where payload is ``u8 record_type | body``. Commit records
(type 1) carry ``uleb(doc) uleb(n) n×(uleb(len) change-bytes)`` —
reference-format binary changes, stored verbatim so persisted chunks stay
bit-compatible with the save/load corpus. Chunk records (type 3, written
by compaction) use the same body for a document's whole committed
history. A footer (type 2, JSON) seals a segment with its record count
and per-doc change-hash lists — the recovery path verifies the rebuilt
hash graph against these.

Recovery policy (``ShardStore`` open):

- a short/torn frame at the tail of the *active* segment is the signature
  of a crash mid-append: the tail is truncated at the last whole frame
  (``StoreTornWriteError`` is recorded, not raised) and appending resumes;
- a checksum-mismatched *complete* frame, or a sealed segment without a
  valid footer, is real corruption: the whole segment moves to
  ``corrupt/`` and every document it covers is handed to the farm
  quarantine with a ``StoreCorruptError`` cause — repairable via sync
  redelivery, never fatal to the open;
- compaction is two-generation: the new cold chunk is written and
  verified (decoded back from disk, hash graph compared against the
  source footers) before ``MANIFEST.json`` atomically swaps generations
  and the sources are deleted, so a crash at any stage leaves exactly one
  generation fully live; orphans of the losing generation are swept on
  the next open.

Durability knobs (``StoreConfig``): ``group_commit=N`` fsyncs every N-th
commit barrier instead of every one — acks inside the window survive a
process crash (the bytes are flushed) but ride the OS cache against power
loss; ``segment_bytes`` bounds the active segment before rotation;
``auto_compact_segments`` triggers compaction once that many sealed
segments accumulate; ``fsync=False`` drops to flush-only for tests.

Failure points (testing/faults.py): ``store.append`` before a frame is
written, ``store.fsync`` inside the seam, ``store.rotate`` at the
footer/rename stages, ``store.compact`` at write/verify/swap/cleanup.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from hashlib import sha256

from ..columnar import decode_change_meta_cached
from ..errors import StoreCorruptError, StoreTornWriteError
from ..obs.flight import get_flight
from ..obs.metrics import get_metrics
from ..testing.faults import fire
from .atomic import atomic_write, fsync_dir, fsync_file

_METRICS = get_metrics()
_M_APPEND_RECORDS = _METRICS.counter(
    "store.append.records", "commit records appended to the write-ahead log"
)
_M_APPEND_BYTES = _METRICS.counter(
    "store.append.bytes", "framed bytes appended to the write-ahead log"
)
_M_FSYNC = _METRICS.counter(
    "store.fsyncs", "group-commit fsync barriers reaching the kernel"
)
_M_ROTATIONS = _METRICS.counter(
    "store.rotations", "active segments sealed and atomically renamed"
)
_M_SEALED = _METRICS.gauge(
    "store.segments.sealed", "sealed write-ahead segments awaiting compaction"
)
_M_COMPACTIONS = _METRICS.counter(
    "store.compactions", "WAL-to-cold compaction passes committed"
)
_M_FOLDED = _METRICS.counter(
    "store.compact.folded_records",
    "commit records folded into cold chunks by compaction",
)
_M_REC_RECORDS = _METRICS.counter(
    "store.recover.records", "commit/chunk records replayed on open"
)
_M_REC_TORN = _METRICS.counter(
    "store.recover.torn_bytes", "bytes truncated from torn segment tails on open"
)
_M_REC_CORRUPT = _METRICS.counter(
    "store.recover.corrupt_segments",
    "checksum-corrupt segments quarantined on open",
)
_FLIGHT = get_flight()

_MAGIC = b"AMST"
_HEADER = _MAGIC + bytes([1])  # magic + format version
_DIGEST_LEN = 32
_LEN_FMT = struct.Struct("<I")

_REC_COMMIT = 1
_REC_FOOTER = 2
_REC_CHUNK = 3

_WAL_RE = re.compile(r"^wal-(\d{8})\.(seg|open)$")
_COLD_RE = re.compile(r"^cold-g(\d{4})-(\d{3})\.seg$")

MANIFEST_NAME = "MANIFEST.json"
QUARANTINE_NAME = "quarantine.json"
CORRUPT_DIR = "corrupt"


@dataclasses.dataclass
class StoreConfig:
    """Durability/maintenance knobs for one shard store (see module doc)."""

    group_commit: int = 1
    segment_bytes: int = 1 << 20
    auto_compact_segments: int = 0
    fsync: bool = True


@dataclasses.dataclass
class RecoveryReport:
    """What one ``ShardStore`` open found and did (also on ``store.report``)."""

    segments: int = 0
    records: int = 0
    changes: int = 0
    torn_bytes: int = 0
    sealed_on_open: int = 0
    corrupt_segments: list = dataclasses.field(default_factory=list)
    corrupt_docs: dict = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not (self.torn_bytes or self.corrupt_segments or self.corrupt_docs)


def _uleb(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_uleb(data: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(data):
            raise StoreCorruptError("truncated varint inside a store record")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _frame(payload: bytes) -> bytes:
    return _LEN_FMT.pack(len(payload)) + sha256(payload).digest() + payload


def _record_body(rec_type: int, doc: int, buffers) -> bytes:
    body = bytearray((rec_type,))
    body += _uleb(doc)
    body += _uleb(len(buffers))
    for buf in buffers:
        raw = bytes(buf)
        body += _uleb(len(raw))
        body += raw
    return bytes(body)


def _parse_record_body(body: bytes) -> tuple[int, list[bytes]]:
    doc, pos = _read_uleb(body, 1)
    count, pos = _read_uleb(body, pos)
    buffers = []
    for _ in range(count):
        length, pos = _read_uleb(body, pos)
        if pos + length > len(body):
            raise StoreCorruptError("store record buffer overruns its frame")
        buffers.append(body[pos:pos + length])
        pos += length
    return doc, buffers


@dataclasses.dataclass
class _SegScan:
    """One segment file, parsed with the recovery policy applied lazily."""

    records: list = dataclasses.field(default_factory=list)  # (doc, [bytes])
    footer: dict | None = None
    torn_offset: int | None = None  # file offset of the first torn frame
    corrupt: bool = False
    error: str = ""
    docs: set = dataclasses.field(default_factory=set)


def _scan_segment(data: bytes) -> _SegScan:
    """Walks every frame of a segment image. Never raises: torn tails and
    checksum damage are reported on the scan so the caller can pick the
    truncate-vs-quarantine policy (active vs sealed)."""
    scan = _SegScan()
    if not data.startswith(_HEADER):
        if _HEADER.startswith(data):  # crash mid-header: a torn, empty segment
            scan.torn_offset = 0
            return scan
        scan.corrupt = True
        scan.error = "bad segment magic/version"
        return scan
    pos = len(_HEADER)
    while pos < len(data):
        head_end = pos + _LEN_FMT.size + _DIGEST_LEN
        if head_end > len(data):
            scan.torn_offset = pos
            return scan
        (length,) = _LEN_FMT.unpack_from(data, pos)
        payload_end = head_end + length
        if payload_end > len(data):
            scan.torn_offset = pos
            return scan
        digest = data[pos + _LEN_FMT.size:head_end]
        payload = data[head_end:payload_end]
        pos = payload_end
        if sha256(payload).digest() != digest:
            scan.corrupt = True
            scan.error = scan.error or "frame checksum mismatch"
            continue  # framing is self-delimiting: keep walking for coverage
        if not payload:
            scan.corrupt = True
            scan.error = scan.error or "empty frame payload"
            continue
        rec_type = payload[0]
        if rec_type == _REC_FOOTER:
            try:
                scan.footer = json.loads(payload[1:].decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                scan.corrupt = True
                scan.error = scan.error or "unparseable segment footer"
            continue
        if rec_type not in (_REC_COMMIT, _REC_CHUNK):
            scan.corrupt = True
            scan.error = scan.error or f"unknown record type {rec_type}"
            continue
        try:
            doc, buffers = _parse_record_body(payload)
        except StoreCorruptError as exc:
            scan.corrupt = True
            scan.error = scan.error or str(exc)
            continue
        scan.records.append((doc, buffers))
        scan.docs.add(doc)
    if scan.footer is not None:
        for key in scan.footer.get("docs", {}):
            try:
                scan.docs.add(int(key))
            except ValueError:
                pass
        if scan.footer.get("records") != len(scan.records):
            scan.corrupt = True
            scan.error = scan.error or "footer record count disagrees with body"
    return scan


def _footer_frame(records: int, hashes: dict[int, list[str]]) -> bytes:
    payload = bytes((_REC_FOOTER,)) + json.dumps(
        {"records": records, "docs": {str(d): h for d, h in sorted(hashes.items())}},
        sort_keys=True,
    ).encode("utf-8")
    return _frame(payload)


class ShardStore:
    """One shard's crash-consistent change store (see the module doc).

    Opening the store *is* recovery: the constructor sweeps compaction
    orphans, replays every live segment with the torn-tail/corruption
    policy, and leaves the store appendable. The replayed history is on
    ``recovered_commits()`` (per-doc ordered change buffers) for the
    hydration layer; ``corrupt_docs`` and ``report`` describe the damage.
    """

    def __init__(self, root, config: StoreConfig | None = None):
        self.root = os.fspath(root)
        self.config = config or StoreConfig()
        if self.config.group_commit < 1:
            raise ValueError("group_commit must be >= 1")
        self.report = RecoveryReport()
        self.corrupt_docs: dict[int, StoreCorruptError] = {}
        #: per-doc ordered change-hash lists from sealed/cold footers — the
        #: hydration layer verifies the rebuilt hash graph against these
        self.footer_hashes: dict[int, list[str]] = {}
        self._recovered: dict[int, list[bytes]] = {}
        self._manifest = {"generation": 0, "cold": [], "compacted_through": 0}
        self._fh = None
        self._active_seq = 0
        self._active_path = ""
        self._active_size = 0
        self._active_records = 0
        self._active_hashes: dict[int, list[str]] = {}
        self._unsynced = False
        self._since_fsync = 0
        self._q_sig: str | None = None
        self._open()

    # ------------------------------------------------------------------ #
    # naming

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    @staticmethod
    def _wal_name(seq: int, sealed: bool) -> str:
        return f"wal-{seq:08d}.{'seg' if sealed else 'open'}"

    def _sealed_paths(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            m = _WAL_RE.match(name)
            if m and m.group(2) == "seg":
                seq = int(m.group(1))
                if seq > self._manifest["compacted_through"]:
                    out.append((seq, self._path(name)))
        out.sort()
        return out

    # ------------------------------------------------------------------ #
    # open-time recovery

    def _open(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        self._load_manifest()
        self._sweep_orphans()
        for name in self._manifest["cold"]:
            self._recover_file(self._path(name), sealed=True)
        wal_sealed, wal_open = [], []
        for name in os.listdir(self.root):
            m = _WAL_RE.match(name)
            if not m:
                continue
            seq = int(m.group(1))
            if seq <= self._manifest["compacted_through"]:
                continue
            (wal_sealed if m.group(2) == "seg" else wal_open).append((seq, name))
        for seq, name in sorted(wal_sealed):
            self._recover_file(self._path(name), sealed=True)
        survivor = None  # (seq, path, scan) of the .open segment to resume
        for seq, name in sorted(wal_open):
            result = self._recover_file(self._path(name), sealed=False)
            if result is not None:
                if survivor is not None:
                    # two live .open files cannot happen in one process
                    # lifetime; seal the older so the order stays on disk
                    self._seal_recovered(*survivor)
                survivor = (seq, self._path(name), result)
        _M_REC_RECORDS.inc(self.report.records)
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "store.recovered", root=self.root,
                segments=self.report.segments, records=self.report.records,
                docs=len(self._recovered),
                corrupt_segments=len(self.report.corrupt_segments),
            )
        if survivor is not None:
            seq, path, scan = survivor
            self._resume_active(seq, path, scan)
        else:
            top = max(
                [s for s, _ in wal_sealed + wal_open] or
                [self._manifest["compacted_through"]]
            )
            self._start_active(top + 1)
        self._q_sig = self._read_quarantine_raw()
        _M_SEALED.set(len(self._sealed_paths()))

    def _load_manifest(self) -> None:
        path = self._path(MANIFEST_NAME)
        if not os.path.exists(path):
            return
        try:
            with open(path, "rb") as fh:
                manifest = json.loads(fh.read().decode("utf-8"))
            self._manifest = {
                "generation": int(manifest["generation"]),
                "cold": list(manifest["cold"]),
                "compacted_through": int(manifest["compacted_through"]),
            }
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as exc:
            # The manifest is tiny and always atomic_write-replaced; damage
            # here means the store root itself is rotten, not one segment.
            raise StoreCorruptError(
                f"unreadable store manifest {path}: {exc}"
            ) from exc

    def _sweep_orphans(self) -> None:
        """Removes the losing generation of a crashed compaction: cold files
        the manifest does not own, folded WAL segments the manifest says are
        compacted, and stale atomic-write temps."""
        live_cold = set(self._manifest["cold"])
        for name in os.listdir(self.root):
            path = self._path(name)
            if ".tmp." in name:
                os.unlink(path)
                continue
            if _COLD_RE.match(name) and name not in live_cold:
                os.unlink(path)
                continue
            m = _WAL_RE.match(name)
            if m and int(m.group(1)) <= self._manifest["compacted_through"]:
                os.unlink(path)

    def _recover_file(self, path: str, sealed: bool):
        """Replays one segment. Returns the scan for a surviving ``.open``
        segment (so the caller can resume appending to it), else None."""
        with open(path, "rb") as fh:
            data = fh.read()
        scan = _scan_segment(data)
        self.report.segments += 1
        if sealed and not scan.corrupt and (
            scan.torn_offset is not None or scan.footer is None
        ):
            # sealing is atomic (footer + rename): a sealed segment that is
            # short or footer-less was damaged after the fact
            scan.corrupt = True
            scan.error = scan.error or "sealed segment has no valid footer"
        if scan.corrupt:
            self._quarantine_segment(path, scan)
            return None
        if scan.torn_offset is not None:
            dropped = len(data) - scan.torn_offset
            self.report.torn_bytes += dropped
            _M_REC_TORN.inc(dropped)
            if _FLIGHT.enabled:
                _FLIGHT.record(
                    "store.torn_write", seg=os.path.basename(path),
                    offset=scan.torn_offset, dropped_bytes=dropped,
                    error=str(StoreTornWriteError("torn frame at segment tail")),
                )
            os.truncate(path, scan.torn_offset)
        for doc, buffers in scan.records:
            self._recovered.setdefault(doc, []).extend(buffers)
            self.report.records += 1
            self.report.changes += len(buffers)
        if scan.footer is not None:
            for key, hashes in scan.footer.get("docs", {}).items():
                self.footer_hashes.setdefault(int(key), []).extend(hashes)
        return None if sealed else scan

    def _quarantine_segment(self, path: str, scan: _SegScan) -> None:
        corrupt_dir = self._path(CORRUPT_DIR)
        os.makedirs(corrupt_dir, exist_ok=True)
        name = os.path.basename(path)
        os.replace(path, os.path.join(corrupt_dir, name))
        self.report.corrupt_segments.append(name)
        _M_REC_CORRUPT.inc()
        for doc in sorted(scan.docs):
            exc = StoreCorruptError(
                f"segment {name} failed verification ({scan.error}); "
                f"doc {doc}'s tail is unrecoverable from this store — "
                "repair via sync redelivery"
            )
            self.corrupt_docs[doc] = exc
            self.report.corrupt_docs[doc] = exc
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "store.segment.corrupt", seg=name, error=scan.error,
                docs=sorted(scan.docs),
            )
            _FLIGHT.trigger("store.corrupt", seg=name)

    def _seal_recovered(self, seq: int, path: str, scan: _SegScan) -> None:
        """Finishes a rotation a crash interrupted: appends the footer to a
        recovered ``.open`` segment and renames it sealed."""
        hashes: dict[int, list[str]] = {}
        for doc, buffers in scan.records:
            hashes.setdefault(doc, []).extend(
                decode_change_meta_cached(buf)["hash"] for buf in buffers
            )
        # amlint: disable=AM601 — checksummed-frame append; sealing commits via rename
        with open(path, "ab") as fh:
            fh.write(_footer_frame(len(scan.records), hashes))
            if self.config.fsync:
                fsync_file(fh)
        os.replace(path, self._path(self._wal_name(seq, sealed=True)))
        if self.config.fsync:
            fsync_dir(self.root)
        for doc, doc_hashes in hashes.items():
            self.footer_hashes.setdefault(doc, []).extend(doc_hashes)
        self.report.sealed_on_open += 1

    def _resume_active(self, seq: int, path: str, scan: _SegScan) -> None:
        self._active_seq = seq
        self._active_path = path
        if scan.footer is not None:
            # the crash hit between footer-write and rename: finish it
            self._seal_recovered(seq, path, scan)
            self._start_active(seq + 1)
            return
        self._active_records = len(scan.records)
        self._active_hashes = {}
        for doc, buffers in scan.records:
            self._active_hashes.setdefault(doc, []).extend(
                decode_change_meta_cached(buf)["hash"] for buf in buffers
            )
        # amlint: disable=AM601 — the WAL's checksummed append handle itself
        self._fh = open(path, "ab")
        self._active_size = os.path.getsize(path)
        if self._active_size < len(_HEADER):
            # the torn tail ate into the header itself: start the image over
            self._fh.write(_HEADER[self._active_size:])
            self._active_size = len(_HEADER)

    def _start_active(self, seq: int) -> None:
        self._active_seq = seq
        self._active_path = self._path(self._wal_name(seq, sealed=False))
        # amlint: disable=AM601 — the WAL's checksummed append handle itself
        self._fh = open(self._active_path, "wb")
        self._fh.write(_HEADER)
        self._active_size = len(_HEADER)
        self._active_records = 0
        self._active_hashes = {}

    # ------------------------------------------------------------------ #
    # hydration hand-off

    def recovered_commits(self) -> dict[int, list[bytes]]:
        """Per-doc committed change buffers replayed on open, in commit
        order (cold generation first, then WAL segments by sequence)."""
        return self._recovered

    def drop_recovered(self) -> None:
        """Releases the replayed buffers once hydration has applied them."""
        self._recovered = {}

    # ------------------------------------------------------------------ #
    # the write path

    def append_commit(self, doc: int, buffers) -> None:
        """Appends one committed delivery for one doc (called by the farm
        before the delivery is acked; ``commit_barrier`` makes it durable)."""
        if not buffers:
            return
        fire("store.append", doc=doc)
        # hash (and thereby structurally validate) the buffers *before* the
        # write: an unencodable buffer must never reach a committed frame
        hashes = [decode_change_meta_cached(buf)["hash"] for buf in buffers]
        frame = _frame(_record_body(_REC_COMMIT, doc, buffers))
        self._fh.write(frame)
        self._active_records += 1
        self._active_size += len(frame)
        self._unsynced = True
        self._active_hashes.setdefault(doc, []).extend(hashes)
        if _METRICS.enabled:
            _M_APPEND_RECORDS.inc()
            _M_APPEND_BYTES.inc(len(frame))

    def commit_barrier(self, quarantine: dict | None = None) -> None:
        """The ack boundary: runs the group-commit fsync policy, persists a
        changed quarantine sidecar, and triggers rotation/compaction
        housekeeping. The farm calls this once per apply, just before
        returning patches."""
        if quarantine is not None:
            self.save_quarantine(quarantine)
        if self._unsynced:
            self._since_fsync += 1
            if self._since_fsync >= self.config.group_commit:
                self._sync_active()
            else:
                self._fh.flush()
        if self._active_size >= self.config.segment_bytes and self._active_records:
            self.rotate()
        limit = self.config.auto_compact_segments
        if limit and len(self._sealed_paths()) >= limit:
            self.compact()

    def _sync_active(self) -> None:
        if self.config.fsync:
            fsync_file(self._fh)
            _M_FSYNC.inc()
        else:
            self._fh.flush()
        self._unsynced = False
        self._since_fsync = 0

    def rotate(self) -> None:
        """Seals the active segment: footer, fsync, atomic rename to
        ``.seg``, then a fresh active. Crash-safe at every step — a footer
        without the rename is finished on the next open; a torn footer is
        truncated away and the segment stays active."""
        if self._fh is None or self._active_records == 0:
            return
        name = os.path.basename(self._active_path)
        fire("store.rotate", stage="footer", seg=name)
        self._fh.write(_footer_frame(self._active_records, self._active_hashes))
        if self.config.fsync:
            fsync_file(self._fh)
            _M_FSYNC.inc()
        else:
            self._fh.flush()
        self._fh.close()
        self._fh = None
        fire("store.rotate", stage="rename", seg=name)
        sealed_path = self._path(self._wal_name(self._active_seq, sealed=True))
        os.replace(self._active_path, sealed_path)
        if self.config.fsync:
            fsync_dir(self.root)
        for doc, hashes in self._active_hashes.items():
            self.footer_hashes.setdefault(doc, []).extend(hashes)
        _M_ROTATIONS.inc()
        _M_SEALED.set(len(self._sealed_paths()))
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "store.rotate", seg=os.path.basename(sealed_path),
                records=self._active_records, bytes=self._active_size,
            )
        self._unsynced = False
        self._since_fsync = 0
        self._start_active(self._active_seq + 1)

    # ------------------------------------------------------------------ #
    # compaction

    def compact(self) -> None:
        """Folds every sealed WAL segment (plus the previous cold
        generation) into one doc-grouped cold chunk, verifies the new
        generation against the source hash graph, then atomically swaps the
        manifest and deletes the sources. A crash at any stage leaves
        exactly one generation fully live."""
        sealed = self._sealed_paths()
        if not sealed:
            return
        new_gen = self._manifest["generation"] + 1
        fire("store.compact", stage="write", generation=new_gen)
        per_doc: dict[int, list[bytes]] = {}
        expected: dict[int, list[str]] = {}
        folded_records = 0
        sources = [self._path(n) for n in self._manifest["cold"]]
        sources += [path for _, path in sealed]
        for path in sources:
            with open(path, "rb") as fh:
                scan = _scan_segment(fh.read())
            if scan.corrupt or scan.torn_offset is not None or scan.footer is None:
                raise StoreCorruptError(
                    f"compaction source {os.path.basename(path)} failed "
                    f"verification ({scan.error or 'torn/footer-less'}); "
                    "compaction aborted, both generations untouched"
                )
            for doc, buffers in scan.records:
                per_doc.setdefault(doc, []).extend(buffers)
                folded_records += 1
            for key, hashes in scan.footer.get("docs", {}).items():
                expected.setdefault(int(key), []).extend(hashes)
        image = bytearray(_HEADER)
        chunk_hashes: dict[int, list[str]] = {}
        for doc in sorted(per_doc):
            image += _frame(_record_body(_REC_CHUNK, doc, per_doc[doc]))
            chunk_hashes[doc] = [
                decode_change_meta_cached(buf)["hash"] for buf in per_doc[doc]
            ]
        image += _footer_frame(len(per_doc), chunk_hashes)
        cold_name = f"cold-g{new_gen:04d}-000.seg"
        cold_path = self._path(cold_name)
        atomic_write(cold_path, bytes(image), fsync=self.config.fsync)
        fire("store.compact", stage="verify", generation=new_gen)
        self._verify_cold(cold_path, expected)
        fire("store.compact", stage="swap", generation=new_gen)
        top_seq = max(seq for seq, _ in sealed)
        manifest = {
            "generation": new_gen,
            "cold": [cold_name],
            "compacted_through": top_seq,
        }
        atomic_write(
            self._path(MANIFEST_NAME),
            json.dumps(manifest, sort_keys=True),
            fsync=self.config.fsync,
        )
        self._manifest = manifest
        fire("store.compact", stage="cleanup", generation=new_gen)
        for path in sources:
            os.unlink(path)
        if self.config.fsync:
            fsync_dir(self.root)
        _M_COMPACTIONS.inc()
        _M_FOLDED.inc(folded_records)
        _M_SEALED.set(0)
        if _FLIGHT.enabled:
            _FLIGHT.record(
                "store.compact", generation=new_gen,
                segments=len(sources), records=folded_records,
                docs=len(per_doc), bytes=len(image),
            )

    def _verify_cold(self, path: str, expected: dict[int, list[str]]) -> None:
        """Hash-graph verification of a freshly written cold chunk, read
        back from disk: every source change hash must survive, in order,
        before the sources may be deleted."""
        with open(path, "rb") as fh:
            scan = _scan_segment(fh.read())
        actual: dict[int, list[str]] = {}
        if not (scan.corrupt or scan.torn_offset is not None or scan.footer is None):
            for doc, buffers in scan.records:
                actual.setdefault(doc, []).extend(
                    decode_change_meta_cached(buf)["hash"] for buf in buffers
                )
        if scan.corrupt or scan.torn_offset is not None or scan.footer is None \
                or actual != expected:
            os.unlink(path)
            raise StoreCorruptError(
                "compacted chunk failed hash-graph verification against its "
                "source footers; sources kept, new generation discarded"
            )

    # ------------------------------------------------------------------ #
    # quarantine sidecar

    def _read_quarantine_raw(self) -> str | None:
        path = self._path(QUARANTINE_NAME)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            return fh.read().decode("utf-8", errors="replace")

    def save_quarantine(self, snapshot: dict) -> None:
        """Persists the farm's quarantine sidecar (active causes + failure
        counts) when it changed since the last write."""
        sig = json.dumps(snapshot, sort_keys=True)
        if sig == self._q_sig:
            return
        atomic_write(self._path(QUARANTINE_NAME), sig, fsync=self.config.fsync)
        self._q_sig = sig

    def load_quarantine(self) -> dict | None:
        """The persisted quarantine sidecar, or None if absent/unreadable
        (the sidecar is advisory: damage degrades to an empty quarantine,
        never a failed open)."""
        raw = self._read_quarantine_raw()
        if raw is None:
            return None
        try:
            snapshot = json.loads(raw)
        except ValueError:
            return None
        return snapshot if isinstance(snapshot, dict) else None

    # ------------------------------------------------------------------ #

    def close(self) -> None:
        """Final durability barrier + handle close (idempotent)."""
        if self._fh is None:
            return
        if self._unsynced:
            self._sync_active()
        self._fh.close()
        self._fh = None

"""Data synchronisation protocol: Bloom-filter have/need change exchange.

The port's own copy of the JAX package's ``sync.py`` (reference
backend/sync.js, wire-format compatible): the Bloom filter, the sync
message codec, the persisted peer state, and the single-document loop
(``generate_sync_message`` / ``receive_sync_message``) over this package's
``backend``. The batched loop over a document farm is
``tpu/sync_farm.py``.

Based on: Martin Kleppmann and Heidi Howard, "Byzantine Eventual
Consistency and the Fundamental Limits of Peer-to-Peer Databases"
(https://arxiv.org/abs/2012.00472).
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

from math import ceil

from . import backend as Backend
from .codecs import Decoder, Encoder, bytes_to_hex, hex_to_bytes
from .columnar import decode_change_meta_cached
from .errors import AutomergeError, EncodeError, SyncProtocolError
from .obs.metrics import get_metrics
from .testing.faults import fire as _fault_point

HASH_SIZE = 32
MESSAGE_TYPE_SYNC = 0x42
PEER_STATE_TYPE = 0x43

# 1% false positive rate; the parameters are encoded in the wire format so
# they can be changed without breaking protocol compatibility (sync.js:29-31)
BITS_PER_ENTRY = 10
NUM_PROBES = 7

# sync-protocol metrics (obs/metrics.py; disabled unless a workload opts
# in). The batched farm loop (tpu/sync_farm.py) records into the SAME
# instruments — fetched by name from the process-wide registry — so
# sequential and batched sync accumulate one set of totals.
_METRICS = get_metrics()
_M_MSGS_GEN = _METRICS.counter(
    "sync.messages.generated", "sync messages encoded for peers"
)
_M_MSGS_RECV = _METRICS.counter(
    "sync.messages.received", "sync messages decoded from peers"
)
_M_BYTES_SENT = _METRICS.counter(
    "sync.bytes.sent", "wire bytes of generated sync messages"
)
_M_BYTES_RECV = _METRICS.counter(
    "sync.bytes.received", "wire bytes of received sync messages"
)
_M_CHANGES_SENT = _METRICS.counter(
    "sync.changes.sent", "changes attached to generated sync messages"
)
_M_CHANGES_RECV = _METRICS.counter(
    "sync.changes.received", "changes carried by received sync messages"
)
_M_NEED_REQUESTED = _METRICS.counter(
    "sync.changes.need_requested", "hashes peers explicitly requested via need"
)
_M_BLOOM_PROBES = _METRICS.counter(
    "sync.bloom.probes", "Bloom filter bit probes evaluated (host + device)"
)
_M_BLOOM_HITS = _METRICS.counter(
    "sync.bloom.hits", "Bloom membership tests that returned positive"
)
_M_BLOOM_FP = _METRICS.counter(
    "sync.bloom.false_positives",
    "Bloom positives contradicted by an explicit peer need (changes the "
    "filter wrongly claimed the peer already had)",
)
_M_REJECTED = _METRICS.counter(
    "sync.messages.rejected",
    "received sync messages rejected as malformed or inapplicable "
    "(SyncProtocolError; local state untouched)",
)


class BloomFilter:
    """Bloom filter over SHA-256 change hashes, serialisable for network
    transmission (sync.js:38)."""

    def __init__(self, arg):
        if isinstance(arg, list):
            self.num_entries = len(arg)
            self.num_bits_per_entry = BITS_PER_ENTRY
            self.num_probes = NUM_PROBES
            self.bits = bytearray(ceil(self.num_entries * self.num_bits_per_entry / 8))
            for h in arg:
                self.add_hash(h)
        elif isinstance(arg, (bytes, bytearray, memoryview)):
            arg = bytes(arg)
            if len(arg) == 0:
                self.num_entries = 0
                self.num_bits_per_entry = 0
                self.num_probes = 0
                self.bits = bytearray(0)
            else:
                decoder = Decoder(arg)
                self.num_entries = decoder.read_uint32()
                self.num_bits_per_entry = decoder.read_uint32()
                self.num_probes = decoder.read_uint32()
                self.bits = bytearray(
                    decoder.read_raw_bytes(ceil(self.num_entries * self.num_bits_per_entry / 8))
                )
        else:
            raise TypeError("invalid argument")  # amlint: disable=AM401 — argument-type validation

    @property
    def bytes(self) -> bytes:
        if self.num_entries == 0:
            return b""
        encoder = Encoder()
        encoder.append_uint32(self.num_entries)
        encoder.append_uint32(self.num_bits_per_entry)
        encoder.append_uint32(self.num_probes)
        encoder.append_raw_bytes(self.bits)
        return encoder.buffer

    def get_probes(self, hash_):
        """Triple-hashing probe sequence from the first 12 bytes of the hash
        (sync.js:88; Dillinger & Manolios, FMCAD 2004)."""
        hash_bytes = hex_to_bytes(hash_)
        modulo = 8 * len(self.bits)
        if len(hash_bytes) != 32:
            raise SyncProtocolError(f"Not a 256-bit hash: {hash_}")
        x = int.from_bytes(hash_bytes[0:4], "little") % modulo
        y = int.from_bytes(hash_bytes[4:8], "little") % modulo
        z = int.from_bytes(hash_bytes[8:12], "little") % modulo
        probes = [x]
        for _ in range(1, self.num_probes):
            x = (x + y) % modulo
            y = (y + z) % modulo
            probes.append(x)
        return probes

    def add_hash(self, hash_):
        for probe in self.get_probes(hash_):
            self.bits[probe >> 3] |= 1 << (probe & 7)

    def contains_hash(self, hash_):
        if self.num_entries == 0:
            return False
        probes = self.get_probes(hash_)
        for i, probe in enumerate(probes):
            if not (self.bits[probe >> 3] & (1 << (probe & 7))):
                _M_BLOOM_PROBES.inc(i + 1)
                return False
        _M_BLOOM_PROBES.inc(len(probes))
        _M_BLOOM_HITS.inc()
        return True


def _encode_hashes(encoder, hashes):
    if not isinstance(hashes, list):
        raise TypeError("hashes must be a list")  # amlint: disable=AM401 — argument-type validation
    encoder.append_uint32(len(hashes))
    for i, h in enumerate(hashes):
        if i > 0 and hashes[i - 1] >= h:
            raise EncodeError("hashes must be sorted")
        data = hex_to_bytes(h)
        if len(data) != HASH_SIZE:
            raise TypeError("heads hashes must be 256 bits")  # amlint: disable=AM401 — argument-type validation
        encoder.append_raw_bytes(data)


def _decode_hashes(decoder):
    return [bytes_to_hex(decoder.read_raw_bytes(HASH_SIZE)) for _ in range(decoder.read_uint32())]


def encode_sync_message(message) -> bytes:
    encoder = Encoder()
    encoder.append_byte(MESSAGE_TYPE_SYNC)
    _encode_hashes(encoder, message["heads"])
    _encode_hashes(encoder, message["need"])
    encoder.append_uint32(len(message["have"]))
    for have in message["have"]:
        _encode_hashes(encoder, have["lastSync"])
        encoder.append_prefixed_bytes(have["bloom"])
    encoder.append_uint32(len(message["changes"]))
    for change in message["changes"]:
        encoder.append_prefixed_bytes(change)
    return encoder.buffer


def decode_sync_message(data):
    decoder = Decoder(data)
    message_type = decoder.read_byte()
    if message_type != MESSAGE_TYPE_SYNC:
        raise SyncProtocolError(f"Unexpected message type: {message_type}")
    heads = _decode_hashes(decoder)
    need = _decode_hashes(decoder)
    have_count = decoder.read_uint32()
    message = {"heads": heads, "need": need, "have": [], "changes": []}
    for _ in range(have_count):
        last_sync = _decode_hashes(decoder)
        bloom = decoder.read_prefixed_bytes()
        message["have"].append({"lastSync": last_sync, "bloom": bloom})
    change_count = decoder.read_uint32()
    for _ in range(change_count):
        message["changes"].append(decoder.read_prefixed_bytes())
    # Trailing bytes are ignored for forward compatibility
    return message


#: version tag of the optional session-supervision extension appended after
#: sharedHeads by encode_sync_state(..., session=...). Pre-extension blobs
#: simply end after the hashes; pre-extension decoders ignore trailing
#: bytes, so the formats are compatible in both directions.
SESSION_EXT_VERSION = 1


def encode_sync_state(sync_state, session=None) -> bytes:
    """Persists the durable part of a peer state (sharedHeads only; the
    ephemeral fields are deliberately dropped, sync.js:206).

    `session`, when given, is the supervision envelope persisted by
    ``SyncSession.save()`` — ``{"epoch", "seqOut", "lastSeen",
    "peerEpoch"}`` plus the watchdog counters (``wdRounds``, ``wdStage``,
    ``wdStalls``, ``wdEscalations``, ``wdResets``) — appended as a
    versioned extension block that old decoders skip as trailing bytes.
    The watchdog fields sit AFTER the original extension fields so the
    encoding is prefix-identical to pre-watchdog blobs: old decoders stop
    after ``peerEpoch`` and ignore the tail, and blobs written before the
    watchdog fields existed decode with the counters at zero (without the
    tail a restart silently re-armed a stalled channel's escalation
    ladder from scratch)."""
    encoder = Encoder()
    encoder.append_byte(PEER_STATE_TYPE)
    _encode_hashes(encoder, sync_state["sharedHeads"])
    if session is not None:
        encoder.append_byte(SESSION_EXT_VERSION)
        encoder.append_uint32(session["epoch"])
        encoder.append_uint53(session["seqOut"])
        encoder.append_uint53(session["lastSeen"])
        peer_epoch = session.get("peerEpoch")
        encoder.append_byte(0 if peer_epoch is None else 1)
        encoder.append_uint32(peer_epoch or 0)
        encoder.append_uint32(session.get("wdRounds", 0))
        encoder.append_uint32(session.get("wdStage", 0))
        encoder.append_uint32(session.get("wdStalls", 0))
        encoder.append_uint32(session.get("wdEscalations", 0))
        encoder.append_uint32(session.get("wdResets", 0))
    return encoder.buffer


def decode_sync_state(data):
    """Restores a persisted peer state. Truncated or garbage bytes raise
    ``SyncProtocolError`` (never a raw ``IndexError``/``DecodeError``) and
    construct no partial state. A blob carrying the session extension
    yields a ``"session"`` key (consumed by ``SyncSession.restore``);
    pre-extension blobs decode exactly as before."""
    try:
        decoder = Decoder(data)
        record_type = decoder.read_byte()
        if record_type != PEER_STATE_TYPE:
            raise SyncProtocolError(f"Unexpected record type: {record_type}")
        shared_heads = _decode_hashes(decoder)
        session = None
        if not decoder.done:
            version = decoder.read_byte()
            if version != SESSION_EXT_VERSION:
                raise SyncProtocolError(
                    f"Unknown sync-state session extension version: {version}"
                )
            epoch = decoder.read_uint32()
            seq_out = decoder.read_uint53()
            last_seen = decoder.read_uint53()
            peer_known = decoder.read_byte()
            peer_epoch = decoder.read_uint32()
            session = {
                "epoch": epoch,
                "seqOut": seq_out,
                "lastSeen": last_seen,
                "peerEpoch": peer_epoch if peer_known else None,
                "wdRounds": 0,
                "wdStage": 0,
                "wdStalls": 0,
                "wdEscalations": 0,
                "wdResets": 0,
            }
            if not decoder.done:
                # watchdog/backoff tail (absent in blobs written before
                # the counters were persisted; prefix-identical)
                session["wdRounds"] = decoder.read_uint32()
                session["wdStage"] = decoder.read_uint32()
                session["wdStalls"] = decoder.read_uint32()
                session["wdEscalations"] = decoder.read_uint32()
                session["wdResets"] = decoder.read_uint32()
    except SyncProtocolError:
        raise
    except (ValueError, TypeError, IndexError) as exc:
        raise SyncProtocolError(f"malformed sync state: {exc}") from exc
    state = init_sync_state()
    state["sharedHeads"] = shared_heads
    if session is not None:
        state["session"] = session
    return state


def make_bloom_filter(backend, last_sync):
    new_changes = Backend.get_changes(backend, last_sync)
    hashes = [decode_change_meta_cached(change)["hash"] for change in new_changes]
    return {"lastSync": last_sync, "bloom": BloomFilter(hashes).bytes}


def get_changes_to_send(backend, have, need):
    """Changes to send given the peer's have/need (sync.js:246): Bloom-negative
    changes, their dependents closure, plus explicitly needed hashes."""
    _M_NEED_REQUESTED.inc(len(need))
    if not have:
        changes = [Backend.get_change_by_hash(backend, h) for h in need]
        return [c for c in changes if c is not None]

    last_sync_hashes = {}
    bloom_filters = []
    for h in have:
        for hash_ in h["lastSync"]:
            last_sync_hashes[hash_] = True
        bloom_filters.append(BloomFilter(h["bloom"]))

    changes = [
        decode_change_meta_cached(change)
        for change in Backend.get_changes(backend, list(last_sync_hashes.keys()))
    ]

    change_hashes = {}
    dependents = {}
    hashes_to_send = {}
    for change in changes:
        change_hashes[change["hash"]] = True
        for dep in change["deps"]:
            dependents.setdefault(dep, []).append(change["hash"])
        if all(not bloom.contains_hash(change["hash"]) for bloom in bloom_filters):
            hashes_to_send[change["hash"]] = True

    # Include any changes that depend on a Bloom-negative change
    stack = list(hashes_to_send.keys())
    while stack:
        hash_ = stack.pop()
        for dep in dependents.get(hash_, []):
            if dep not in hashes_to_send:
                hashes_to_send[dep] = True
                stack.append(dep)

    changes_to_send = []
    for hash_ in need:
        # a needed hash we hold but withheld as Bloom-positive is a
        # *detected* false positive: the filter claimed the peer had it
        if hash_ in change_hashes and hash_ not in hashes_to_send:
            _M_BLOOM_FP.inc()
        hashes_to_send[hash_] = True
        if hash_ not in change_hashes:
            change = Backend.get_change_by_hash(backend, hash_)
            if change is not None:
                changes_to_send.append(change)

    for change in changes:
        if change["hash"] in hashes_to_send:
            changes_to_send.append(change["change"])
    return changes_to_send


def init_sync_state():
    return {
        "sharedHeads": [],
        "lastSentHeads": [],
        "theirHeads": None,
        "theirNeed": None,
        "theirHave": None,
        "sentHashes": {},
    }


def generate_sync_message(backend, sync_state):
    """Generates the next message to send to a peer, or None if in sync
    (sync.js:327). Returns (sync_state, message_bytes_or_None)."""
    if backend is None:
        raise ValueError("generate_sync_message called with no Automerge document")  # amlint: disable=AM401 — API-usage validation
    if sync_state is None:
        raise ValueError("generate_sync_message requires a sync_state, created by init_sync_state()")  # amlint: disable=AM401 — API-usage validation

    shared_heads = sync_state["sharedHeads"]
    last_sent_heads = sync_state["lastSentHeads"]
    their_heads = sync_state["theirHeads"]
    their_need = sync_state["theirNeed"]
    their_have = sync_state["theirHave"]
    sent_hashes = sync_state["sentHashes"]
    our_heads = Backend.get_heads(backend)

    our_need = Backend.get_missing_deps(backend, their_heads or [])

    our_have = []
    if their_heads is None or all(h in their_heads for h in our_need):
        our_have = [make_bloom_filter(backend, shared_heads)]

    if their_have and len(their_have) > 0:
        last_sync = their_have[0]["lastSync"]
        if not all(Backend.get_change_by_hash(backend, h) for h in last_sync):
            reset_msg = {
                "heads": our_heads, "need": [],
                "have": [{"lastSync": [], "bloom": b""}], "changes": [],
            }
            encoded = encode_sync_message(reset_msg)
            _M_MSGS_GEN.inc()
            _M_BYTES_SENT.inc(len(encoded))
            return sync_state, encoded

    changes_to_send = (
        get_changes_to_send(backend, their_have, their_need)
        if isinstance(their_have, list) and isinstance(their_need, list)
        else []
    )

    heads_unchanged = isinstance(last_sent_heads, list) and our_heads == last_sent_heads
    heads_equal = isinstance(their_heads, list) and our_heads == their_heads
    if heads_unchanged and heads_equal and not changes_to_send:
        return sync_state, None

    changes_to_send = [
        c for c in changes_to_send if not sent_hashes.get(decode_change_meta_cached(c)["hash"])
    ]

    sync_message = {"heads": our_heads, "have": our_have, "need": our_need, "changes": changes_to_send}
    if changes_to_send:
        sent_hashes = dict(sent_hashes)
        for change in changes_to_send:
            sent_hashes[decode_change_meta_cached(change)["hash"]] = True

    sync_state = dict(sync_state, lastSentHeads=our_heads, sentHashes=sent_hashes)
    encoded = encode_sync_message(sync_message)
    _M_MSGS_GEN.inc()
    _M_BYTES_SENT.inc(len(encoded))
    _M_CHANGES_SENT.inc(len(changes_to_send))
    return sync_state, encoded


def _advance_heads(my_old_heads, my_new_heads, our_old_shared_heads):
    new_heads = [head for head in my_new_heads if head not in my_old_heads]
    common_heads = [head for head in our_old_shared_heads if head in my_new_heads]
    return sorted(set(new_heads + common_heads))


def receive_sync_message(backend, old_sync_state, binary_message):
    """Processes a received sync message; returns (backend, sync_state, patch)
    (sync.js:420)."""
    if backend is None:
        raise ValueError("receive_sync_message called with no Automerge document")  # amlint: disable=AM401 — API-usage validation
    if old_sync_state is None:
        raise ValueError("receive_sync_message requires a sync_state, created by init_sync_state()")  # amlint: disable=AM401 — API-usage validation

    shared_heads = old_sync_state["sharedHeads"]
    last_sent_heads = old_sync_state["lastSentHeads"]
    sent_hashes = old_sync_state["sentHashes"]
    patch = None
    # A malformed peer message must not poison local state: reject with
    # SyncProtocolError, leaving the backend handle usable (not frozen) and
    # the caller's sync_state object untouched. Raw decode exceptions from
    # corrupt bytes (DecodeError/ChecksumError, or an IndexError from a
    # short buffer) never propagate out of this function.
    try:
        _fault_point("sync.receive_message", message=binary_message)
        message = decode_sync_message(binary_message)
    except SyncProtocolError:
        _M_REJECTED.inc()
        raise
    except (ValueError, TypeError, IndexError) as exc:
        _M_REJECTED.inc()
        raise SyncProtocolError(f"malformed sync message: {exc}") from exc
    _M_MSGS_RECV.inc()
    _M_BYTES_RECV.inc(len(binary_message))
    _M_CHANGES_RECV.inc(len(message["changes"]))
    before_heads = Backend.get_heads(backend)

    if message["changes"]:
        try:
            backend, patch = Backend.apply_changes(backend, message["changes"])
        except (AutomergeError, ValueError, KeyError, IndexError) as exc:
            # OpSet.apply_changes commits only after a clean run, so the
            # backend state is untouched here
            _M_REJECTED.inc()
            raise SyncProtocolError(
                f"sync message carried inapplicable changes: {exc}"
            ) from exc
        shared_heads = _advance_heads(before_heads, Backend.get_heads(backend), shared_heads)

    if not message["changes"] and message["heads"] == before_heads:
        last_sent_heads = message["heads"]

    known_heads = [h for h in message["heads"] if Backend.get_change_by_hash(backend, h)]
    if len(known_heads) == len(message["heads"]):
        shared_heads = message["heads"]
        if len(message["heads"]) == 0:
            last_sent_heads = []
            sent_hashes = {}
    else:
        shared_heads = sorted(set(known_heads + shared_heads))

    sync_state = {
        "sharedHeads": shared_heads,
        "lastSentHeads": last_sent_heads,
        "theirHave": message["have"],
        "theirHeads": message["heads"],
        "theirNeed": message["need"],
        "sentHashes": sent_hashes,
    }
    return backend, sync_state, patch

"""Data synchronisation protocol, wire half: Bloom-filter have/need messages.

Port of the wire layer of the JAX package's ``sync.py`` (reference
backend/sync.js, wire-format compatible): the Bloom filter, the sync
message codec, the initial peer state and the shared-heads update. The
single-document loop (``generate_sync_message`` /
``receive_sync_message``) needs the sequential backend and is not part of
this package yet; the batched loop over a document farm is
``tpu/sync_farm.py``.

Based on: Martin Kleppmann and Heidi Howard, "Byzantine Eventual
Consistency and the Fundamental Limits of Peer-to-Peer Databases"
(https://arxiv.org/abs/2012.00472).
"""
from __future__ import annotations

from math import ceil

from .codecs import Decoder, Encoder, bytes_to_hex, hex_to_bytes
from .errors import EncodeError, SyncProtocolError
from .obs.metrics import get_metrics

HASH_SIZE = 32
MESSAGE_TYPE_SYNC = 0x42

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


def init_sync_state():
    return {
        "sharedHeads": [],
        "lastSentHeads": [],
        "theirHeads": None,
        "theirNeed": None,
        "theirHave": None,
        "sentHashes": {},
    }


def _advance_heads(my_old_heads, my_new_heads, our_old_shared_heads):
    new_heads = [head for head in my_new_heads if head not in my_old_heads]
    common_heads = [head for head in our_old_shared_heads if head in my_new_heads]
    return sorted(set(new_heads + common_heads))

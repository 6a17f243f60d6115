"""Sync v2: range-based set reconciliation over the change-hash DAG.

The v1 protocol (sync.py) ships O(n) Bloom filters per round and can stall
on false positives — the session watchdog's rebuild/reset ladder exists
purely to break those stalls. This module implements the
deterministic alternative (range-based set reconciliation, in the style of
https://arxiv.org/abs/2212.13567): the two peers' change-hash sets are
compared range-by-range using XOR-of-hash fingerprints, mismatching ranges
split at item-count medians, and ranges below a small threshold exchange
explicit item lists. Convergence takes O(log n) round trips with **no
probabilistic failure mode** — a fingerprint mismatch is always real, an
item list is always authoritative, and nothing is ever wrongly withheld
(v2 deliberately does not consult v1's ``sentHashes``).

Layering mirrors v1:

- the wire codec (``encode_sync_message_v2``/``decode_sync_message_v2``)
  rejects malformed frames strictly into the error taxonomy
  (``SyncProtocolError``; local state untouched);
- the driver is split into a host planning phase
  (``plan_generate_v2`` — which fingerprint queries does this round
  need?), a fingerprint resolution step the caller owns (the batched farm
  resolves EVERY live channel's queries as one device reduction, see
  tpu/fingerprint.py), and a finish phase (``finish_generate_v2``);
- ``generate_sync_message_v2``/``receive_sync_message_v2`` wrap the
  phases for a single backend, the drop-in v2 twins of the v1 entry
  points.

Negotiation lives one layer up (sync_session.py): v2 only runs inside a
session whose peer advertised the capability flag, and the session falls
back to v1 mid-stream if a v2 exchange errors.

Wire format (inner payload; the session envelope is unchanged)::

    byte   MESSAGE_TYPE_SYNC_V2 (0x45)
    heads  sorted hash list          (same layout as v1)
    need   sorted hash list
    uint32 range count; per range:
        32B lo | 32B hi              (half-open [lo, hi); sorted,
                                      non-overlapping, lo < hi)
        byte mode
        mode 0 (fingerprint): uint53 count | 32B xor-of-hashes
        mode 1 (item list):   uint32 n | n x 32B (strictly ascending,
                                                  every item in [lo, hi))
    uint32 change count; per change: prefixed change bytes

Trailing bytes are ignored for forward compatibility (as in v1).

This is the port's own copy of the JAX package's ``sync_v2.py`` (host-only
in both packages); its wire bytes are the JAX package's byte for byte.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

from bisect import bisect_left, insort

from . import backend as Backend
from .codecs import Decoder, Encoder, bytes_to_hex, hex_to_bytes
from .columnar import decode_change_meta_cached
from .errors import AutomergeError, EncodeError, SyncProtocolError
from .obs.metrics import get_metrics
from .sync import HASH_SIZE, _advance_heads, _decode_hashes, _encode_hashes
from .testing.faults import fire as _fault_point

MESSAGE_TYPE_SYNC_V2 = 0x45
RANGE_FINGERPRINT = 0
RANGE_ITEMS = 1

#: ranges at or below this many local items answer a fingerprint mismatch
#: with an explicit item list instead of splitting further
ITEM_THRESHOLD = 16
#: mismatching ranges split into this many subranges at item-count medians
SPLIT_FANOUT = 4

#: the full hash space, half-open: [MIN_HASH, MAX_HASH)
MIN_HASH = "0" * 64
MAX_HASH = "f" * 64

# v2 wire/driver metrics. Change and byte volume record into the SAME
# named instruments as v1 (sync.changes.*, sync.bytes.*) so protocol
# totals accumulate in one place; the sync.v2.* family is the
# reconciliation-specific accounting.
_METRICS = get_metrics()
_M2_MSGS_GEN = _METRICS.counter(
    "sync.v2.messages.generated", "v2 reconciliation messages encoded"
)
_M2_MSGS_RECV = _METRICS.counter(
    "sync.v2.messages.received", "v2 reconciliation messages decoded"
)
_M2_REJECTED = _METRICS.counter(
    "sync.v2.messages.rejected",
    "received v2 messages rejected as malformed or inapplicable "
    "(SyncProtocolError; local state untouched)",
)
_M2_RANGES_SENT = _METRICS.counter(
    "sync.v2.ranges.sent", "ranges encoded into outgoing v2 messages"
)
_M2_RECONCILED = _METRICS.counter(
    "sync.v2.ranges.reconciled",
    "received ranges whose fingerprint matched ours (subtree fully in sync)",
)
_M2_SPLIT = _METRICS.counter(
    "sync.v2.ranges.split",
    "fingerprint mismatches answered by splitting at item-count medians",
)
_M2_ITEMS = _METRICS.counter(
    "sync.v2.items.sent", "item-list entries sent for sub-threshold ranges"
)
_M_BYTES_SENT = _METRICS.counter("sync.bytes.sent")
_M_BYTES_RECV = _METRICS.counter("sync.bytes.received")
_M_CHANGES_SENT = _METRICS.counter("sync.changes.sent")
_M_CHANGES_RECV = _METRICS.counter("sync.changes.received")


# ---------------------------------------------------------------------- #
# fingerprint index (host). The device twin — one pow2-bucketed XOR
# reduction for every live channel's ranges — is tpu/fingerprint.py.

class HashIndex:
    """Sorted change-hash set with O(1)-per-query range fingerprints.

    Hashes are 64-char lowercase hex (the reference protocol's hash
    strings); a range fingerprint over [lo, hi) is the XOR of every member
    hash, served from a lazily rebuilt prefix-XOR array. Inserts are
    incremental (``insert_many`` on every applied change); the prefix
    array rebuilds once per query burst, not per insert.
    """

    __slots__ = ("_hashes", "_members", "_prefix", "_dirty")

    def __init__(self, hashes=()):
        self._hashes: list[str] = []
        self._members: set[str] = set()
        self._prefix: list[int] = [0]
        self._dirty = False
        self.insert_many(hashes)

    def __len__(self) -> int:
        return len(self._hashes)

    def contains(self, h: str) -> bool:
        return h in self._members

    def insert(self, h: str) -> bool:
        if h in self._members:
            return False
        if len(h) != 2 * HASH_SIZE:
            raise SyncProtocolError(f"not a 256-bit hash: {h!r}")
        try:
            int(h, 16)
        except (ValueError, TypeError) as exc:
            raise SyncProtocolError(f"not a hex hash: {h!r}") from exc
        self._members.add(h)
        insort(self._hashes, h)
        self._dirty = True
        return True

    def insert_many(self, hashes) -> None:
        for h in hashes:
            self.insert(h)

    def _span(self, lo: str, hi: str) -> tuple[int, int]:
        return bisect_left(self._hashes, lo), bisect_left(self._hashes, hi)

    def count(self, lo: str, hi: str) -> int:
        i, j = self._span(lo, hi)
        return j - i

    def items(self, lo: str, hi: str) -> list[str]:
        i, j = self._span(lo, hi)
        return self._hashes[i:j]

    def fingerprint_many(self, queries) -> list[tuple[int, str]]:
        """[(lo, hi)] -> [(count, xor_hex)] in query order."""
        if self._dirty:
            acc = 0
            prefix = [0]
            for h in self._hashes:
                acc ^= int(h, 16)
                prefix.append(acc)
            self._prefix = prefix
            self._dirty = False
        out = []
        for lo, hi in queries:
            i, j = self._span(lo, hi)
            out.append((j - i, format(self._prefix[j] ^ self._prefix[i], "064x")))
        return out


def index_for_backend(backend, index: HashIndex | None = None) -> HashIndex:
    """Builds (or refreshes) a ``HashIndex`` over every change hash the
    backend holds. Refresh is a no-op when the counts already agree —
    change sets only grow, so a count match means the index is current."""
    index = index if index is not None else HashIndex()
    hashes = [
        decode_change_meta_cached(c)["hash"]
        for c in Backend.get_changes(backend, [])
    ]
    if len(hashes) != len(index):
        index.insert_many(hashes)
    return index


# ---------------------------------------------------------------------- #
# wire codec

def encode_sync_message_v2(message) -> bytes:
    encoder = Encoder()
    encoder.append_byte(MESSAGE_TYPE_SYNC_V2)
    _encode_hashes(encoder, message["heads"])
    _encode_hashes(encoder, message["need"])
    ranges = message["ranges"]
    encoder.append_uint32(len(ranges))
    prev_hi = None
    for r in ranges:
        lo, hi = r["lo"], r["hi"]
        lo_bytes, hi_bytes = hex_to_bytes(lo), hex_to_bytes(hi)
        if len(lo_bytes) != HASH_SIZE or len(hi_bytes) != HASH_SIZE:
            raise EncodeError("range bounds must be 256-bit hashes")
        if lo >= hi:
            raise EncodeError("range bounds must satisfy lo < hi")
        if prev_hi is not None and lo < prev_hi:
            raise EncodeError("ranges must be sorted and non-overlapping")
        prev_hi = hi
        encoder.append_raw_bytes(lo_bytes)
        encoder.append_raw_bytes(hi_bytes)
        mode = r["mode"]
        encoder.append_byte(mode)
        if mode == RANGE_FINGERPRINT:
            encoder.append_uint53(r["count"])
            fp = hex_to_bytes(r["fp"])
            if len(fp) != HASH_SIZE:
                raise EncodeError("range fingerprint must be 256 bits")
            encoder.append_raw_bytes(fp)
        elif mode == RANGE_ITEMS:
            items = r["items"]
            encoder.append_uint32(len(items))
            prev = None
            for h in items:
                data = hex_to_bytes(h)
                if len(data) != HASH_SIZE:
                    raise EncodeError("item hashes must be 256 bits")
                if not (lo <= h < hi):
                    raise EncodeError("item hash outside its range")
                if prev is not None and h <= prev:
                    raise EncodeError("item hashes must be strictly ascending")
                prev = h
                encoder.append_raw_bytes(data)
        else:
            raise EncodeError(f"unknown range mode: {mode}")
    encoder.append_uint32(len(message["changes"]))
    for change in message["changes"]:
        encoder.append_prefixed_bytes(change)
    return encoder.buffer


def decode_sync_message_v2(data):
    """Decodes one v2 message with strict validation: unsorted or
    overlapping ranges, inverted bounds, out-of-range or duplicate item
    hashes, unknown modes, and truncated or garbage bytes all raise
    ``SyncProtocolError`` (never a raw decode exception) without
    constructing partial state."""
    try:
        decoder = Decoder(data)
        message_type = decoder.read_byte()
        if message_type != MESSAGE_TYPE_SYNC_V2:
            raise SyncProtocolError(
                f"Unexpected v2 message type: {message_type}"
            )
        heads = _decode_hashes(decoder)
        need = _decode_hashes(decoder)
        range_count = decoder.read_uint32()
        ranges = []
        prev_hi = None
        for _ in range(range_count):
            lo = bytes_to_hex(decoder.read_raw_bytes(HASH_SIZE))
            hi = bytes_to_hex(decoder.read_raw_bytes(HASH_SIZE))
            if lo >= hi:
                raise SyncProtocolError(
                    f"inverted range bounds: {lo[:8]}.. >= {hi[:8]}.."
                )
            if prev_hi is not None and lo < prev_hi:
                raise SyncProtocolError(
                    f"overlapping ranges: {lo[:8]}.. < {prev_hi[:8]}.."
                )
            prev_hi = hi
            mode = decoder.read_byte()
            if mode == RANGE_FINGERPRINT:
                count = decoder.read_uint53()
                fp = bytes_to_hex(decoder.read_raw_bytes(HASH_SIZE))
                ranges.append(
                    {"lo": lo, "hi": hi, "mode": mode, "count": count, "fp": fp}
                )
            elif mode == RANGE_ITEMS:
                n = decoder.read_uint32()
                items = []
                prev = None
                for _ in range(n):
                    h = bytes_to_hex(decoder.read_raw_bytes(HASH_SIZE))
                    if not (lo <= h < hi):
                        raise SyncProtocolError(
                            f"item hash {h[:8]}.. outside its range"
                        )
                    if prev is not None and h <= prev:
                        raise SyncProtocolError(
                            "item hashes must be strictly ascending "
                            f"(duplicate or unsorted at {h[:8]}..)"
                        )
                    prev = h
                    items.append(h)
                ranges.append({"lo": lo, "hi": hi, "mode": mode, "items": items})
            else:
                raise SyncProtocolError(f"unknown range mode: {mode}")
        change_count = decoder.read_uint32()
        changes = [decoder.read_prefixed_bytes() for _ in range(change_count)]
    except SyncProtocolError:
        raise
    except (ValueError, TypeError, IndexError) as exc:
        raise SyncProtocolError(f"malformed v2 sync message: {exc}") from exc
    # Trailing bytes are ignored for forward compatibility (as in v1)
    return {"heads": heads, "need": need, "ranges": ranges, "changes": changes}


# ---------------------------------------------------------------------- #
# driver: plan / resolve-fingerprints / finish

def _split_ranges(items, lo, hi, fanout=SPLIT_FANOUT):
    """Subranges of [lo, hi) cut at the local items' count medians:
    [(lo_k, hi_k, count_k)] covering [lo, hi) exactly."""
    n = len(items)
    cuts = []
    for k in range(1, fanout):
        b = items[(n * k) // fanout]
        if b <= lo or b >= hi:
            continue
        if cuts and b <= cuts[-1]:
            continue
        cuts.append(b)
    bounds = [lo] + cuts + [hi]
    out = []
    for a, b in zip(bounds, bounds[1:]):
        i, j = bisect_left(items, a), bisect_left(items, b)
        out.append((a, b, j - i))
    return out


def plan_generate_v2(state, view, our_heads):
    """Host phase 1 of a v2 generate: consumes the inbound fingerprint
    ranges (stashed by the last receive) and decides whether to open a
    fresh full-range probe. Returns ``(plan, queries)`` where ``queries``
    is the ordered [(lo, hi)] fingerprint list the caller must resolve —
    via ``HashIndex.fingerprint_many`` for one document, or ONE pow2-
    bucketed batched device reduction for every live channel at once
    (tpu/fingerprint.FingerprintIndex.fingerprint_ranges) — before
    ``finish_generate_v2``. ``view`` answers host-side set questions
    (count/items) for the local hash set."""
    queries = []
    entries = []
    for r in state.get("v2Inbound") or []:
        lo, hi = r["lo"], r["hi"]
        count = view.count(lo, hi)
        entry = {"range": r, "q": len(queries)}
        queries.append((lo, hi))
        if count > ITEM_THRESHOLD:
            items = view.items(lo, hi)
            subs = []
            for a, b, _c in _split_ranges(items, lo, hi):
                subs.append({"lo": a, "hi": b, "q": len(queries)})
                queries.append((a, b))
            entry["subs"] = subs
        else:
            entry["items"] = view.items(lo, hi)
        entries.append(entry)
    their_heads = state.get("theirHeads")
    probe_key = [list(our_heads), list(their_heads or [])]
    probe = None
    if (
        not entries
        and not (state.get("v2Outbound") or [])
        and (their_heads is None or list(their_heads) != list(our_heads))
        and state.get("v2Probe") != probe_key
    ):
        # nothing in flight and the heads disagree: open (or re-open) the
        # descent with a full-range fingerprint. The probe key pins one
        # probe per observed heads pair, so an in-progress descent is
        # never duplicated while the ball is in the peer's court.
        probe = {"q": len(queries)}
        queries.append((MIN_HASH, MAX_HASH))
    return {"entries": entries, "probe": probe, "probe_key": probe_key}, queries


def finish_generate_v2(state, plan, fps, get_change, our_heads, our_need):
    """Host phase 2: assembles the outgoing message from the resolved
    fingerprints. Returns ``(new_state, message_bytes | None)`` — None
    exactly when the channel is converged and silent (v1's quiescence
    conditions, so the session layer's advert suppression composes)."""
    ranges = list(state.get("v2Outbound") or [])
    for entry in plan["entries"]:
        r = entry["range"]
        count, fp = fps[entry["q"]]
        if count == r["count"] and fp == r["fp"]:
            _M2_RECONCILED.inc()
            continue
        if "items" in entry:
            ranges.append({
                "lo": r["lo"], "hi": r["hi"],
                "mode": RANGE_ITEMS, "items": entry["items"],
            })
        else:
            _M2_SPLIT.inc()
            for sub in entry["subs"]:
                sc, sf = fps[sub["q"]]
                ranges.append({
                    "lo": sub["lo"], "hi": sub["hi"],
                    "mode": RANGE_FINGERPRINT, "count": sc, "fp": sf,
                })
    probed = False
    if plan["probe"] is not None:
        pc, pf = fps[plan["probe"]["q"]]
        ranges.append({
            "lo": MIN_HASH, "hi": MAX_HASH,
            "mode": RANGE_FINGERPRINT, "count": pc, "fp": pf,
        })
        probed = True
    # enforce the wire invariant (sorted, non-overlapping): responses to
    # disjoint peer ranges are disjoint by construction, but a carried-over
    # outbound range can collide with a fresh probe; the dropped range's
    # information is re-derived by the next descent round
    ranges.sort(key=lambda r: (r["lo"], r["hi"]))
    kept = []
    prev_hi = None
    for r in ranges:
        if prev_hi is not None and r["lo"] < prev_hi:
            continue
        kept.append(r)
        prev_hi = r["hi"]
    ranges = kept

    need = sorted(set(our_need or ()) | set(state.get("v2Need") or ()))
    send_queue = state.get("v2SendQueue") or {}
    their_need = state.get("theirNeed") or []
    changes = []
    seen = set()
    for h in list(their_need) + sorted(send_queue):
        if h in seen:
            continue
        seen.add(h)
        change = get_change(h)
        if change is not None:
            changes.append(change)

    heads_unchanged = (
        isinstance(state.get("lastSentHeads"), list)
        and list(our_heads) == list(state["lastSentHeads"])
    )
    their_heads = state.get("theirHeads")
    heads_equal = (
        isinstance(their_heads, list) and list(our_heads) == list(their_heads)
    )
    if heads_unchanged and heads_equal and not ranges and not changes and not need:
        return state, None

    message = {
        "heads": list(our_heads), "need": need,
        "ranges": ranges, "changes": changes,
    }
    encoded = encode_sync_message_v2(message)
    new_state = dict(
        state,
        lastSentHeads=list(our_heads),
        v2Inbound=[], v2Outbound=[], v2SendQueue={}, v2Need=[],
    )
    if probed:
        new_state["v2Probe"] = plan["probe_key"]
    _M2_MSGS_GEN.inc()
    _M_BYTES_SENT.inc(len(encoded))
    _M_CHANGES_SENT.inc(len(changes))
    if _METRICS.enabled:
        _M2_RANGES_SENT.inc(len(ranges))
        _M2_ITEMS.inc(sum(
            len(r["items"]) for r in ranges if r["mode"] == RANGE_ITEMS
        ))
    return new_state, encoded


def post_receive_v2(state, message, before_heads, after_heads, has_change, view):
    """Shared post-apply bookkeeping for a validated, applied v2 message:
    advances sharedHeads exactly like v1's receive, stashes received
    fingerprint ranges for the next generate's batched resolution, and
    diffs item-list ranges against the local set (ours-not-theirs queue as
    sends; theirs-not-ours become explicit needs). Pure state-in/state-out
    so the sequential and batched-farm receive paths share it."""
    shared_heads = state["sharedHeads"]
    last_sent_heads = state["lastSentHeads"]
    if message["changes"]:
        shared_heads = _advance_heads(before_heads, after_heads, shared_heads)
    if not message["changes"] and message["heads"] == before_heads:
        last_sent_heads = message["heads"]
    known = [h for h in message["heads"] if has_change(h)]
    if len(known) == len(message["heads"]):
        shared_heads = message["heads"]
    else:
        shared_heads = sorted(set(known + shared_heads))

    inbound = list(state.get("v2Inbound") or [])
    send_queue = dict(state.get("v2SendQueue") or {})
    need = list(state.get("v2Need") or [])
    for r in message["ranges"]:
        if r["mode"] == RANGE_FINGERPRINT:
            inbound.append({
                "lo": r["lo"], "hi": r["hi"],
                "count": r["count"], "fp": r["fp"],
            })
        else:
            theirs = set(r["items"])
            for h in view.items(r["lo"], r["hi"]):
                if h not in theirs:
                    send_queue[h] = True
            for h in r["items"]:
                if not view.contains(h):
                    need.append(h)
    return dict(
        state,
        sharedHeads=shared_heads,
        lastSentHeads=last_sent_heads,
        theirHeads=message["heads"],
        theirNeed=message["need"],
        theirHave=None,  # v1 belief; stale after a v2 exchange
        v2Inbound=inbound,
        v2SendQueue=send_queue,
        v2Need=need,
    )


# ---------------------------------------------------------------------- #
# single-document entry points (the v2 twins of sync.py's)

def generate_sync_message_v2(backend, sync_state, index):
    """Generates the next v2 message for a peer, or None when converged.
    Returns (sync_state, message_bytes_or_None)."""
    if backend is None:
        raise SyncProtocolError(
            "generate_sync_message_v2 called with no Automerge document"
        )
    if sync_state is None:
        raise SyncProtocolError(
            "generate_sync_message_v2 requires a sync_state"
        )
    our_heads = Backend.get_heads(backend)
    our_need = Backend.get_missing_deps(backend, sync_state.get("theirHeads") or [])
    plan, queries = plan_generate_v2(sync_state, index, our_heads)
    fps = index.fingerprint_many(queries)
    return finish_generate_v2(
        sync_state, plan, fps,
        lambda h: Backend.get_change_by_hash(backend, h),
        our_heads, our_need,
    )


def receive_sync_message_v2(backend, old_sync_state, index, binary_message):
    """Processes a received v2 message; returns (backend, sync_state,
    patch). Malformed or inapplicable messages raise ``SyncProtocolError``
    with the backend, the sync_state object AND the index all provably
    untouched (validation and change application both complete before any
    local mutation)."""
    if backend is None:
        raise SyncProtocolError(
            "receive_sync_message_v2 called with no Automerge document"
        )
    if old_sync_state is None:
        raise SyncProtocolError(
            "receive_sync_message_v2 requires a sync_state"
        )
    try:
        _fault_point("sync.receive_message_v2", message=binary_message)
        message = decode_sync_message_v2(binary_message)
    except SyncProtocolError:
        _M2_REJECTED.inc()
        raise
    before_heads = Backend.get_heads(backend)
    patch = None
    if message["changes"]:
        try:
            backend, patch = Backend.apply_changes(backend, message["changes"])
        except (AutomergeError, ValueError, KeyError, IndexError) as exc:
            # OpSet.apply_changes commits only after a clean run, so the
            # backend state is untouched here
            _M2_REJECTED.inc()
            raise SyncProtocolError(
                f"v2 sync message carried inapplicable changes: {exc}"
            ) from exc
        index.insert_many(
            decode_change_meta_cached(c)["hash"] for c in message["changes"]
        )
    _M2_MSGS_RECV.inc()
    _M_BYTES_RECV.inc(len(binary_message))
    _M_CHANGES_RECV.inc(len(message["changes"]))
    new_state = post_receive_v2(
        old_sync_state, message, before_heads, Backend.get_heads(backend),
        lambda h: Backend.get_change_by_hash(backend, h) is not None,
        index,
    )
    return backend, new_state, patch

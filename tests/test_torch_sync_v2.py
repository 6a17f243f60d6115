"""Sync v2 (range-based reconciliation) in the port against the JAX
package, on the CPU: the wire codec (equal bytes, and every malformed
shape rejected with ``SyncProtocolError``, touching nothing) and the
single-document v2 loop (equal messages sweep by sweep). The fingerprint
reduction and the farm's mixed sweep are tests/test_torch_fingerprint.py's."""
import hashlib
import math

import pytest

from automerge_tpu import backend as JaxBackend
from automerge_tpu import sync as JaxSync
from automerge_tpu import sync_v2 as JaxV2
from automerge_tpu.errors import SyncProtocolError as JaxSyncProtocolError
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch import sync as Sync
from automerge_tpu_torch import sync_v2 as V2
from automerge_tpu_torch.codecs import Encoder, hex_to_bytes
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.errors import SyncProtocolError

MIN, MAX = V2.MIN_HASH, V2.MAX_HASH


def fake_hash(i) -> str:
    return hashlib.sha256(str(i).encode()).hexdigest()


def fp_range(lo, hi, count=1, fp=None):
    return {"lo": lo, "hi": hi, "mode": V2.RANGE_FINGERPRINT,
            "count": count, "fp": fp or fake_hash("fp")}


def raw_message(heads=(), need=(), ranges=(), changes=()):
    """A v2 frame encoded without the encoder's validation, so a test can
    craft frames the strict encoder refuses to produce."""
    enc = Encoder()
    enc.append_byte(V2.MESSAGE_TYPE_SYNC_V2)
    Sync._encode_hashes(enc, sorted(heads))
    Sync._encode_hashes(enc, sorted(need))
    enc.append_uint32(len(ranges))
    for r in ranges:
        enc.append_raw_bytes(hex_to_bytes(r["lo"]))
        enc.append_raw_bytes(hex_to_bytes(r["hi"]))
        enc.append_byte(r["mode"])
        if r["mode"] == V2.RANGE_FINGERPRINT:
            enc.append_uint53(r["count"])
            enc.append_raw_bytes(hex_to_bytes(r["fp"]))
        else:
            enc.append_uint32(len(r["items"]))
            for h in r["items"]:
                enc.append_raw_bytes(hex_to_bytes(h))
    enc.append_uint32(len(changes))
    for change in changes:
        enc.append_prefixed_bytes(change)
    return enc.buffer


# ---------------------------------------------------------------------- #
# the wire codec


def _messages():
    items = sorted(fake_hash(i) for i in range(3))
    return [
        {"heads": [], "need": [], "ranges": [], "changes": []},
        {"heads": sorted([fake_hash("h1"), fake_hash("h2")]),
         "need": [fake_hash("n1")],
         "ranges": [{"lo": MIN, "hi": items[-1], "mode": V2.RANGE_ITEMS,
                     "items": items[:-1]},
                    fp_range(items[-1], MAX, count=7)],
         "changes": [b"change-one", b"change-two"]},
        {"heads": [fake_hash("h")], "need": [],
         "ranges": [fp_range(MIN, MAX, count=1 << 40, fp="f" * 64)],
         "changes": []},
    ]


@pytest.mark.parametrize("index", range(3))
def test_codec_bytes_match_jax(index):
    message = _messages()[index]
    data = V2.encode_sync_message_v2(message)
    assert data == JaxV2.encode_sync_message_v2(message)
    assert V2.decode_sync_message_v2(data) == message
    assert V2.decode_sync_message_v2(data + b"\x00future") == message


def _poisoned():
    a, b, c = sorted(fake_hash(i) for i in range(3))
    h = fake_hash(9)
    enc = Encoder()
    enc.append_byte(V2.MESSAGE_TYPE_SYNC_V2)
    Sync._encode_hashes(enc, [])
    Sync._encode_hashes(enc, [])
    enc.append_uint32(1)
    enc.append_raw_bytes(hex_to_bytes(MIN))
    enc.append_raw_bytes(hex_to_bytes(MAX))
    enc.append_byte(7)
    valid = raw_message(heads=[fake_hash("h")],
                        ranges=[fp_range(MIN, MAX, count=3)],
                        changes=[b"some-change-bytes"])
    return {
        "garbage": bytes([V2.MESSAGE_TYPE_SYNC_V2]) + b"\xff" * 40,
        "wrong type byte": b"\x42" + valid[1:],
        "inverted bounds": raw_message(ranges=[
            {"lo": MAX[:-1] + "e", "hi": MIN, "mode": V2.RANGE_FINGERPRINT,
             "count": 0, "fp": "0" * 64}]),
        "overlapping ranges": raw_message(
            ranges=[fp_range(a, c), fp_range(b, MAX)]),
        "duplicate items": raw_message(ranges=[
            {"lo": MIN, "hi": MAX, "mode": V2.RANGE_ITEMS, "items": [h, h]}]),
        "item outside its range": raw_message(ranges=[
            {"lo": b, "hi": MAX, "mode": V2.RANGE_ITEMS, "items": [a]}]),
        "unknown range mode": enc.buffer,
        **{f"truncated to {keep}": valid[:keep] for keep in range(len(valid))},
    }


POISONED = _poisoned()


@pytest.mark.parametrize("name", ["garbage", "wrong type byte",
                                  "inverted bounds", "overlapping ranges",
                                  "duplicate items", "item outside its range",
                                  "unknown range mode"])
def test_codec_rejects_like_jax(name):
    data = POISONED[name]
    with pytest.raises(JaxSyncProtocolError):
        JaxV2.decode_sync_message_v2(data)
    with pytest.raises(SyncProtocolError):
        V2.decode_sync_message_v2(data)


def test_every_truncation_rejects_like_jax():
    truncations = [v for k, v in POISONED.items() if k.startswith("truncated")]
    assert len(truncations) > 100
    for data in truncations:
        with pytest.raises(JaxSyncProtocolError):
            JaxV2.decode_sync_message_v2(data)
        with pytest.raises(SyncProtocolError):
            V2.decode_sync_message_v2(data)


def test_rejected_frame_touches_nothing():
    backend = grow(Backend.init(), "aaaaaaaa", [f"k{i}" for i in range(4)])
    index = V2.index_for_backend(backend)
    state = Sync.init_sync_state()
    heads = Backend.get_heads(backend)
    for name in ("garbage", "overlapping ranges", "duplicate items",
                 "truncated to 20"):
        with pytest.raises(SyncProtocolError):
            V2.receive_sync_message_v2(backend, state, index, POISONED[name])
    bad_change = raw_message(changes=[b"\x00garbage-not-a-change"])
    with pytest.raises(SyncProtocolError):
        V2.receive_sync_message_v2(backend, state, index, bad_change)
    assert Backend.get_heads(backend) == heads
    assert state == Sync.init_sync_state()
    assert len(index) == 4


# ---------------------------------------------------------------------- #
# the single-document v2 loop


def grow(backend, actor, keys, backend_mod=Backend):
    for i, key in enumerate(keys):
        buf = encode_change({
            "actor": actor, "seq": i + 1, "startOp": i + 1, "time": 0,
            "deps": backend_mod.get_heads(backend),
            "ops": [{"action": "set", "obj": "_root", "key": key,
                     "datatype": "uint", "value": i, "pred": []}]})
        backend, _ = backend_mod.apply_changes(backend, [buf])
    return backend


def converge_v2(sync, v2, ba, bb, max_round_trips=64):
    """Drives one package's v2 entry points until both sides go quiet;
    returns (messages in order, ba, bb, round trips)."""
    sa, sb = sync.init_sync_state(), sync.init_sync_state()
    ia, ib = v2.index_for_backend(ba), v2.index_for_backend(bb)
    log, trips = [], 0
    for _ in range(max_round_trips):
        sa, ma = v2.generate_sync_message_v2(ba, sa, ia)
        sb, mb = v2.generate_sync_message_v2(bb, sb, ib)
        log.append((ma, mb))
        if ma is None and mb is None:
            break
        trips += 1
        if ma is not None:
            bb, sb, patch = v2.receive_sync_message_v2(bb, sb, ib, ma)
            log.append(patch)
        if mb is not None:
            ba, sa, patch = v2.receive_sync_message_v2(ba, sa, ia, mb)
            log.append(patch)
    return log, ba, bb, trips


@pytest.mark.parametrize("na,nb", [(0, 12), (12, 0), (60, 45), (1, 1)])
def test_single_document_v2_matches_jax(na, nb):
    def peers(mod):
        return (grow(mod.init(), "aaaaaaaa", [f"a{i}" for i in range(na)], mod),
                grow(mod.init(), "bbbbbbbb", [f"b{i}" for i in range(nb)], mod))

    want, ja, jb, jtrips = converge_v2(JaxSync, JaxV2, *peers(JaxBackend))
    got, pa, pb, trips = converge_v2(Sync, V2, *peers(Backend))
    assert got == want and trips == jtrips
    assert Backend.get_heads(pa) == Backend.get_heads(pb)
    assert Backend.get_patch(pa) == JaxBackend.get_patch(ja)
    assert trips <= 2 * math.log2(max(na + nb, 2)) + 2

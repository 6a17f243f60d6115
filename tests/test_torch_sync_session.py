"""Supervised sync channels (``SyncSession``) in the port against the JAX
package, on the CPU: equal frame bytes and rejections, and the sync v2
negotiation and fallback cases of the JAX package's suite, run on the
port. Whole frame streams under seeded loss are
tests/test_torch_session_streams.py's."""
import random

import pytest

from automerge_tpu import sync_session as JaxSessions
from automerge_tpu_torch import BackendDriver, SessionConfig, SyncSession
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch import sync_session as Sessions
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.errors import SyncFrameError, SyncProtocolError

import chip_smoke

# ---------------------------------------------------------------------- #
# the frame codec


@pytest.mark.parametrize("epoch,seq,ack,payload,flags", [
    (7, 3, 2, b"payload-bytes", 0),
    (9, 0, 5, None, 0),
    (7, 3, 2, b"payload-bytes", Sessions.FLAG_V2),
    (9, 0, 5, None, Sessions.FLAG_V2),
    ((1 << 32) - 1, (1 << 53) - 1, 1 << 40, b"", 0),
])
def test_frame_bytes_match_jax(epoch, seq, ack, payload, flags):
    frame = Sessions.encode_frame(epoch, seq, ack, payload, flags)
    assert frame == JaxSessions.encode_frame(epoch, seq, ack, payload, flags)
    assert Sessions.decode_frame(frame) == JaxSessions.decode_frame(frame)


def test_damaged_frames_reject_like_jax():
    frame = Sessions.encode_frame(1, 1, 0, b"payload-bytes")
    damaged = [frame[:keep] for keep in range(len(frame))]
    for bit in range(0, len(frame) * 8, 7):
        flipped = bytearray(frame)
        flipped[bit >> 3] ^= 1 << (bit & 7)
        damaged.append(bytes(flipped))
    for data in damaged:
        with pytest.raises(JaxSessions.SyncFrameError):
            JaxSessions.decode_frame(data)
        with pytest.raises(SyncFrameError):
            Sessions.decode_frame(data)


# ---------------------------------------------------------------------- #
# v2 negotiation and fallback (the JAX package's session cases)


def make_backend(actor, n):
    handle = Backend.init()
    for i in range(n):
        buf = key_change(actor, i + 1, Backend.get_heads(handle), f"k{i}")
        handle, _ = Backend.apply_changes(handle, [buf])
    return handle


def key_change(actor, seq, deps, key):
    return encode_change({
        "actor": actor, "seq": seq, "startOp": seq, "time": 0, "deps": deps,
        "ops": [{"action": "set", "obj": "_root", "key": key,
                 "datatype": "uint", "value": seq - 1, "pred": []}]})


def session_pair(v2a, v2b, *, driver_a=None, driver_b=None, seed=3):
    clock = chip_smoke.FakeClock()
    da = driver_a or BackendDriver(make_backend("aaaaaaaa", 6))
    db = driver_b or BackendDriver(make_backend("bbbbbbbb", 4))
    sa = SyncSession(da, clock=clock, rng=random.Random(seed),
                     config=SessionConfig(enable_v2=v2a))
    sb = SyncSession(db, clock=clock, rng=random.Random(seed + 1),
                     config=SessionConfig(enable_v2=v2b))
    return clock, sa, sb


def drive_transcript(clock, sa, sb, rounds=60):
    """Lossless shuttle recording every frame's (sender, flags, payload)."""
    frames = []
    for _ in range(rounds):
        fa, fb = sa.poll(), sb.poll()
        for sender, frame, receiver in (("a", fa, sb), ("b", fb, sa)):
            if frame is None:
                continue
            decoded = Sessions.decode_frame(frame)
            frames.append((sender, decoded["flags"], decoded["payload"]))
            receiver.handle(frame)
        if fa is None and fb is None:
            if sa.driver.heads() == sb.driver.heads():
                return frames, True
        clock.advance(0.05 if (fa or fb) else 0.26)
    return frames, sa.driver.heads() == sb.driver.heads()


def test_v1_v2_pairing_is_byte_for_byte_v1():
    ref_frames, ok = drive_transcript(*session_pair(False, False))
    mixed_frames, ok2 = drive_transcript(*session_pair(True, False))
    assert ok and ok2
    assert [p for _, _, p in ref_frames] == [p for _, _, p in mixed_frames]
    for (_, ref_flags, _), (sender, flags, _) in zip(ref_frames, mixed_frames):
        want = ref_flags | Sessions.FLAG_V2 if sender == "a" else ref_flags
        assert flags == want


def test_v2_pairing_activates_bilaterally_and_converges():
    clock, sa, sb = session_pair(True, True)
    _, ok = drive_transcript(clock, sa, sb)
    assert ok and sa.v2_active and sb.v2_active
    assert sa.stats["v2_negotiated"] == sb.stats["v2_negotiated"] == 1


def test_mixed_pairing_never_activates():
    clock, sa, sb = session_pair(True, False)
    _, ok = drive_transcript(clock, sa, sb)
    assert ok and not sa.v2_active and not sb.v2_active
    assert sa.stats["v2_negotiated"] == 0


class FailingGenerateDriver(BackendDriver):
    def generate_v2(self, state):
        raise SyncProtocolError("injected v2 planner failure")


class FailingReceiveDriver(BackendDriver):
    def receive_v2(self, state, payload):
        raise SyncProtocolError("injected v2 apply failure")


def test_generate_error_falls_back_same_call():
    da = FailingGenerateDriver(make_backend("aaaaaaaa", 6))
    clock, sa, sb = session_pair(True, True, driver_a=da)
    _, ok = drive_transcript(clock, sa, sb)
    assert ok and sa.stats["v2_fallbacks"] == 1
    assert not sa.v2_active and not sb.v2_active
    assert sa.stats["stalls"] == sb.stats["stalls"] == 0
    assert not any(k.startswith("v2") for k in sa.state)


def test_receive_error_acks_and_falls_back():
    db = FailingReceiveDriver(make_backend("bbbbbbbb", 4))
    clock, sa, sb = session_pair(True, True, driver_b=db)
    _, ok = drive_transcript(clock, sa, sb)
    assert ok and sb.stats["v2_fallbacks"] == 1
    assert not sa.quarantined and not sb.quarantined
    assert not sa.v2_active and not sb.v2_active


def test_peer_restart_renegotiates():
    clock, sa, sb = session_pair(True, True)
    _, ok = drive_transcript(clock, sa, sb)
    assert ok and sa.v2_active
    sb2 = SyncSession(sb.driver, clock=clock, rng=random.Random(9),
                      config=SessionConfig(enable_v2=True))
    frame = sb2.poll()
    assert frame is not None
    sa.handle(frame)
    assert sa.stats["peer_restarts"] == 1 and sa.peer_v2
    assert not any(k.startswith("v2") for k in sa.state)
    _, ok = drive_transcript(clock, sa, sb2)
    assert ok and sa.v2_active and sb2.v2_active

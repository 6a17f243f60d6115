"""The port's mesh data plane (``automerge_tpu_torch.parallel.shm``): twins
of tests/test_mesh_shm.py that never touch ``/dev/shm``.

``ColumnRing`` takes any object with ``.buf`` and ``.name`` as its
segment, so the slot state machine runs here over an in-memory stand-in
(``FakeSegment``), with the header initialised as ``ColumnRing.create``
does; ``create``/``attach`` run over a stand-in ``SharedMemory`` that
keeps its segments in a dict. The struct codecs' bytes are compared with
the JAX package's on the same inputs, both ways, and the farm's wire
frames (what a worker returns) hold host data only.
"""
import fnmatch
import json
import pickle
import types

import numpy as np
import pytest
import torch

from automerge_tpu.parallel import shm as jax_shm
from automerge_tpu_torch.errors import DecodeError, DeviceFaultError
from automerge_tpu_torch.parallel import shm


class FakeSegment:
    """An in-memory stand-in for ``multiprocessing.shared_memory``'s
    segment: a name and a writable buffer."""

    registry: dict = {}

    def __init__(self, name=None, create=False, size=0):
        if create:
            self.name = name
            self._bytes = bytearray(size)
            FakeSegment.registry[name] = self._bytes
        else:
            if name not in FakeSegment.registry:
                raise FileNotFoundError(name)
            self.name = name
            self._bytes = FakeSegment.registry[name]
        self.buf = memoryview(self._bytes)
        self.closed = self.unlinked = False

    def close(self):
        self.buf.release()
        self.closed = True

    def unlink(self):
        FakeSegment.registry.pop(self.name, None)
        self.unlinked = True


def _ring(nslots=2, slot_bytes=4096):
    """A ring over a stand-in segment, its header initialised as
    ``ColumnRing.create`` writes it."""
    header_words = shm._RING_WORDS + shm._SLOT_WORDS * nslots
    data_off = ((header_words * 8 + 63) // 64) * 64
    seg = FakeSegment("amt-test", create=True,
                      size=data_off + nslots * slot_bytes)
    ring = shm.ColumnRing(seg, nslots, slot_bytes, owner=True)
    hdr = seg.buf.cast("q")
    hdr[0], hdr[1], hdr[2] = shm._MAGIC, nslots, slot_bytes
    for s in range(nslots):
        base = shm._RING_WORDS + shm._SLOT_WORDS * s
        hdr[base + shm._W_STATE] = shm.FREE
    hdr.release()
    return ring


@pytest.fixture
def fake_shared_memory(monkeypatch):
    """Routes the module's ``shared_memory.SharedMemory`` to the stand-in."""
    FakeSegment.registry = {}
    monkeypatch.setattr(shm, "shared_memory",
                        types.SimpleNamespace(SharedMemory=FakeSegment))
    yield FakeSegment.registry


GROUPS = [
    (0, (b"alpha", b"", b"\x00\x01\x02")),
    (17, ()),
    (3, (b"z" * 1000,)),
]
PATCHES = pickle.dumps([{"objId": "_root", "action": "put"}])
WIRES = [
    ("applied", None, None, (), False),
    ("quarantined", pickle.dumps(ValueError("boom")), "decode",
     ("deadbeef", b"\xff\x00raw"), False),
    ("applied", None, None, (), True),  # served by the degraded walk
]


# --------------------------------------------------------------------- #
# codecs: byte-identical to the JAX package's


def test_column_codec_roundtrip_and_bytes_match_jax():
    blob = shm.encode_columns(GROUPS)
    assert len(blob) == shm.measure_columns(GROUPS)
    assert blob == jax_shm.encode_columns(GROUPS)
    assert shm.decode_columns(memoryview(blob)) == GROUPS
    assert jax_shm.decode_columns(memoryview(blob)) == GROUPS


def test_result_codec_bytes_match_jax_both_ways():
    frame = shm.encode_result(PATCHES, WIRES)
    assert frame == jax_shm.encode_result(PATCHES, WIRES)
    assert shm.decode_result(memoryview(frame)) == \
        jax_shm.decode_result(memoryview(frame))
    (off, length), got = shm.decode_result(memoryview(frame))
    assert memoryview(frame)[off:off + length] == PATCHES
    assert len(got) == len(WIRES)
    for want, have in zip(WIRES, got):
        status, blob, kind, offending, fallback = have
        assert (status, blob, kind, fallback) == (
            want[0], want[1], want[2], want[4])
        assert tuple(offending) == tuple(want[3])
        for w, h in zip(want[3], offending):
            assert type(w) is type(h)  # str/bytes tags survive the flags


def test_result_codec_common_case_is_compact():
    frame = shm.encode_result(b"", [("applied", None, None, (), False)])
    assert len(frame) <= 8 + 4 + 1 + 4 + len(b"applied") + 4


# --------------------------------------------------------------------- #
# the slot state machine over the stand-in segment


def test_column_codec_writes_into_a_slot():
    ring = _ring()
    groups = [(5, (b"hello", b"world"))]
    slot, gen = ring.acquire()
    view = ring.slot_view(slot)
    used = shm.encode_columns_into(view, groups)
    del view
    assert used == shm.measure_columns(groups)
    ref = ring.publish(slot, gen, used)
    got = ring.accept(ref)
    assert bytes(got) == jax_shm.encode_columns(groups)
    assert shm.decode_columns(got) == groups
    del got
    ring.release(ref.slot)
    assert ring.slots_in_use() == 0


def test_slot_lifecycle_and_capacity_stall():
    ring = _ring(nslots=2)
    refs = []
    for i in range(2):
        slot, gen = ring.acquire(timeout=0.05)
        view = ring.slot_view(slot)
        view[:1] = bytes([i])
        del view
        refs.append(ring.publish(slot, gen, 1))
    assert ring.slots_in_use() == 2
    stalls_before = ring.stalls
    with pytest.raises(shm.RingStall):
        ring.acquire(timeout=0.05)
    assert ring.stalls == stalls_before + 1
    assert isinstance(shm.RingStall("x"), DeviceFaultError)
    v = ring.accept(refs[0])
    assert bytes(v) == b"\x00"
    del v
    ring.release(refs[0].slot)
    slot, gen = ring.acquire(timeout=0.05)
    assert slot == refs[0].slot
    ring.abandon(slot)  # producer backout: straight to FREE
    assert ring.slots_in_use() == 1


def test_accept_refuses_stale_generation_after_reclaim():
    ring = _ring()
    slot, gen = ring.acquire()
    ref = ring.publish(slot, gen, 0)
    assert ring.reclaim() == 1  # "crash": the ref is now stale
    slot2, gen2 = ring.acquire()
    assert slot2 == slot and gen2 == gen + 1
    ring.publish(slot2, gen2, 0)
    with pytest.raises(DeviceFaultError):
        ring.accept(ref)
    v = ring.accept(shm.SlotRef(slot2, gen2, 0))
    del v
    ring.release(slot2)


def test_accept_refuses_length_mismatch_and_bad_slot():
    ring = _ring()
    slot, gen = ring.acquire()
    ring.publish(slot, gen, 8)
    with pytest.raises(DecodeError):
        ring.accept(shm.SlotRef(slot, gen, 9))
    with pytest.raises(DecodeError):
        ring.accept(shm.SlotRef(99, 1, 0))


def test_reclaim_preserves_consumer_held_when_asked():
    ring = _ring(nslots=3)
    sa, ga = ring.acquire()
    va = ring.accept(ring.publish(sa, ga, 0))
    va.release()  # drops the VIEW only; the slot stays CONSUMER_HELD
    ring.acquire()  # the dead producer's slot
    assert ring.slots_in_use() == 2
    assert ring.reclaim(held_by_producer_only=True) == 1
    assert ring.slots_in_use() == 1
    assert ring.reclaim() == 1
    assert ring.slots_in_use() == 0


# --------------------------------------------------------------------- #
# segment hygiene over the stand-in SharedMemory


def test_create_attach_maps_same_bytes_and_owner_unlinks(fake_shared_memory):
    ring = shm.create_ring("s0-tx")
    assert ring.name.startswith("amt-") and ring.name.endswith("-s0-tx")
    assert (ring.nslots, ring.slot_bytes) == shm.ring_sizes()
    peer = shm.attach_ring(ring.name)
    slot, gen = ring.acquire()
    view = ring.slot_view(slot)
    view[:5] = b"cross"
    del view
    ref = ring.publish(slot, gen, 5)
    got = peer.accept(ref)
    assert bytes(got) == b"cross"
    del got
    peer.release(ref.slot)
    peer.close()  # attacher: close only, never unlink
    assert ring.name in fake_shared_memory
    ring.close()  # owner: close + unlink
    assert fake_shared_memory == {}


def test_attach_rejects_non_ring_segment(fake_shared_memory):
    FakeSegment("amt-other", create=True, size=4096)
    with pytest.raises(DecodeError):
        shm.attach_ring("amt-other")


def test_segment_names_never_match_the_jax_glob():
    """The JAX suites' leak checks glob ``/dev/shm/am-*``: the port's ring
    names must never match it."""
    for tag in ("s0-tx", "s7-rx", "x"):
        name = shm.ring_name(tag)
        assert name.startswith("amt-")
        assert not fnmatch.fnmatch(name, "am-*")
    assert fnmatch.fnmatch(jax_shm.ring_name("x"), "am-*")


def test_ring_sizes_env_knobs(monkeypatch):
    monkeypatch.setenv("AM_MESH_SHM_SLOTS", "5")
    monkeypatch.setenv("AM_MESH_SHM_SLOT_BYTES", "8192")
    assert shm.ring_sizes() == (5, 8192)
    monkeypatch.setenv("AM_MESH_SHM_SLOTS", "1")      # floor: 2
    monkeypatch.setenv("AM_MESH_SHM_SLOT_BYTES", "7")  # floor: 4096
    assert shm.ring_sizes() == (2, 4096)


def test_slotref_is_plain_int_and_pickles():
    """Ring fields reach flight events and JSONL dumps: SlotRef fields are
    plain int at construction even when fed np.int64."""
    ref = shm.SlotRef(np.int64(3), np.int64(7), np.int64(4096))
    assert type(ref.slot) is int
    assert type(ref.generation) is int
    assert type(ref.nbytes) is int
    json.dumps({"slot": ref.slot, "generation": ref.generation,
                "nbytes": ref.nbytes})
    clone = pickle.loads(pickle.dumps(ref))
    assert (clone.slot, clone.generation, clone.nbytes) == (3, 7, 4096)
    assert type(clone.slot) is int


# --------------------------------------------------------------------- #
# the farm's wire frames: what crosses a pipe or a ring is host data


class _Unpicklable(Exception):
    def __reduce__(self):
        raise TypeError("no pickling")


def _host_only(x):
    """True when `x` holds no torch tensor (a tensor on a pipe would ride
    as a CUDA IPC handle)."""
    if isinstance(x, dict):
        return all(_host_only(k) and _host_only(v) for k, v in x.items())
    if isinstance(x, (list, tuple, set, frozenset)):
        return all(_host_only(v) for v in x)
    return not isinstance(x, torch.Tensor)


def test_farm_wire_frames_round_trip_host_data_only():
    from automerge_tpu_torch.errors import DeviceFaultError, QuarantinedError
    from automerge_tpu_torch.testing import faults
    from automerge_tpu_torch.tpu.farm import (DocOutcome, FarmApplyResult,
                                              TorchDocFarm, exc_from_blob,
                                              exc_to_blob, result_from_wire,
                                              result_to_wire)

    farm = TorchDocFarm(3, capacity=16, device="cpu")
    change = faults.make_change("aa" * 4, 1, 1, [], [faults.set_op("x", 1)])
    result = farm.apply_changes([[change], [b"\x00garbage"], []])
    assert result.quarantined and result.applied
    wire = result_to_wire(result)
    assert isinstance(wire["patches"], bytes) and _host_only(wire)
    back = result_from_wire(wire)
    assert list(back) == list(result)
    assert [(o.status, o.error_kind, o.offending_hashes, o.fallback)
            for o in back.outcomes] == \
        [(o.status, o.error_kind, o.offending_hashes, o.fallback)
         for o in result.outcomes]
    assert type(back.outcomes[1].error) is type(result.outcomes[1].error)
    # the struct codec carries the outcome tuples in the JAX frame format
    frame = shm.encode_result(wire["patches"], wire["outcomes"])
    assert frame == jax_shm.encode_result(wire["patches"], wire["outcomes"])
    assert shm.decode_result(memoryview(frame))[1] == [
        (s, b, k, tuple(o), f) for s, b, k, o, f in wire["outcomes"]]
    # an exception that will not pickle degrades to a same-kind stand-in
    exc = _Unpicklable("boom")
    exc.kind = "quarantined"
    stand_in = exc_from_blob(exc_to_blob(exc))
    assert isinstance(stand_in, DeviceFaultError)
    assert "[unpicklable _Unpicklable]" in str(stand_in)
    assert exc_to_blob(None) is None and exc_from_blob(None) is None
    assert isinstance(exc_from_blob(exc_to_blob(QuarantinedError("q"))),
                      QuarantinedError)
    # a document export (what migration ships between workers) too
    export = farm.export_doc(0)
    assert _host_only(export)
    assert isinstance(export["rows"]["key"], np.ndarray)
    assert DocOutcome("applied") == back.outcomes[0]
    assert isinstance(back, FarmApplyResult)

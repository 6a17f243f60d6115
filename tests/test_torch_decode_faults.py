"""The decode path on corrupt input, the varint scan and the decode LRU's
budget, the port against the JAX package: twins of
tests/test_decode_vectorized.py's ``TestCorruptInputs``,
``TestLeb128Scan`` and ``TestDecodeCacheBudget``. Each scenario makes the
JAX test's assertions on one package and records the error classes and
messages, the scanned columns and the cache's contents; ``twin_pkgs``
holds the port's record equal to the JAX package's. The device scan runs
on the CPU in both: the JAX one through its Pallas kernel in interpret
mode, the port's through kernel 3's plain segmented sum."""
import random
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_faults_domain import twin_pkgs

CORPUS = ("truncated", "bit_flipped", "corrupt_checksum", "bad_chunk_type",
          "garbage")


def oracle_decode(P, buffer):
    """decode_change through the per-op scalar decoder chain only."""
    with mock.patch.object(P.native, "available", lambda: False):
        with mock.patch.object(P.columnar, "_VECTOR_DECODER", None):
            return P.columnar.decode_change(buffer)


def vector_decode(P, buffer):
    """decode_change through the vectorised backend only (native off)."""
    with mock.patch.object(P.native, "available", lambda: False):
        return P.columnar.decode_change(buffer)


def base_change(P, value):
    return P.faults.make_change("aaaaaaaa", 1, 1, [],
                                [P.faults.set_op("k", value)])


# ---------------------------------------------------------------------- #
# corrupt inputs: the same taxonomy on both decode paths, caches untouched


@pytest.mark.parametrize("name", CORPUS)
def test_same_error_taxonomy(name, monkeypatch):
    def scenario(P, rec):
        corrupter = next(c for c in P.faults.BYTE_CORPUS if c[0] == name)[1]
        bad = bytes(corrupter(base_change(P, 7)))
        with pytest.raises(Exception) as oracle_exc:
            oracle_decode(P, bad)
        with pytest.raises(Exception) as vector_exc:
            vector_decode(P, bad)
        assert type(vector_exc.value) is type(oracle_exc.value)
        assert str(vector_exc.value) == str(oracle_exc.value)
        assert isinstance(vector_exc.value,
                          (P.errors.DecodeError, P.errors.ChecksumError))
        rec.value((bad, type(vector_exc.value).__name__,
                   str(vector_exc.value), P.errors.error_kind(vector_exc.value)))

    twin_pkgs(scenario, monkeypatch)


def test_corrupt_buffers_left_uncached(monkeypatch):
    def scenario(P, rec):
        col = P.columnar
        col.clear_decode_caches()
        base = base_change(P, 7)
        bad = P.faults.truncated(base)
        before = len(col._DECODED_CHANGE_CACHE)
        assert P.decode.warm_decode_cache([base, bad]) == 1
        assert len(col._DECODED_CHANGE_CACHE) == before + 1
        with pytest.raises(P.errors.DecodeError) as exc_info:
            col.decode_change_cached(bad)
        rec.value((sorted(col._DECODED_CHANGE_CACHE._entries),
                   str(exc_info.value)))
        col.clear_decode_caches()

    twin_pkgs(scenario, monkeypatch)


def test_batch_with_one_bad_buffer_raises_like_sequential(monkeypatch):
    def scenario(P, rec):
        good = base_change(P, 1)
        bad = P.faults.garbage(32)
        with pytest.raises(P.errors.DecodeError) as exc_info:
            P.decode.decode_changes_vector([good, bad])
        rec.value((type(exc_info.value).__name__, str(exc_info.value)))

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# the LEB128 scan


def _scan(P, data):
    return [a.tolist() for a in P.decode.leb128_scan(data)]


@pytest.mark.parametrize("seed", range(4))
def test_roundtrip(seed, monkeypatch):
    def scenario(P, rec):
        rng = random.Random(seed)
        uvals = [rng.randrange(0, 2**53) for _ in range(200)]
        ivals = [rng.randrange(-2**52, 2**52) for _ in range(200)]
        ue, ie = P.codecs.Encoder(), P.codecs.Encoder()
        for v in uvals:
            ue.append_uint53(v)
        for v in ivals:
            ie.append_int53(v)
        su = _scan(P, np.frombuffer(ue.buffer, np.uint8))
        assert su[2] == uvals
        si = _scan(P, np.frombuffer(ie.buffer, np.uint8))
        assert si[3] == ivals
        rec.value((bytes(ue.buffer), bytes(ie.buffer), su, si))

    twin_pkgs(scenario, monkeypatch)


def test_truncated_stream_falls_back(monkeypatch):
    def scenario(P, rec):
        enc = P.codecs.Encoder()
        enc.append_uint53(2**40)
        data = np.frombuffer(enc.buffer[:-1], np.uint8)
        with pytest.raises(P.decode._Fallback) as exc_info:
            P.decode.leb128_scan(data)
        rec.value(str(exc_info.value))

    twin_pkgs(scenario, monkeypatch)


def test_wide_varint_falls_back(monkeypatch):
    def scenario(P, rec):
        data = np.frombuffer(bytes([0x80] * 9 + [0x01]), np.uint8)
        with pytest.raises(P.decode._Fallback) as exc_info:
            P.decode.leb128_scan(data)
        rec.value(str(exc_info.value))

    twin_pkgs(scenario, monkeypatch)


def test_device_scan_matches_host(monkeypatch):
    """The device scan (JAX: the Pallas kernel in interpret mode; the port:
    kernel 3's plain segmented sum on a CPU tensor) equals the host pass,
    column by column, dtype included."""
    def scenario(P, rec):
        rng = random.Random(9)
        enc = P.codecs.Encoder()
        for _ in range(300):
            enc.append_uint53(rng.randrange(0, 2**50))
        data = np.frombuffer(enc.buffer, np.uint8)
        host = P.decode.leb128_scan(data)
        dev = P.decode.leb128_scan_device(
            torch.from_numpy(data.copy()) if P.is_port else data)
        for h, d in zip(host, dev):
            assert np.array_equal(h, np.asarray(d))
        rec.value([(str(np.asarray(d).dtype), np.asarray(d).tolist())
                   for d in dev])

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# the decode LRU's byte budget


def test_byte_budget_evicts(monkeypatch):
    def scenario(P, rec):
        cache = P.codecs.DecodeCache(100, name="test.cache.budget",
                                     max_bytes=100)
        for i in range(10):
            cache.put(bytes([i]) * 40, i)
        assert len(cache) <= 3
        assert cache._bytes <= 100
        assert cache.get(bytes([9]) * 40) == 9
        rec.value((len(cache), cache._bytes, list(cache._entries)))

    twin_pkgs(scenario, monkeypatch)


def test_single_oversized_entry_still_caches(monkeypatch):
    def scenario(P, rec):
        cache = P.codecs.DecodeCache(8, name="test.cache.huge", max_bytes=64)
        cache.put(b"x" * 1000, "huge")
        assert cache.get(b"x" * 1000) == "huge"
        assert len(cache) == 1
        rec.value((len(cache), cache._bytes))

    twin_pkgs(scenario, monkeypatch)


def test_entry_count_bound_still_applies(monkeypatch):
    def scenario(P, rec):
        cache = P.codecs.DecodeCache(3, name="test.cache.count",
                                     max_bytes=10**9)
        for i in range(10):
            cache.put(bytes([i]), i)
        assert len(cache) == 3
        rec.value(list(cache._entries))

    twin_pkgs(scenario, monkeypatch)

"""Chunk-level parity of the vectorised columnar decode, the port against
the JAX package: twins of tests/test_decode_vectorized.py's
``TestChunkParity`` (bench.py's change stream, fuzzed changes over the
whole op vocabulary, a deflated change) and ``TestSaveLoadRoundTrip``
(document chunks through save and load).

Each scenario makes the JAX test's assertions on one package (the vector
pass equal to the scalar oracle chain) and records the decoded changes,
patches and saved bytes; ``twin_pkgs`` holds the port's record equal to
the JAX package's. The buffers are the JAX suite's own: bench.py's
stream and the suite's ``_fuzz_change`` generator. The tolerance is zero.
"""
import random
from unittest import mock

import pytest

from test_decode_vectorized import _fuzz_change
from test_torch_decode_faults import oracle_decode, vector_decode
from test_torch_faults_domain import twin_pkgs


def _bench_stream(actors, ops, seed):
    from bench import _make_change_stream

    return _make_change_stream(actors, ops, seed)


# ---------------------------------------------------------------------- #
# TestChunkParity


def test_bench_stream(monkeypatch):
    stream = _bench_stream(6, 48, 3)

    def scenario(P, rec):
        for buf in stream:
            got = vector_decode(P, buf)
            assert got == oracle_decode(P, buf)
            rec.value(got)

    twin_pkgs(scenario, monkeypatch)


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_changes(seed, monkeypatch):
    def scenario(P, rec):
        col = P.columnar
        rng = random.Random(seed)
        known_ops, known_elems = [], []
        start_op, deps = 1, []
        bufs = []
        for i, actor in enumerate(["aaaaaaaa", "bbbbbbbb", "cdcdcdcd"] * 3):
            change, start_op = _fuzz_change(
                rng, actor, i // 3 + 1, start_op, deps, known_ops,
                known_elems)
            buf = col.encode_change(change)
            deps = [col.decode_change_columns(buf)["hash"]]
            bufs.append(buf)
        oracle = [oracle_decode(P, b) for b in bufs]
        for b, expected in zip(bufs, oracle):
            assert vector_decode(P, b) == expected
        with mock.patch.object(P.native, "available", lambda: False):
            assert P.decode.decode_changes_vector(bufs) == oracle
        rec.changes(bufs)
        rec.value(oracle)

    twin_pkgs(scenario, monkeypatch)


def test_deflated_change(monkeypatch):
    def scenario(P, rec):
        big = P.faults.make_change(
            "aaaaaaaa", 1, 1, [],
            [P.faults.set_op(f"key{i}", i) for i in range(200)])
        got = vector_decode(P, big)
        assert len(big) > 0 and got == oracle_decode(P, big)
        rec.changes([big])
        rec.value(got)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# TestSaveLoadRoundTrip


@pytest.mark.parametrize("seed", range(3))
def test_document_chunks(seed, monkeypatch):
    stream = _bench_stream(5, 24, 200 + seed)

    def scenario(P, rec):
        B, col, faults = P.backend, P.columnar, P.faults
        b = B.init()
        for buf in stream:
            b, _ = B.apply_changes(b, [buf])
        ops = [
            {"action": "set", "obj": "_root", "key": "c",
             "datatype": "counter", "value": 5, "pred": []},
            {"action": "makeMap", "obj": "_root", "key": "child",
             "pred": []},
        ]
        c1 = faults.make_change("bbbbbbbb", 1, 1, B.get_heads(b), ops)
        b, _ = B.apply_changes(b, [c1])
        h1 = col.decode_change_columns(c1)["hash"]
        ops2 = [
            {"action": "inc", "obj": "_root", "key": "c", "value": 3,
             "pred": ["1@bbbbbbbb"]},
            {"action": "set", "obj": "2@bbbbbbbb", "key": "nested",
             "value": "x", "pred": []},
        ]
        c2 = faults.make_change("bbbbbbbb", 2, 3, [h1], ops2)
        b, _ = B.apply_changes(b, [c2])
        saved = B.save(b)
        with mock.patch.object(P.native, "available", lambda: False):
            with mock.patch.object(col, "_VECTOR_DECODER", None):
                oracle_patch = B.get_patch(B.load(saved))
            vector_patch = B.get_patch(B.load(saved))
        assert vector_patch == oracle_patch
        assert B.save(B.load(saved)) == saved
        rec.value(saved)
        rec.patch(vector_patch)

    twin_pkgs(scenario, monkeypatch)

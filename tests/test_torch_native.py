"""The port's native C++ codec path (``automerge_tpu_torch.native``, built
from the repo's ``native/codecs.cpp`` with ``g++`` into ``build/native/``):
twins of tests/test_native.py (byte identity against the pure-Python
codecs on randomized columns, both directions), the port's native output
against the JAX package's on the same columns, and each branch the port
restores held to the pure path it bypasses: ``columnar._native_change_ops``,
``OpSet._encode_ops_columns_native`` and the strRLE assist in
``tpu/decode``.
"""
import random

import numpy as np
import pytest

from automerge_tpu import native as jax_native
from automerge_tpu_torch import columnar, native
from automerge_tpu_torch.codecs import (
    BooleanEncoder,
    DeltaEncoder,
    RLEEncoder,
)
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.opset import OpSet
from automerge_tpu_torch.tpu import decode
from test_farm import Workload

ACTOR = "0123456789abcdef"


def random_column(rng, n, null_prob=0.3, value_range=1000):
    vals = []
    while len(vals) < n:
        run = rng.randrange(1, 6)
        if rng.random() < null_prob:
            vals += [None] * run
        else:
            vals += [rng.randrange(value_range)] * run
    return vals[:n]


def to_arr(vals):
    return np.array(
        [native.NULL_SENTINEL if v is None else v for v in vals], np.int64
    )


def list_change():
    return {"actor": ACTOR, "seq": 1, "startOp": 1, "time": 0, "deps": [],
            "ops": [
                {"action": "makeList", "obj": "_root", "key": "list",
                 "pred": []},
                {"action": "set", "obj": f"1@{ACTOR}", "elemId": "_head",
                 "insert": True, "values": [1, 2, 3, 4], "datatype": "uint",
                 "pred": []},
                {"action": "makeText", "obj": "_root", "key": "text",
                 "pred": []},
                {"action": "set", "obj": f"6@{ACTOR}", "elemId": "_head",
                 "insert": True, "values": list("hello"), "pred": []},
                {"action": "set", "obj": "_root", "key": "title",
                 "value": "hi", "pred": []},
            ]}


def corpus():
    """Change buffers with map keys, list and text inserts, counters,
    nested objects and deletes."""
    gen = OpSet()
    w = Workload(5)
    bufs = [encode_change(list_change())]
    for _ in range(12):
        bufs.extend(w.next_round(gen))
    return bufs


def test_library_builds_beside_the_package_not_into_native():
    assert native.available(), native.load_error
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert path.exists()
    assert native.SOURCE.name == "codecs.cpp"


def test_available_is_false_without_a_compiler(monkeypatch, tmp_path):
    """No g++ (or a failing build) leaves the pure codecs serving every
    call, and says why."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "load_error", None)
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    assert not native.available()
    assert "not found" in native.load_error
    assert not (tmp_path / "build").exists()


class TestNativeCodecs:
    def test_rle_differential(self):
        rng = random.Random(1)
        for _ in range(100):
            vals = random_column(rng, rng.randrange(0, 60))
            e = RLEEncoder("uint")
            for v in vals:
                e.append_value(v)
            py_bytes = e.buffer
            assert native.rle_encode(to_arr(vals)) == py_bytes
            if py_bytes:
                assert list(native.rle_decode(py_bytes)) == \
                    list(to_arr(vals))

    def test_delta_differential(self):
        rng = random.Random(2)
        for _ in range(100):
            vals = random_column(rng, rng.randrange(0, 60),
                                 value_range=10**6)
            e = DeltaEncoder()
            for v in vals:
                e.append_value(v)
            py_bytes = e.buffer
            assert native.delta_encode(to_arr(vals)) == py_bytes
            if py_bytes:
                assert list(native.delta_decode(py_bytes)) == \
                    list(to_arr(vals))

    def test_bool_differential(self):
        rng = random.Random(3)
        for _ in range(100):
            vals = [rng.random() < 0.5 for _ in range(rng.randrange(0, 60))]
            e = BooleanEncoder()
            for v in vals:
                e.append_value(v)
            py_bytes = e.buffer
            assert native.bool_encode(np.array(vals, np.uint8)) == py_bytes
            assert list(native.bool_decode(py_bytes)) == vals

    def test_signed_rle(self):
        vals = [-5, -5, None, 3, -100000, 7]
        arr = to_arr(vals)
        e = RLEEncoder("int")
        for v in vals:
            e.append_value(v)
        assert native.rle_encode(arr, signed=True) == e.buffer
        assert list(native.rle_decode(e.buffer, signed=True)) == list(arr)

    def test_decode_detects_truncation(self):
        e = RLEEncoder("uint")
        for v in [1, 2, 3, 4, 5]:
            e.append_value(v)
        with pytest.raises(ValueError):
            native.rle_decode(e.buffer[:-1])

    def test_document_save_via_native_matches(self):
        """The document op-column encode gives identical bytes whether the
        numeric columns are encoded natively or in Python."""
        opset = OpSet()
        opset.apply_changes([encode_change(list_change())])
        python_cols = opset._encode_ops_columns(force_python=True)
        native_cols = opset._encode_ops_columns()
        assert [(cid, bytes(buf)) for cid, buf in python_cols] == [
            (cid, bytes(buf)) for cid, buf in native_cols
        ]


def test_native_output_equals_the_jax_packages():
    """Both libraries come from the same source: the same columns encode
    and decode to the same bytes and arrays."""
    assert jax_native.available()
    assert native.NULL_SENTINEL == jax_native.NULL_SENTINEL
    rng = random.Random(4)
    for _ in range(50):
        arr = to_arr(random_column(rng, rng.randrange(1, 60),
                                   value_range=10**6))
        for enc in ("rle_encode", "delta_encode"):
            got = getattr(native, enc)(arr)
            assert got == getattr(jax_native, enc)(arr)
            dec = enc.replace("encode", "decode")
            assert np.array_equal(getattr(native, dec)(got),
                                  getattr(jax_native, dec)(got))
        bits = (arr % 2 == 0).astype(np.uint8)
        assert native.bool_encode(bits) == jax_native.bool_encode(bits)
    for buf in corpus():
        for c in columnar.decode_change_columns(buf)["columns"]:
            col = bytes(c["buffer"])
            if c["columnId"] & 7 == columnar.ColumnType.STRING_RLE and col:
                blob, offs = native.strrle_decode(col)
                jblob, joffs = jax_native.strrle_decode(col)
                # the blob past the last string is scratch space
                assert np.array_equal(offs, joffs)
                assert [blob[a:b] for a, b in offs] == \
                    [jblob[a:b] for a, b in joffs]


def test_native_change_ops_equal_the_pure_decoders():
    """``columnar._native_change_ops`` (the first fast path of
    ``decode_change``) against the per-op decoder chain and the vector
    pass, change by change."""
    seen = 0
    for buf in corpus():
        change = columnar.decode_change_columns(buf)
        cols = [(c["columnId"], c["buffer"]) for c in change["columns"]]
        got = columnar._native_change_ops(cols, change["actorIds"])
        assert got is not None
        pure = columnar.decode_ops(columnar.decode_columns(
            cols, change["actorIds"], columnar.CHANGE_COLUMNS), False)
        assert got == pure
        assert got == decode._vector_change_ops(cols, change["actorIds"])
        seen += len(got)
    assert seen > 50


def test_strrle_assist_equals_the_python_walk(monkeypatch):
    """The vector pass decodes string-RLE columns through the native
    library when it is there: every change decodes to the same ops with
    the assist and without it."""
    bufs = corpus()
    keystr = 0
    for buf in bufs:
        for c in columnar.decode_change_columns(buf)["columns"]:
            if c["columnId"] & 7 == columnar.ColumnType.STRING_RLE and \
                    c["buffer"]:
                col = bytes(c["buffer"])
                blob, offs = native.strrle_decode(col)
                pblob, poffs = decode._strrle_expand(col)
                assert [blob[a:b] if a >= 0 else None for a, b in offs] == \
                    [pblob[a:b] if a >= 0 else None for a, b in poffs]
                keystr += 1
    assert keystr > 0
    with_assist = decode.decode_changes_vector(bufs)
    monkeypatch.setattr(decode.native, "available", lambda: False)
    assert decode.decode_changes_vector(bufs) == with_assist


def test_encode_ops_columns_native_equals_python_on_a_workload():
    """``OpSet._encode_ops_columns_native`` against the Python encoders on
    a document with maps, counters, nesting, deletes, lists and text, and
    the saved document is the same either way."""
    opset = OpSet()
    opset.apply_changes(corpus())
    python_cols = opset._encode_ops_columns(force_python=True)
    native_cols = opset._encode_ops_columns_native()
    assert native_cols is not None
    assert [(cid, bytes(buf)) for cid, buf in python_cols] == [
        (cid, bytes(buf)) for cid, buf in native_cols]

"""The port's change LRU keeps each decoded change as a record the cyclic
collector does not track (``columnar.change_record``), and
``decode_change_cached`` builds a fresh dict view from it.

Corpora: the reference byte corpus of tests/test_decode_vectorized.py
(bench.py's change stream, the fuzzed changes over the whole op
vocabulary and every value datatype, the deflated change), generated
map, counter, list and text changes, deflated ones, and the same
changes with the batched vector pass disabled, so that their records
come from the per-op decoder chain's dicts. Every case fills the LRU
through ``warm_decode_cache``, as the farm's decode phase does."""
import gc
import random
from unittest import mock

import pytest

from automerge_tpu_torch import columnar as col
from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
from automerge_tpu_torch.tpu import decode as dec
from test_decode_vectorized import _fuzz_change

ACTOR = "aaaaaaaa"
#: CPython untracks a tuple once every item is untracked, and a collection
#: examines a tuple before the tuples it reaches, so each collection
#: untracks one more level of a nested record: pred, op, ops, change.
RECORD_DEPTH = 4


def _change(seq, start_op, deps, ops, actor=ACTOR, message=""):
    return col.encode_change({
        "actor": actor, "seq": seq, "startOp": start_op, "time": 7,
        "message": message, "deps": deps, "ops": ops})


def _chain(op_lists, actor=ACTOR):
    """One actor's changes, each on the previous one."""
    bufs, start_op, deps = [], 1, []
    for seq, ops in enumerate(op_lists, 1):
        buf = _change(seq, start_op, deps, ops, actor)
        deps = [col.decode_change_columns(buf)["hash"]]
        start_op += len(ops)
        bufs.append(buf)
    return bufs


def _reference():
    from bench import _make_change_stream

    bufs = list(_make_change_stream(6, 48, 3))
    for seed in range(6):
        rng = random.Random(seed)
        known_ops, known_elems = [], []
        start_op, deps = 1, []
        for i, actor in enumerate(["aaaaaaaa", "bbbbbbbb", "cdcdcdcd"] * 3):
            change, start_op = _fuzz_change(
                rng, actor, i // 3 + 1, start_op, deps, known_ops,
                known_elems)
            buf = col.encode_change(change)
            deps = [col.decode_change_columns(buf)["hash"]]
            bufs.append(buf)
    bufs.append(_change(1, 1, [], [
        {"action": "set", "obj": "_root", "key": f"key{i}",
         "datatype": "uint", "value": i, "pred": []} for i in range(200)]))
    return bufs


#: one value of every datatype the wire format encodes
VALUES = [
    {"value": None}, {"value": True}, {"value": False},
    {"value": -5, "datatype": "int"}, {"value": 5, "datatype": "uint"},
    {"value": 2.5, "datatype": "float64"},
    {"value": 3, "datatype": "counter"},
    {"value": 1_700_000_000_000, "datatype": "timestamp"},
    {"value": b"\x00\xffbytes"}, {"value": "str ☃"},
]


def _map():
    child = f"1@{ACTOR}"
    first = [{"action": "makeMap", "obj": "_root", "key": "m", "pred": []}]
    first += [dict(v, action="set", obj=child, key=f"f{i}", pred=[])
              for i, v in enumerate(VALUES)]
    second = [dict(v, action="set", obj=child, key=f"f{i}",
                   pred=[f"{i + 2}@{ACTOR}"])
              for i, v in enumerate(reversed(VALUES))]
    second.append({"action": "del", "obj": child, "key": "f0",
                   "pred": [f"{len(VALUES) + 1 + 1}@{ACTOR}"]})
    bufs = _chain([first, second])
    # a change with bytes after its columns keeps them as extraBytes
    bufs.append(col.encode_change({
        "actor": "bbbbbbbb", "seq": 1, "startOp": 1, "time": 0,
        "message": "extra", "deps": [], "extraBytes": b"\x01\x02",
        "ops": [dict(VALUES[4], action="set", obj="_root", key="k",
                     pred=[])]}))
    assert "extraBytes" in col.decode_change(bufs[-1])
    return bufs


def _counter():
    make = [{"action": "set", "obj": "_root", "key": "c", "value": 0,
             "datatype": "counter", "pred": []}]
    incs = [{"action": "inc", "obj": "_root", "key": "c", "value": 1,
             "pred": [f"1@{ACTOR}"]} for _ in range(64)]
    return _chain([make, incs, incs, incs])


def _sequence(make, values):
    obj = f"1@{ACTOR}"
    ops = [{"action": make, "obj": "_root", "key": "s", "pred": []}]
    prev = "_head"
    for i, v in enumerate(values):
        ops.append(dict(v, action="set", obj=obj, elemId=prev, insert=True,
                        pred=[]))
        prev = f"{i + 2}@{ACTOR}"
    n = len(ops)
    edits = [
        {"action": "del", "obj": obj, "elemId": f"2@{ACTOR}",
         "pred": [f"2@{ACTOR}"]},
        dict(values[0], action="set", obj=obj, elemId=f"3@{ACTOR}",
             pred=[f"3@{ACTOR}"]),
        dict(values[-1], action="set", obj=obj, elemId=prev, insert=True,
             pred=[]),
        {"action": "makeMap", "obj": obj, "elemId": f"{n + 3}@{ACTOR}",
         "insert": True, "pred": []},
    ]
    return _chain([ops, edits])


def _list():
    return _sequence("makeList", VALUES)


def _text():
    return _sequence("makeText", [{"value": ch} for ch in "héllo wörld"])


def _deflated():
    def many(n):
        return [{"action": "set", "obj": "_root", "key": f"k{i}",
                 "value": f"{n} " + "x" * 40, "pred": []} for i in range(64)]

    bufs = _chain([many(1), many(2)])
    assert all(buf[8] == col.CHUNK_TYPE_DEFLATE for buf in bufs)
    return bufs


def _generated():
    return _map() + _counter() + _list() + _text()


CORPORA = {
    "reference": _reference,
    "map": _map,
    "counter": _counter,
    "list": _list,
    "text": _text,
    "deflated": _deflated,
    "per_op_chain": _generated,
}


@pytest.fixture
def warmed(request):
    """The corpus's buffers, decoded into an emptied change LRU by
    ``warm_decode_cache``; the per_op_chain corpus takes the fallback that
    converts decode_change's dicts at put."""
    name = request.param
    bufs = CORPORA[name]()
    col.clear_decode_caches()
    if name == "per_op_chain":
        with mock.patch.object(dec, "_collect_columns", lambda cols: None), \
                mock.patch.object(dec.native, "available", lambda: False):
            assert dec.warm_decode_cache(bufs) == len(set(bufs))
    else:
        assert dec.warm_decode_cache(bufs) == len(set(bufs))
    yield bufs
    col.clear_decode_caches()


def _tracked_reachable(root):
    """The GC-tracked objects reachable from `root`, itself included."""
    found, seen, stack = [], {id(root)}, [root]
    while stack:
        obj = stack.pop()
        if gc.is_tracked(obj):
            found.append(obj)
        for ref in gc.get_referents(obj):
            if id(ref) not in seen:
                seen.add(id(ref))
                stack.append(ref)
    return found


@pytest.mark.parametrize("warmed", list(CORPORA), indirect=True)
def test_lru_entries_are_untracked(warmed):
    for _ in range(RECORD_DEPTH):
        gc.collect()
    entries = col._DECODED_CHANGE_CACHE._entries
    assert len(entries) == len(set(warmed))
    for key, record in entries.items():
        assert type(key) is bytes
        tracked = _tracked_reachable(record)
        assert not tracked, [type(o).__name__ for o in tracked]


def _assert_same(view, expected):
    assert view == expected
    assert list(view) == list(expected)
    assert type(view["ops"]) is list and type(view["deps"]) is list
    for op, want in zip(view["ops"], expected["ops"]):
        assert list(op) == list(want)
        assert type(op["pred"]) is list


@pytest.mark.parametrize("warmed", list(CORPORA), indirect=True)
def test_views_equal_decode_change(warmed):
    for buf in warmed:
        _assert_same(col.decode_change_cached(buf), col.decode_change(buf))
    assert dec.decode_changes_vector(warmed) == [
        col.decode_change(buf) for buf in warmed]


@pytest.mark.parametrize("warmed", ["reference"], indirect=True)
def test_a_mutated_view_leaves_the_next_unchanged(warmed):
    for buf in warmed:
        expected = col.decode_change(buf)
        view = col.decode_change_cached(buf)
        view["buffer"] = buf
        view["deps"].append("00" * 32)
        view["ops"][0]["pred"].append(f"99@{ACTOR}")
        view["ops"][0]["action"] = "del"
        view["ops"].append({"action": "set", "obj": "_root", "key": "x"})
        _assert_same(col.decode_change_cached(buf), expected)


def test_views_counts_one_view_per_hit():
    bufs = _counter()
    col.clear_decode_caches()
    reg = get_metrics()
    reg.reset()
    try:
        with enabled_metrics():
            col.decode_change_cached(bufs[0])   # a miss: no view
            assert reg.counter("codecs.decode_cache.views").value == 0
            dec.warm_decode_cache(bufs)
            hits = reg.counter("codecs.decode_cache.hits").value
            for _ in range(3):
                for buf in bufs:
                    col.decode_change_cached(buf)
            assert reg.counter("codecs.decode_cache.views").value == \
                3 * len(bufs)
            assert reg.counter("codecs.decode_cache.hits").value - hits == \
                3 * len(bufs)
    finally:
        reg.reset()
        col.clear_decode_caches()

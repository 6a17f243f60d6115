"""The engine-level API, the port against the JAX package on the CPU: each
scenario of the JAX ``tests/test_tpu_engine.py`` runs through both
packages' ``BatchTranscoder`` + ``BatchedMapEngine`` on the same op
stream. Every ``decode_visible`` must equal the JAX package's and the
scenario's expected document (the sequential ``OpSet``'s visible tree for
the differential cases), and the visibility rows the decode reads must be
equal column by column. The last test runs phase 20's transcoder driver
(``chip_smoke.run_transcoder``) on both packages."""
import random

import numpy as np
import torch

import automerge_tpu.tpu as jax_tpu
import automerge_tpu_torch.tpu as port_tpu
import chip_smoke
from automerge_tpu.columnar import encode_change
from automerge_tpu.opset import OpSet
from test_tpu_engine import opset_visible_map, opset_visible_tree

A, B = "aaaaaaaa", "bbbbbbbb"


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def twin(num_docs, capacity, rounds, counter_keys=None, width=None):
    """Runs `rounds` (one list of per-doc ``(op, counter, actor)`` rows per
    ``apply_batch``) through both packages; asserts equal visibility rows
    and equal decoded documents, and returns the port's documents.
    `counter_keys[d]` names the root keys of doc d that hold counters."""
    counter_keys = counter_keys or [()] * num_docs
    out = {}
    for name, tpu, kwargs in (("jax", jax_tpu, {}),
                              ("port", port_tpu, {"device": "cpu"})):
        engine = tpu.BatchedMapEngine(num_docs, capacity=capacity, **kwargs)
        tr = tpu.BatchTranscoder()
        for rows in rounds:
            engine.apply_batch(tr.changes_to_batch(rows, width=width,
                                                   **kwargs))
        keys, ops, visible, winners, values = engine.visible_state()
        docs = [
            tr.decode_visible(keys[d], ops[d], winners[d], values[d],
                              {tr.slot_id("_root", k)
                               for k in counter_keys[d]})
            for d in range(num_docs)
        ]
        out[name] = (docs, [_host(c) for c in
                            (keys, ops, visible, winners, values)], tr)
    for got, want in zip(out["port"][1], out["jax"][1]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][2].object_types == out["jax"][2].object_types
    return out["port"][0], out["port"][2]


def set_op(key, value, pred=(), obj="_root", **extra):
    return {"action": "set", "obj": obj, "key": key, "value": value,
            "pred": list(pred), **extra}


def differential_rounds(num_docs, num_rounds, ops_per_round, seed,
                        with_counters=False):
    """The op stream of the JAX suite's ``run_differential`` (same draws,
    same order), with the sequential ``OpSet`` per doc as the oracle.
    Returns (rounds, expected documents, counter keys per doc)."""
    rng = random.Random(seed)
    actors = ["aaaaaaaa", "bbbbbbbb", "cccccccc"]
    keys = [f"k{i}" for i in range(8)]
    opsets = [OpSet() for _ in range(num_docs)]
    last_op = [{} for _ in range(num_docs)]
    seqs = [dict.fromkeys(actors, 0) for _ in range(num_docs)]
    max_ops = [0] * num_docs
    counter_keys = [set() for _ in range(num_docs)]
    rounds = []
    for _ in range(num_rounds):
        per_doc_rows = []
        for d in range(num_docs):
            actor = rng.choice(actors)
            seqs[d][actor] += 1
            start_op = max_ops[d] + 1
            ops = []
            for _i in range(rng.randrange(1, ops_per_round + 1)):
                key = rng.choice(keys)
                prev = last_op[d].get(key)
                if with_counters and prev and prev[1] == "counter" and \
                        rng.random() < 0.5:
                    op = {"action": "inc", "obj": "_root", "key": key,
                          "value": rng.randrange(1, 10), "pred": [prev[0]]}
                elif with_counters and prev is None and rng.random() < 0.3:
                    op = set_op(key, rng.randrange(100), datatype="counter")
                else:
                    if prev and prev[1] == "counter":
                        continue
                    op = set_op(key, rng.randrange(1000),
                                [prev[0]] if prev else (), datatype="uint")
                ops.append(op)
            change = {"actor": actor, "seq": seqs[d][actor],
                      "startOp": start_op, "time": 0,
                      "deps": opsets[d].heads, "ops": ops}
            rows = []
            ctr = start_op
            for op in ops:
                if op["action"] == "set":
                    counter = op.get("datatype") == "counter"
                    last_op[d][op["key"]] = (
                        f"{ctr}@{actor}", "counter" if counter else "plain")
                    if counter:
                        counter_keys[d].add(op["key"])
                rows.append((op, ctr, actor))
                ctr += 1
            max_ops[d] = ctr - 1
            opsets[d].apply_changes([encode_change(change)])
            per_doc_rows.append(rows)
        rounds.append(per_doc_rows)
    return rounds, [opset_visible_map(o) for o in opsets], counter_keys


class TestBatchedMapEngine:
    def test_basic_set_and_overwrite(self):
        docs, _ = twin(2, 16, [
            [[(set_op("x", 1), 1, A), (set_op("y", 2), 2, A)],
             [(set_op("x", 9), 1, B)]],
            [[(set_op("x", 5, ["1@aaaaaaaa"]), 3, A)], []],
        ])
        assert docs == [{"x": 5, "y": 2}, {"x": 9}]

    def test_concurrent_conflict_max_opid_wins(self):
        docs, _ = twin(1, 16, [
            [[(set_op("k", "a"), 1, A), (set_op("k", "b"), 1, B)]],
        ])
        assert docs == [{"k": "b"}]  # same counter, higher actor wins

    def test_delete(self):
        docs, _ = twin(1, 16, [
            [[(set_op("k", 1), 1, A)]],
            [[({"action": "del", "obj": "_root", "key": "k",
                "pred": ["1@aaaaaaaa"]}, 2, A)]],
        ])
        assert docs == [{}]

    def test_counter_increments(self):
        inc = {"action": "inc", "obj": "_root", "key": "c",
               "pred": ["1@aaaaaaaa"]}
        docs, _ = twin(1, 16, [
            [[(set_op("c", 10, datatype="counter"), 1, A)]],
            [[({**inc, "value": 3}, 2, A), ({**inc, "value": 4}, 2, B)]],
        ], counter_keys=[{"c"}])
        assert docs == [{"c": 17}]

    def test_differential_vs_opset(self):
        rounds, expected, ck = differential_rounds(4, 6, 4, 42)
        docs, _ = twin(4, 64, rounds, ck)
        assert docs == expected

    def test_differential_with_counters(self):
        rounds, expected, ck = differential_rounds(3, 5, 3, 7,
                                                   with_counters=True)
        docs, _ = twin(3, 64, rounds, ck)
        assert docs == expected


class TestNestedObjects:
    def test_make_map_and_set_inside(self):
        docs, _ = twin(1, 16, [
            [[({"action": "makeMap", "obj": "_root", "key": "child",
                "pred": []}, 1, A),
              (set_op("x", 7, obj="1@aaaaaaaa"), 2, A)]],
        ])
        assert docs == [{"child": {"x": 7}}]

    def test_overwriting_child_ref_hides_subtree(self):
        docs, _ = twin(1, 16, [
            [[({"action": "makeMap", "obj": "_root", "key": "c",
                "pred": []}, 1, A),
              (set_op("x", 1, obj="1@aaaaaaaa"), 2, A),
              (set_op("c", "gone", ["1@aaaaaaaa"]), 3, A)]],
        ])
        assert docs == [{"c": "gone"}]

    def test_table_rows(self):
        docs, tr = twin(1, 16, [
            [[({"action": "makeTable", "obj": "_root", "key": "t",
                "pred": []}, 1, A),
              ({"action": "makeMap", "obj": "1@aaaaaaaa", "key": "row-1",
                "pred": []}, 2, A),
              (set_op("name", "ada", obj="2@aaaaaaaa"), 3, A)]],
        ])
        assert docs == [{"t": {"row-1": {"name": "ada"}}}]
        assert tr.object_types["1@aaaaaaaa"] == "table"

    def test_nested_differential_vs_opset(self):
        rng = random.Random(99)
        actors = [A, B]
        num_docs, num_rounds = 3, 8
        opsets = [OpSet() for _ in range(num_docs)]
        objects = [["_root"] for _ in range(num_docs)]
        last_op = [{} for _ in range(num_docs)]
        seqs = [dict.fromkeys(actors, 0) for _ in range(num_docs)]
        max_ops = [0] * num_docs
        rounds = []
        for _ in range(num_rounds):
            per_doc_rows = []
            for d in range(num_docs):
                actor = rng.choice(actors)
                seqs[d][actor] += 1
                start_op = max_ops[d] + 1
                ops = []
                ctr = start_op
                for _i in range(rng.randrange(1, 5)):
                    obj = rng.choice(objects[d])
                    key = f"k{rng.randrange(4)}"
                    prev = last_op[d].get((obj, key))
                    roll = rng.random()
                    if roll < 0.25:
                        op = {"action": "makeMap", "obj": obj, "key": key,
                              "pred": [prev] if prev else []}
                        objects[d].append(f"{ctr}@{actor}")
                    elif roll < 0.35 and prev:
                        op = {"action": "del", "obj": obj, "key": key,
                              "pred": [prev]}
                    else:
                        op = set_op(key, rng.randrange(1000),
                                    [prev] if prev else (), obj=obj,
                                    datatype="uint")
                    if op["action"] == "del":
                        last_op[d].pop((obj, key), None)
                    else:
                        last_op[d][(obj, key)] = f"{ctr}@{actor}"
                    ops.append(op)
                    ctr += 1
                max_ops[d] = ctr - 1
                change = {"actor": actor, "seq": seqs[d][actor],
                          "startOp": start_op, "time": 0,
                          "deps": opsets[d].heads, "ops": ops}
                opsets[d].apply_changes([encode_change(change)])
                per_doc_rows.append(
                    [(op, start_op + i, actor) for i, op in enumerate(ops)])
            rounds.append(per_doc_rows)
        # fixed width => one shape bucket across rounds
        docs, _ = twin(num_docs, 128, rounds, width=4)
        assert docs == [opset_visible_tree(o.get_patch()["diffs"])
                        for o in opsets]


def test_phase20_transcoder_driver_matches_jax_and_opset():
    """Phase 20's ``BatchTranscoder`` round (``transcoder_stream`` through
    ``run_transcoder``: nested maps, tables, deletes, counters) at 16 docs:
    the port on the CPU equals the JAX package, and both equal the
    sequential ``OpSet`` fed the same changes."""
    stream, counters = chip_smoke.transcoder_stream(16, 8, 6, 3)
    got = chip_smoke.run_transcoder("cpu", stream, counters)
    want = chip_smoke.run_transcoder(None, stream, counters, tpu=jax_tpu)
    assert got == want
    opsets = [OpSet() for _ in range(16)]
    for per_doc in stream:
        for d, (actor, seq, start, ops) in enumerate(per_doc):
            opsets[d].apply_changes([encode_change(
                {"actor": actor, "seq": seq, "startOp": start, "time": 0,
                 "deps": opsets[d].heads, "ops": ops})])
    assert got == [opset_visible_map(o) for o in opsets]
    assert any(counters) and any("makeTable" in repr(s) for s in stream)

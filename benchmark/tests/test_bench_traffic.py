"""The generator and its frozen encoder."""
import json
import os
import random

import pytest
from conftest import CELLS

from harness import encoder as E
from harness import traffic

SEED = 2**33 + 12345


def _stream(root, cell, seed=SEED):
    import run

    _, _, cfg, mix = run.load_cell(cell, root)
    return traffic.make_stream(cfg, mix, seed)


@pytest.mark.parametrize("cell", CELLS)
def test_stream_is_made_from_the_seed(tiny_root, cell):
    a, b = _stream(tiny_root, cell), _stream(tiny_root, cell)
    assert a.changes.data == b.changes.data
    assert a.steps == b.steps
    other = _stream(tiny_root, cell, SEED + 1)
    assert other.changes.data != a.changes.data


@pytest.mark.parametrize("cell", CELLS)
def test_no_two_documents_share_a_change(tiny_root, cell):
    ch = _stream(tiny_root, cell).changes
    assert len(set(ch.hash)) == len(ch.hash)
    docs_of_actor = {}
    for d, a in zip(ch.doc, ch.actor):
        docs_of_actor.setdefault(a, set()).add(d)
    assert all(len(ds) == 1 for ds in docs_of_actor.values())


@pytest.mark.parametrize("cell", ["map-ingest-1k", "counter-64a"])
def test_worker_processes_change_no_byte(tiny_root, cell, monkeypatch):
    one = _stream(tiny_root, cell)
    monkeypatch.setattr(traffic, "workers", lambda total: 3)
    three = _stream(tiny_root, cell)
    assert three.changes.data == one.changes.data
    assert three.steps == one.steps


def test_encoder_matches_the_ports_encoder_on_set_changes():
    from automerge_tpu_torch.columnar import encode_change

    rng = random.Random(7)
    for _ in range(300):
        actors = [bytes(rng.randrange(256) for _ in range(16))
                  for _ in range(rng.randrange(1, 6))]
        author = actors[0]
        n = rng.choice([1, 1, 1, 10, rng.randrange(1, 12)])
        keys = sorted(rng.sample(range(12), n)) if rng.random() < 0.5 \
            else [rng.randrange(12) for _ in range(n)]
        values = ["".join(chr(rng.randrange(32, 96))
                          for _ in range(rng.choice([0, 1, 100, 300])))
                  for _ in range(n)]
        preds = [sorted({(rng.randrange(1, 5000), rng.choice(actors).hex())
                         for _ in range(rng.randrange(0, 5))})
                 for _ in range(n)]
        deps = [bytes(rng.randrange(256) for _ in range(32))
                for _ in range(rng.randrange(0, 9))]
        seq, start = rng.randrange(1, 100), rng.randrange(1, 10000)
        others = sorted({a for ps in preds for _, a in ps} - {author.hex()})
        slot = {author.hex(): 0, **{a: k + 1 for k, a in enumerate(others)}}
        _, got = E.container(
            E.change_head(author, seq, start, deps,
                          [bytes.fromhex(a) for a in others])
            + E.set_ops_blob([E.utf8(f"field{k}") for k in keys],
                             [v.encode() for v in values],
                             [[(c, slot[a]) for c, a in ps] for ps in preds]))
        want = encode_change({
            "actor": author.hex(), "seq": seq, "startOp": start, "time": 0,
            "deps": [d.hex() for d in deps],
            "ops": [{"action": "set", "obj": "_root", "key": f"field{k}",
                     "value": v, "pred": [f"{c}@{a}" for c, a in ps]}
                    for k, v, ps in zip(keys, values, preds)]})
        assert got == want


def test_encoder_matches_the_ports_encoder_on_counter_changes():
    from automerge_tpu_torch.columnar import encode_change

    creator, other, dep = bytes(range(8)), bytes(range(8, 16)), bytes(32)
    want = encode_change({"actor": creator.hex(), "seq": 1, "startOp": 1,
                          "time": 0, "deps": [], "ops": [
                              {"action": "set", "obj": "_root", "key": "c",
                               "value": 0, "datatype": "counter",
                               "pred": []}]})
    assert E.container(E.change_head(creator, 1, 1, [], [])
                       + E.counter_set_blob("c"))[1] == want
    inc = [{"action": "inc", "obj": "_root", "key": "c", "value": 1,
            "pred": [f"1@{creator.hex()}"]}] * 64
    for author, others, pred_actor in ((other, [creator], 1),
                                       (creator, [], 0)):
        want = encode_change({"actor": author.hex(), "seq": 3,
                              "startOp": 130, "time": 0,
                              "deps": [dep.hex()], "ops": inc})
        got = E.container(E.change_head(author, 3, 130, [dep], others)
                          + E.counter_incs_blob("c", 64, pred_actor, 1))[1]
        assert got == want


@pytest.mark.parametrize("cell", CELLS)
def test_generated_changes_decode_to_their_records(tiny_root, cell):
    from automerge_tpu_torch.columnar import decode_change

    ch = _stream(tiny_root, cell).changes
    for i in range(0, len(ch), max(1, len(ch) // 40)):
        c = decode_change(ch.data[i])
        assert (c["actor"], c["seq"], c["startOp"], c["hash"]) == (
            ch.actor[i], ch.seq[i], ch.start_op[i], ch.hash[i])
        assert sorted(c["deps"]) == sorted(ch.deps[i])
        assert len(c["ops"]) == ch.nops[i]
        if ch.schema == "ycsb":
            assert [op["key"] for op in c["ops"]] == [f"field{k}"
                                                      for k in ch.keys[i]]
            assert [op["value"] for op in c["ops"]] == ch.values[i]
            assert [sorted(op["pred"]) for op in c["ops"]] == [
                sorted(f"{n}@{a}" for n, a in ps) for ps in ch.preds[i]]


def test_configuration_files_name_their_cut(tiny_root):
    import run

    with open(os.path.join(tiny_root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for c in spec["configs"]:
        cfg = run.load_config(os.path.join(tiny_root, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_a_cut_configuration_is_its_base_with_its_cut():
    import run
    from conftest import BENCH

    base = run.load_config(os.path.join(BENCH, "configs", "ycsb-a-8r.json"))
    cut = run.load_config(os.path.join(BENCH, "configs",
                                       "ycsb-a-8r-128.json"))
    differ = {k for k in base if base[k] != cut.get(k)}
    assert differ == {"name", "deployment", "docs", "program_env",
                      "reduced"}
    assert cut["reduced"] == ["docs"] and cut["docs"] < base["docs"]

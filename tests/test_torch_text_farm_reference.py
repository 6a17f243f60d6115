"""The port's farm on collaborative text, held to the benchmark's plain
RGA reference (``benchmark/reference/text.py``): the text cell's traffic
(``benchmark/schemas/text.py``) at a small size through
``TorchDocFarm.apply_changes`` on the CPU, every patch replayed into a
client's copy; the reference alone on hand-worked new.js cases; and the
farm's spans and counters of the list walk and the whole-document read."""
import os
import sys

import pytest

from automerge_tpu_torch import TorchDocFarm
from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
from automerge_tpu_torch.profiling import PhaseProfile, use_profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import plugins  # noqa: E402

REF = plugins.load(ROOT, "reference", "text")
SCHEMA = plugins.load(ROOT, "schemas", "text")
#: 4 documents, 12 rounds of 2 x 8 ops (the cell's shape, cut in size)
CFG = {"docs": 4, "rounds": 12, "ops_per_change": 8, "seed_chars": 64,
       "insert_share": 0.7, "run_share": 0.9,
       "alphabet": "abcdefghijklmnopqrstuvwxyz ", "key": "text"}
MIX = {"docs_per_step": 2, "shape_seed": 18}
A = "aa" * 16
B = "bb" * 16


def _edits(patch, key="text"):
    return [e for sub in patch["diffs"]["props"].get(key, {}).values()
            for e in sub.get("edits", [])]


@pytest.mark.parametrize("seed", [2**33 + 1, 2**31 + 7, 18])
def test_the_farm_agrees_with_the_plain_reference(seed):
    stream = SCHEMA.make_stream(CFG, MIX, seed)
    ch = stream.changes
    assert len(stream.steps) == 2 * CFG["rounds"]
    assert {ch.nops[i] for i in range(len(ch))} == {65, 8}
    farm = TorchDocFarm(CFG["docs"], capacity=512, device="cpu")
    docs = [REF.TextDoc() for _ in range(CFG["docs"])]
    copies = [[] for _ in range(CFG["docs"])]
    for step in stream.steps:
        per_doc = [[] for _ in range(CFG["docs"])]
        for i in step[0][1]:
            per_doc[ch.doc[i]].append(ch.data[i])
            REF.commit(docs[ch.doc[i]], ch, i)
        result = farm.apply_changes(per_doc)
        assert not result.quarantined
        for d, bufs in enumerate(per_doc):
            if not bufs:
                continue
            patch = result[d]
            assert patch["clock"] == docs[d].clock
            assert sorted(patch["deps"]) == sorted(docs[d].heads)
            assert patch["maxOp"] == docs[d].max_op
            REF.apply_edits(copies[d], _edits(patch))
            assert copies[d] == docs[d].sequence()
    for d in range(CFG["docs"]):
        want = docs[d].sequence()
        assert len(want) > 64
        script = []
        REF.apply_edits(script, _edits(farm.get_patch(d)))
        assert script == copies[d] == want
    assert all(doc.deleted for doc in docs)


def test_the_reference_places_inserts_by_new_js_rule():
    """Concurrent inserts after one element stand in descending op id
    order, a tie on the counter broken by the actor (the greater actor
    first), whatever the order they arrive in; a later insert after the
    same element goes before its elder siblings and their subtrees."""
    for order in ([(3, A), (3, B), (2, B)], [(2, B), (3, B), (3, A)]):
        doc = REF.TextDoc()
        doc.insert((1, A), None)
        doc.values[(1, A)] = "x"
        for op in order:
            doc.insert(op, (1, A))
        assert doc.elems == [(1, A), (3, B), (3, A), (2, B)]
    doc.insert((4, A), (3, B))          # a child of (3, B)
    doc.insert((5, A), (1, A))          # newest sibling: right after (1, A)
    assert doc.elems == [(1, A), (5, A), (3, B), (4, A), (3, A), (2, B)]
    doc.insert((6, B), None)            # at the head, before everything
    assert doc.elems[0] == (6, B)
    # the control's broken rule: ascending siblings, after their subtrees
    ctl = REF.TextDoc(ascending=True)
    ctl.insert((1, A), None)
    for op in [(3, A), (3, B), (2, B)]:
        ctl.insert(op, (1, A))
    ctl.insert((4, A), (3, A))
    assert ctl.elems == [(1, A), (2, B), (3, A), (4, A), (3, B)]


def test_a_text_call_and_an_open_record_the_walk_and_the_rank():
    stream = SCHEMA.make_stream(dict(CFG, docs=2, rounds=2), MIX, 5)
    ch = stream.changes
    first = stream.steps[0][0][1]
    farm = TorchDocFarm(2, capacity=256, device="cpu")
    reg = get_metrics()
    prof = PhaseProfile()
    with enabled_metrics(), use_profile(prof):
        reg.find("farm.walk.ops").reset()
        reg.find("farm.rga.elems_ranked").reset()
        farm.apply_changes([[ch.data[i] for i in first if ch.doc[i] == d]
                            for d in range(2)])
        farm.get_patch(1)
        snap = reg.as_dict()
    calls = {p: c for p, (_, c) in prof.totals_by_path().items()}
    # one walk bootstrap and apply per text document, one rank per open
    assert calls["walk/walk_replay"] == 2
    assert calls["walk/walk_apply"] == 2
    assert calls["whole_patch"] == 1
    assert calls["whole_patch/rga_rank"] == 1
    assert snap["farm.walk.ops"]["value"] == sum(
        ch.nops[i] for i in first) == 2 * (65 + 2 * 8)
    inserted = sum(ch.kinds[i].count("i") for i in first if ch.doc[i] == 1)
    assert snap["farm.rga.elems_ranked"]["value"] == inserted

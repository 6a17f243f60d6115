"""The ``text`` loop: a sound CPU run of ``text-2actor`` (cut to 4
documents of 12 rounds of 2 x 8 ops) passes its own check, the generator
writes the port's bytes, and the control and every planted fault fail the
check; ``text.rga_rank_roofline`` counts 16 bytes a ranked element."""
import json
import os

import pytest

import control
import run
from conftest import make_tiny_tree
from harness import plugins, roofline

SEED = 2**33 + 1818
CELL = "text-2actor"
#: the cell cut to what a CPU test holds (the widths stay)
TINY_TEXT = {
    "configs/text-2a-10k.json": {"docs": 4, "rounds": 12,
                                 "ops_per_change": 8, "capacity": 512},
    "traffic/text-rounds-2.json": {"open_every": 3, "warmup_steps": 2},
}
#: window steps of a tiny run: the rest of the stream after the warm-up
STEPS = 22


@pytest.fixture(scope="module")
def text_root(tmp_path_factory):
    root = make_tiny_tree(tmp_path_factory.mktemp("tiny_text"))
    for rel, change in TINY_TEXT.items():
        path = os.path.join(root, "benchmark", rel)
        with open(path) as fh:
            data = json.load(fh)
        data.update(change)
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2)
    return root


def _run(root, plant=None, trace=False, **kw):
    return run.run_cell(CELL, SEED, 0.0, trace, device="cpu", root=root,
                        plant=plant, steps=STEPS, **kw)


def _stream(root, seed=SEED):
    from harness.traffic import make_stream

    _, _, cfg, mix = run.load_cell(CELL, root)
    return make_stream(cfg, mix, seed, root), cfg


def test_a_cpu_run_agrees_with_the_reference(text_root):
    result, check, info = _run(text_root)
    assert result["correct"], check.notes
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["metrics"]) == {"setup_s", "merged_ops_per_s",
                                      "apply_p95_ms"}
    # every call's two patches and the opens of every third call
    assert info["patches_checked"] == 2 * 24 + 2 * 8
    assert info["states_checked"] == 4
    # 2 changes a document a call, and pair 2's seed changes
    assert result["attempted"] == info["changes"] == 4 * STEPS + 2
    assert info["apply_ms"]["n"] == STEPS
    traced, check, _ = _run(text_root, trace=True)
    assert traced["correct"], check.notes
    assert {"text.walk_us_per_row", "text.open_ms"} <= set(
        traced["metrics"])


def test_the_stream_is_made_from_the_seed(text_root):
    a, cfg = _stream(text_root)
    b, _ = _stream(text_root)
    c, _ = _stream(text_root, SEED + 1)
    assert a.changes.data == b.changes.data
    assert a.changes.data != c.changes.data
    # the shape is the traffic's: the same ops insert and delete
    assert a.changes.kinds == c.changes.kinds
    ch = a.changes
    per_doc = 65 + 2 * cfg["rounds"] * cfg["ops_per_change"]
    for d in range(cfg["docs"]):
        assert sum(n for i, n in enumerate(ch.nops) if ch.doc[i] == d) \
            == per_doc


def test_generated_changes_are_the_ports_bytes(text_root):
    from automerge_tpu_torch.columnar import decode_change, encode_change

    stream, _ = _stream(text_root)
    ch = stream.changes
    for i in range(0, len(ch), 7):
        c = decode_change(ch.data[i])
        assert encode_change({k: c[k] for k in (
            "actor", "seq", "startOp", "time", "message", "deps",
            "ops")}) == ch.data[i]
        assert (c["actor"], c["seq"], c["startOp"], sorted(c["deps"])) == (
            ch.actor[i], ch.seq[i], ch.start_op[i], sorted(ch.deps[i]))
        assert "".join("m" if op["action"] == "makeText" else
                       "i" if op.get("insert") else "d"
                       for op in c["ops"]) == ch.kinds[i]


def test_the_control_fails_the_check(text_root):
    result, check, _ = run.run_cell(
        CELL, SEED, 0.0, False, device="cpu", root=text_root,
        make_farms=control.control_farms(text_root),
        driver_cls=control.control_driver(CELL, text_root), steps=STEPS)
    assert not result["correct"]
    assert result["checks"]["patch_mismatches"]["value"] > 0
    assert result["checks"]["state_mismatches"]["value"] > 0


def _edits(patch):
    return [e for sub in patch["diffs"]["props"].get("text", {}).values()
            for e in sub.get("edits", [])]


def _script_of(patch, ref_mod):
    copy = []
    ref_mod.apply_edits(copy, _edits(patch))
    return copy


def _with_script(patch, seq):
    (sub,) = patch["diffs"]["props"]["text"].values()
    sub["edits"] = [{"action": "insert", "index": i, "elemId": e,
                     "opId": e, "value": {"type": "value", "value": v}}
                    for i, (e, v) in enumerate(seq)]
    return patch


def _drop_insert(farms, syncs):
    """The first call's patches lose their last inserted element."""
    farm, apply = farms[0], farms[0].apply_changes

    def wrapped(per_doc):
        out = apply(per_doc)
        for patch in out:
            if patch is not None and farm.planted < 2:
                edits = _edits(patch)
                last = next(e for e in reversed(edits)
                            if e["action"] in ("insert", "multi-insert"))
                if last["action"] == "insert":
                    edits.remove(last)
                else:
                    last["values"].pop()
                farm.planted += 1
        return out

    farm.planted = 0
    farm.apply_changes = wrapped


def _resurrect(farms, syncs):
    """Patches keep one deleted element: their first remove is lost."""
    farm, apply = farms[0], farms[0].apply_changes

    def wrapped(per_doc):
        out = apply(per_doc)
        for patch in out:
            for sub in (patch or {"diffs": {"props": {}}})["diffs"][
                    "props"].get("text", {}).values():
                for e in sub["edits"]:
                    if e["action"] == "remove":
                        if e["count"] > 1:
                            e["count"] -= 1
                        else:
                            sub["edits"].remove(e)
                        return out
        return out

    farm.apply_changes = wrapped


def _swap_tie(farms, syncs):
    """Whole patches show two visible elements of one counter (a tie,
    broken by actor) in the other order."""
    ref_mod = plugins.load(run.ROOT, "reference", "text")
    farm, get = farms[0], farms[0].get_patch

    def wrapped(d):
        patch = get(d)
        seq = _script_of(patch, ref_mod)
        where = {}
        for k, (e, _) in enumerate(seq):
            ctr = e.split("@")[0]
            if ctr in where:
                j = where[ctr]
                seq[j], seq[k] = seq[k], seq[j]
                return _with_script(patch, seq)
            where[ctr] = k
        raise AssertionError("no visible tie in the document")

    farm.get_patch = wrapped


def _stale_open(farms, syncs):
    """An open reads the document as it was before the last call."""
    farm, apply, get = farms[0], farms[0].apply_changes, farms[0].get_patch
    before = {}

    def wrapped_apply(per_doc):
        for d, bufs in enumerate(per_doc):
            if bufs and farm.num_elems[d] > 0:
                before[d] = get(d)
        return apply(per_doc)

    def wrapped_get(d):
        return before.get(d) or get(d)

    farm.apply_changes, farm.get_patch = wrapped_apply, wrapped_get


@pytest.mark.parametrize("plant", [_drop_insert, _resurrect, _swap_tie,
                                   _stale_open],
                         ids=["dropped_insert", "resurrected_delete",
                              "swapped_tie", "stale_open"])
def test_a_planted_fault_fails_the_check(text_root, plant):
    result, check, _ = _run(text_root, plant=plant)
    assert not result["correct"], plant.__name__
    assert result["checks"]["patch_mismatches"]["value"] > 0


def test_the_rank_roofline_counts_16_bytes_an_element():
    metric = plugins.load(run.ROOT, "metrics", "text.rga_rank_roofline")
    readings = {"rows": 10, "phases": {}, "loop": {"traced_elems": 10_000},
                "trace": {"ops_by_range": {"farm.rga_rank": 2e-4,
                                           "farm.whole_patch": 1.0}}}
    want = 100.0 * roofline.least_ms(160_000) / 0.2
    assert metric.read(readings) == pytest.approx(want)
    assert want == pytest.approx(100 * 160_000 / 3.35e12 / 2e-4)
    # no traced open, or no device time under the range: nothing to read
    assert metric.read({**readings, "loop": {"traced_elems": 0}}) is None
    assert metric.read({**readings, "trace": {"ops_by_range": {}}}) is None
    assert metric.read({**readings, "trace": None}) is None

"""A fault both packages share, pinned so that a repair in either shows:
``OpSet``'s incremental patch for one delivery that updates a list element
and then deletes the element after it removes the updated element's
index instead (``update`` index 0, then ``remove`` index 0, where the
delete's own patch says index 1). Whole-document patches are right, so a
document loaded from the same changes is right and a client that applied
them incrementally is not. The farm's incremental patches equal
``OpSet``'s, so they carry it too. chip_smoke.py's phase 23 corpus meets
it (seed 0, doc 113, the first delivery), which is why its check (b)
holds the farm's whole documents to ``OpSet``'s after each delivery and
the branches only through their saved documents."""
import types

import pytest

import chip_smoke as c
from automerge_tpu import columnar as jax_columnar
from automerge_tpu.opset import OpSet as JaxOpSet
from automerge_tpu.tpu.farm import TpuDocFarm
from test_torch_api_doc import PACKAGES


def _pkg(name):
    if name == "port":
        return c.port_pkg("cpu")
    return types.SimpleNamespace(farm=TpuDocFarm, OpSet=JaxOpSet,
                                 columnar=jax_columnar)


def _list_changes(P):
    """A list [x0, x1, x2]; then one actor's two changes: x0 set to "u",
    then x1 deleted."""
    make, h1 = c.farm_change(P, "aaaaaaaa", 1, 1, [], [
        {"action": "makeList", "obj": "_root", "key": "l", "pred": []}] + [
        {"action": "set", "obj": "1@aaaaaaaa",
         "elemId": "_head" if i == 0 else f"{i + 1}@aaaaaaaa",
         "insert": True, "value": f"x{i}", "pred": []} for i in range(3)])
    update, h2 = c.farm_change(P, "bbbbbbbb", 1, 5, [h1], [
        {"action": "set", "obj": "1@aaaaaaaa", "elemId": "2@aaaaaaaa",
         "insert": False, "value": "u", "pred": ["2@aaaaaaaa"]}])
    delete, _ = c.farm_change(P, "bbbbbbbb", 2, 6, [h2], [
        {"action": "del", "obj": "1@aaaaaaaa", "elemId": "3@aaaaaaaa",
         "insert": False, "pred": ["3@aaaaaaaa"]}])
    return make, update, delete


def _edits(patch):
    return patch["diffs"]["props"]["l"]["1@aaaaaaaa"]["edits"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_one_delivery_update_then_delete_removes_the_wrong_index(pkg):
    P = _pkg(pkg)
    make, update, delete = _list_changes(P)
    opset, farm = P.OpSet(), P.farm(1, capacity=16)
    opset.apply_changes([make])
    farm.apply_changes([[make]])
    patch = opset.apply_changes([update, delete])
    assert [(e["action"], e["index"]) for e in _edits(patch)] == [
        ("update", 0), ("remove", 0)]
    assert farm.apply_changes([[update, delete]])[0] == patch
    alone = P.OpSet()
    alone.apply_changes([make])
    alone.apply_changes([update])
    assert _edits(alone.apply_changes([delete])) == [
        {"action": "remove", "index": 1, "count": 1}]
    whole = _edits(opset.get_patch())
    assert [(e["action"], e["index"], e["value"]["value"]) for e in whole] \
        == [("insert", 0, "u"), ("insert", 1, "x2")]
    assert farm.get_patch(0) == opset.get_patch()


@pytest.mark.parametrize("am", PACKAGES, ids=lambda am: am.__name__)
def test_a_client_applying_both_changes_reads_the_wrong_list(am):
    """Through either package's API: the client that applied the two
    changes in one call reads [x1, x2]; its saved document loads as
    [u, x2], which is right."""
    base = am.change(am.init("aaaaaaaa"),
                     lambda x: x.__setitem__("l", ["x0", "x1", "x2"]))
    editor = am.apply_changes(am.init("bbbbbbbb"),
                              am.get_all_changes(base))[0]
    began = editor
    editor = am.change(editor, lambda x: x["l"].__setitem__(0, "u"))
    editor = am.change(editor, lambda x: x["l"].delete_at(1))
    assert list(editor["l"]) == ["u", "x2"]
    client = am.apply_changes(base, am.get_changes(began, editor))[0]
    assert list(client["l"]) == ["x1", "x2"]
    assert list(am.load(am.save(client))["l"]) == ["u", "x2"]

"""The port's frontend driven alone (no backend: changes queue as
requests), twins of tests/test_frontend_parity.py's standalone and
conflict-accessor cases: each scenario runs through both packages'
``Frontend`` under pinned clocks and uuid factories
(test_torch_api_doc.twin) and must observe the same requests, documents
and errors. The document-type and proxy cases are
test_torch_frontend_types.py's."""
import pytest
from test_torch_api_doc import run_cases, twin


def _patch(props, **head):
    return dict(head, diffs={"objectId": "_root", "type": "map",
                             "props": props})


# ---------------------------------------------------------------------- #
# TestFrontendStandalone


def change_produces_request(am, rec):
    d0 = am.Frontend.init("aaaaaaaa")  # no backend in options
    d1, req = am.Frontend.change(d0, lambda d: d.__setitem__("bird", "magpie"))
    assert d1["bird"] == "magpie"
    assert req["actor"] == "aaaaaaaa" and req["seq"] == 1
    assert req["ops"] == [
        {"action": "set", "obj": "_root", "insert": False, "value": "magpie",
         "pred": [], "key": "bird"},
    ]
    rec.value(req)


def apply_patch_confirms_request(am, rec):
    d0 = am.Frontend.init("aaaaaaaa")
    d1, _req = am.Frontend.change(d0, lambda d: d.__setitem__("bird", "magpie"))
    d2 = am.Frontend.apply_patch(d1, _patch(
        {"bird": {"1@aaaaaaaa": {"type": "value", "value": "magpie"}}},
        actor="aaaaaaaa", seq=1, maxOp=1, clock={"aaaaaaaa": 1}, deps=[]))
    assert d2["bird"] == "magpie"
    rec.doc(d2)


def mismatched_seq_rejected(am, rec):
    d0 = am.Frontend.init("aaaaaaaa")
    d1, _req = am.Frontend.change(d0, lambda d: d.__setitem__("x", 1))
    bad = _patch({}, actor="aaaaaaaa", seq=2, maxOp=1,
                 clock={"aaaaaaaa": 2}, deps=[])
    with pytest.raises(ValueError, match="Mismatched sequence number") as err:
        am.Frontend.apply_patch(d1, bad)
    rec.value(str(err.value))


def remote_patch_rebases_queued_request(am, rec):
    d0 = am.Frontend.init("aaaaaaaa")
    d1, _req = am.Frontend.change(d0, lambda d: d.__setitem__("mine", 1))
    d2 = am.Frontend.apply_patch(d1, _patch(
        {"theirs": {"1@bbbbbbbb": {"type": "value", "value": 2}}},
        maxOp=1, clock={"bbbbbbbb": 1}, deps=[]))
    # while the local change is unconfirmed, the doc keeps showing the
    # optimistic state; the remote value is held on the rebased base doc
    assert d2["mine"] == 1 and "theirs" not in d2
    d3 = am.Frontend.apply_patch(d2, _patch(
        {"mine": {"2@aaaaaaaa": {"type": "value", "value": 1}}},
        actor="aaaaaaaa", seq=1, maxOp=2,
        clock={"aaaaaaaa": 1, "bbbbbbbb": 1}, deps=[]))
    assert d3["mine"] == 1 and d3["theirs"] == 2
    rec.doc(d2)
    rec.doc(d3)


def defer_actor_id(am, rec):
    d0 = am.Frontend.init({"deferActorId": True})
    assert am.Frontend.get_actor_id(d0) is None
    d1 = am.Frontend.set_actor_id(d0, "ccdd0011")
    _d2, req = am.Frontend.change(d1, lambda d: d.__setitem__("x", 1))
    assert req["actor"] == "ccdd0011"
    rec.value(req)


def change_before_actor_id_fails(am, rec):
    d0 = am.Frontend.init({"deferActorId": True})
    with pytest.raises(ValueError, match="Actor ID must be initialized") as err:
        am.Frontend.change(d0, lambda d: d.__setitem__("x", 1))
    rec.value(str(err.value))


def frontend_from_farm_patch(am, rec):
    """The farm's whole-document patch read as a document (what phase 17
    of chip_smoke.py does): here the backend's patch, through
    ``Frontend.apply_patch(Frontend.init(), patch)``."""
    doc = am.change(am.init("aaaaaaaa"), {"time": 0}, lambda d: d.update(
        {"t": am.Text("hi"), "l": [1, {"m": 2}], "c": am.Counter(3)}))
    state = am.Frontend.get_backend_state(doc, "test")
    patch = am.get_backend().get_patch(state)
    rebuilt = am.Frontend.apply_patch(am.Frontend.init(), patch)
    assert am.equals(rebuilt, doc)
    rec.patch(patch)
    rec.doc(rebuilt)


# ---------------------------------------------------------------------- #
# TestConflictAccessors


def map_conflicts(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), lambda d: d.__setitem__("k", 1))
    d2 = am.load(am.save(d1), "bbbbbbbb")
    d1 = am.change(d1, lambda d: d.__setitem__("k", "a-wins"))
    d2 = am.change(d2, lambda d: d.__setitem__("k", "b-wins"))
    merged = am.merge(d1, d2)
    conflicts = am.get_conflicts(merged, "k")
    assert set(conflicts.values()) == {"a-wins", "b-wins"}
    assert merged["k"] == "b-wins"
    rec.value(conflicts)


def list_conflicts(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), lambda d: d.__setitem__("l", ["x"]))
    d2 = am.load(am.save(d1), "bbbbbbbb")
    d1 = am.change(d1, lambda d: d["l"].__setitem__(0, "a-val"))
    d2 = am.change(d2, lambda d: d["l"].__setitem__(0, "b-val"))
    merged = am.merge(d1, d2)
    conflicts = am.get_conflicts(merged["l"], 0)
    assert set(conflicts.values()) == {"a-val", "b-val"}
    rec.value(conflicts)


def no_conflict_returns_none(am, rec):
    d = am.change(am.init(), lambda d: d.__setitem__("k", 1))
    assert am.get_conflicts(d, "k") is None
    rec.saved(am, d)


CASES = [
    change_produces_request, apply_patch_confirms_request,
    mismatched_seq_rejected, remote_patch_rebases_queued_request,
    defer_actor_id, change_before_actor_id_fails, frontend_from_farm_patch,
    map_conflicts, list_conflicts, no_conflict_returns_none,
]


@run_cases(CASES)
def test_frontend_twin(scenario, monkeypatch):
    twin(scenario, monkeypatch)

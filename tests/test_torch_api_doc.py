"""The port's public API against the JAX package's, twins of
tests/test_api.py (document lifecycle and changes here; lists, text,
counters, tables and observers in test_torch_api_types.py; merges,
conflicts, save/load, history and sync in test_torch_api_merge.py).

Each twin is a scenario written once over a package module ``am`` and run
through ``automerge_tpu`` and ``automerge_tpu_torch`` in turn, with both
packages' change clocks pinned to one time and both uuid factories set to
one sequence. A scenario makes the JAX test's assertions on each package
and records what it observed: documents as plain values, ``save()``
bytes, changes and sync messages byte for byte, patches as canonical JSON.
The two records must be equal.

The helpers below (``twin``, ``Record``, ``set_key``) serve the other two
files too.
"""
import datetime
import itertools
import json
import types

import pytest

import automerge_tpu
import automerge_tpu_torch

PACKAGES = (automerge_tpu, automerge_tpu_torch)
#: the pinned change time (seconds), for changes that pass no "time"
PINNED_TIME = 1_600_000_000


def set_key(key, value):
    return lambda d: d.__setitem__(key, value)


def plain(value):
    """A document value as plain JSON-able data, the same for both
    packages' types (their classes share names, not identity)."""
    kind = type(value).__name__
    if kind == "Text":
        return ["Text", str(value)]
    if kind == "Table":
        return ["Table", {rid: plain(row) for rid, row in
                          sorted(value.to_dict().items())}]
    if kind == "Counter":
        return ["Counter", value.value]
    if isinstance(value, dict):
        return {str(k): plain(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, datetime.datetime):
        return ["datetime", value.isoformat()]
    if value is None or isinstance(value, (bool, str)):
        return value
    if isinstance(value, (int, float)):
        return [kind, value]
    return [kind, repr(value)]


def canon(x):
    return json.dumps(plain(x), sort_keys=True)


class Record(list):
    """What a scenario observed, in order."""

    def doc(self, doc):
        self.append(("doc", plain(doc)))
        return doc

    def saved(self, am, doc):
        data = am.save(doc)
        self.append(("save", data))
        return data

    def changes(self, changes):
        self.append(("changes", [bytes(c) for c in changes]))
        return changes

    def patch(self, patch):
        self.append(("patch", canon(patch)))
        return patch

    def value(self, x):
        self.append(("value", plain(x)))
        return x


def _pin(am, monkeypatch):
    """Pins `am`'s change clock and restarts its uuid factory at the same
    sequence as the other package's."""
    monkeypatch.setattr(am.Frontend, "_time",
                        types.SimpleNamespace(time=lambda: PINNED_TIME))
    uuid_module = __import__(f"{am.__name__}.uuid", fromlist=["set_factory"])
    counter = itertools.count(1)
    uuid_module.set_factory(lambda: f"{next(counter):032x}")
    return uuid_module


def twin(scenario, monkeypatch):
    """Runs ``scenario(am, rec)`` through both packages under pinned clocks
    and uuid factories; asserts the two records are equal and returns the
    port's."""
    records = []
    for am in PACKAGES:
        uuid_module = _pin(am, monkeypatch)
        rec = Record()
        try:
            scenario(am, rec)
        finally:
            uuid_module.reset_factory()
        records.append(rec)
    assert records[1] == records[0]
    return records[1]


def run_cases(cases):
    """Parametrize helper: one case per scenario function, by its name."""
    return pytest.mark.parametrize("scenario", cases,
                                   ids=[c.__name__ for c in cases])


# ---------------------------------------------------------------------- #
# TestInit


def initially_empty(am, rec):
    doc = am.init()
    assert len(doc) == 0
    assert am.get_object_id(doc) == "_root"
    rec.value(am.get_actor_id(doc))
    rec.saved(am, doc)


def actor_id_option(am, rec):
    doc = am.init("0123456789abcdef")
    assert am.get_actor_id(doc) == "0123456789abcdef"
    rec.saved(am, am.change(doc, set_key("k", 1)))


def rejects_bad_actor_id(am, rec):
    with pytest.raises(ValueError, match="hex digits") as bad:
        am.init("not-hex!")
    with pytest.raises(ValueError, match="even number") as odd:
        am.init("abc")
    rec.value([str(bad.value), str(odd.value)])


def from_data(am, rec):
    doc = am.from_data({"x": 1, "y": "two"})
    assert doc["x"] == 1 and doc["y"] == "two"
    history = am.get_history(doc)
    assert history[0].change["message"] == "Initialization"
    rec.doc(doc)
    rec.saved(am, doc)
    rec.changes(am.get_all_changes(doc))


# ---------------------------------------------------------------------- #
# TestChange


def change_returns_new_doc(am, rec):
    d1 = am.init()
    d2 = am.change(d1, set_key("k", "v"))
    assert len(d1) == 0 and d2["k"] == "v"
    rec.doc(d2)
    rec.saved(am, d2)


def unchanged_doc_returned_as_is(am, rec):
    d1 = am.change(am.init(), set_key("k", "v"))
    d2 = am.change(d1, lambda d: None)
    assert d2 is d1
    rec.changes(am.get_all_changes(d2))


def no_op_assignment_not_recorded(am, rec):
    d1 = am.change(am.init(), set_key("k", "v"))
    d2 = am.change(d1, set_key("k", "v"))
    assert d2 is d1
    rec.changes(am.get_all_changes(d2))


def change_message(am, rec):
    d1 = am.change(am.init(), "msg here", set_key("k", "v"))
    assert am.get_history(d1)[0].change["message"] == "msg here"
    rec.value(am.get_history(d1)[0].change)


def nested_maps(am, rec):
    d1 = am.change(am.init(), set_key("outer", {"inner": {"deep": 42}}))
    assert d1["outer"]["inner"]["deep"] == 42
    d2 = am.change(d1, lambda d: d["outer"]["inner"].__setitem__("deep", 43))
    assert d2["outer"]["inner"]["deep"] == 43
    assert d1["outer"]["inner"]["deep"] == 42  # immutability
    rec.doc(d1)
    rec.doc(d2)
    rec.saved(am, d2)


def delete_key(am, rec):
    d1 = am.change(am.init(), set_key("k", "v"))
    d2 = am.change(d1, lambda d: d.__delitem__("k"))
    assert "k" not in d2 and "k" in d1
    rec.doc(d2)
    rec.changes(am.get_all_changes(d2))


def read_only_outside_change(am, rec):
    d1 = am.change(am.init(), set_key("k", "v"))
    with pytest.raises(TypeError, match="read-only") as err:
        d1["k2"] = "v2"
    rec.value(str(err.value).replace(am.__name__, "<package>"))


def numbers(am, rec):
    d1 = am.change(am.init(), lambda d: (
        d.__setitem__("int", 3),
        d.__setitem__("float", 1.5),
        d.__setitem__("uint", am.Uint(7)),
        d.__setitem__("neg", -12),
        d.__setitem__("bool", True),
        d.__setitem__("none", None),
    ))
    assert d1["int"] == 3 and isinstance(d1["int"], int)
    assert d1["float"] == 1.5 and d1["uint"] == 7 and d1["neg"] == -12
    assert d1["bool"] is True and d1["none"] is None
    d2 = am.load(am.save(d1))
    assert dict(d2) == dict(d1)
    rec.doc(d2)
    rec.saved(am, d1)


def empty_change(am, rec):
    d1 = am.change(am.init(), set_key("k", "v"))
    d2 = am.empty_change(d1, "just a milestone")
    assert dict(d2) == dict(d1)
    assert am.get_history(d2)[1].change["message"] == "just a milestone"
    rec.changes(am.get_all_changes(d2))


CASES = [
    initially_empty, actor_id_option, rejects_bad_actor_id, from_data,
    change_returns_new_doc, unchanged_doc_returned_as_is,
    no_op_assignment_not_recorded, change_message, nested_maps, delete_key,
    read_only_outside_change, numbers, empty_change,
]


@run_cases(CASES)
def test_api_twin(scenario, monkeypatch):
    twin(scenario, monkeypatch)

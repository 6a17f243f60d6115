"""The port's document types and mutation proxies, twins of
tests/test_frontend_parity.py's text, proxy, equality and last-local-change
cases: each scenario runs through both packages under pinned clocks and
uuid factories (test_torch_api_doc.twin) and must observe the same
documents, saves and changes. The messages that name the package name the
port's own ``change()``."""
import pytest
from test_torch_api_doc import run_cases, twin

import automerge_tpu_torch

# ---------------------------------------------------------------------- #
# TestTextType


def to_spans(am, rec):
    d1 = am.change(am.init(), lambda d: d.__setitem__("text", am.Text("ab")))
    d2 = am.change(d1, lambda d: d["text"].insert_at(2, {"bold": True}))
    d3 = am.change(d2, lambda d: d["text"].insert_at(3, "c", "d"))
    spans = d3["text"].to_spans()
    assert spans[0] == "ab" and dict(spans[1]) == {"bold": True}
    assert spans[2] == "cd"
    rec.value(spans)
    rec.saved(am, d3)


def text_equality_and_str(am, rec):
    d = am.change(am.init(), lambda d: d.__setitem__("t", am.Text("hello")))
    assert d["t"] == "hello" and d["t"] == am.Text("hello")
    assert str(d["t"]) == "hello" and len(d["t"]) == 5
    assert list(d["t"]) == ["h", "e", "l", "l", "o"]
    rec.doc(d)


def text_element_ids(am, rec):
    d = am.change(am.init("aabbccdd"), lambda d: d.__setitem__("t", am.Text("ab")))
    assert am.get_element_ids(d["t"]) == ["2@aabbccdd", "3@aabbccdd"]
    rec.changes(am.get_all_changes(d))


def objects_in_text(am, rec):
    d1 = am.change(am.init(), lambda d: d.__setitem__("t", am.Text("ab")))
    d2 = am.change(d1, lambda d: d["t"].insert_at(1, {"k": "v"}))
    assert d2["t"][1]["k"] == "v"
    assert str(d2["t"]) == "ab"  # objects skipped in string form
    rec.saved(am, d2)


# ---------------------------------------------------------------------- #
# TestProxyBehaviors


def map_iteration_and_membership(am, rec):
    def cb(d):
        d["a"] = 1
        d["b"] = 2
        assert set(d.keys()) == {"a", "b"}
        assert "a" in d and "z" not in d
        assert len(d) == 2 and dict(d.items())["b"] == 2

    rec.saved(am, am.change(am.init(), cb))


def list_methods(am, rec):
    def cb(d):
        d["l"] = [1, 2, 3]
        lst = d["l"]
        assert lst[0] == 1 and lst[-1] == 3
        assert list(lst[1:]) == [2, 3]
        assert 2 in lst and lst.index(3) == 2
        lst.extend([4, 5])
        assert len(lst) == 5 and lst.pop() == 5 and len(lst) == 4

    doc = am.change(am.init(), cb)
    assert list(doc["l"]) == [1, 2, 3, 4]
    rec.changes(am.get_all_changes(doc))


def nested_object_identity_error(am, rec):
    d1 = am.change(am.init(), lambda d: d.__setitem__("a", {"x": 1}))

    def reuse(d):
        d["b"] = d["a"]

    with pytest.raises(Exception) as err:
        am.change(d1, reuse)
    rec.value([type(err.value).__name__, str(err.value)])


def get_object_by_id(am, rec):
    d = am.change(am.init(), lambda d: d.__setitem__("m", {"x": 1}))
    object_id = am.get_object_id(d["m"])
    assert am.get_object_by_id(d, object_id) is d["m"]
    rec.value(object_id)


# ---------------------------------------------------------------------- #
# TestEquals, TestLastLocalChange


def deep_equality(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), lambda d: d.update({"a": [1, {"b": 2}]}))
    d2 = am.change(am.init("bbbbbbbb"), lambda d: d.update({"a": [1, {"b": 2}]}))
    assert am.equals(d1, d2)
    d3 = am.change(am.init("cccccccc"), lambda d: d.update({"a": [1, {"b": 3}]}))
    assert not am.equals(d1, d3)
    rec.doc(d3)


def last_local_change(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), lambda d: d.__setitem__("x", 1))
    binary = am.get_last_local_change(d1)
    decoded = am.decode_change(binary)
    assert decoded["actor"] == "aaaaaaaa"
    assert decoded["ops"][0]["key"] == "x"
    rec.changes([binary])
    rec.value(decoded)


CASES = [
    to_spans, text_equality_and_str, text_element_ids, objects_in_text,
    map_iteration_and_membership, list_methods,
    nested_object_identity_error, get_object_by_id, deep_equality,
    last_local_change,
]


@run_cases(CASES)
def test_frontend_types_twin(scenario, monkeypatch):
    twin(scenario, monkeypatch)


@pytest.mark.parametrize("mutate", [
    lambda m: m.__setitem__("k", 2), lambda m: m.update({"k": 2}),
    lambda m: m.__delitem__("k")])
def test_read_only_messages_name_the_port(mutate):
    """A frozen map or list refuses mutation with a message that names
    ``automerge_tpu_torch.change()``."""
    am = automerge_tpu_torch
    doc = am.change(am.init("aaaaaaaa"), {"time": 0}, lambda d: d.update(
        {"k": 1, "l": [1]}))
    for target in (doc, doc["l"]):
        with pytest.raises(TypeError) as err:
            mutate(target) if target is doc else target.append(2)
        assert "automerge_tpu_torch.change()" in str(err.value)

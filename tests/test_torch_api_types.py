"""The port's public API against the JAX package's, twins of
tests/test_api.py's lists, text, counters, tables and observers: each
scenario runs through both packages under pinned clocks and uuid
factories (test_torch_api_doc.twin) and must observe the same documents,
saves, changes and patches."""
import pytest
from helpers import assert_equals_one_of
from test_torch_api_doc import run_cases, set_key, twin

# ---------------------------------------------------------------------- #
# TestLists


def list_operations(am, rec):
    d1 = am.change(am.init(), set_key("birds", ["chaffinch", "wren"]))
    assert list(d1["birds"]) == ["chaffinch", "wren"]
    d2 = am.change(d1, lambda d: d["birds"].append("goldfinch"))
    d3 = am.change(d2, lambda d: d["birds"].insert(1, "robin"))
    assert list(d3["birds"]) == ["chaffinch", "robin", "wren", "goldfinch"]
    d4 = am.change(d3, lambda d: d["birds"].delete_at(0))
    assert list(d4["birds"]) == ["robin", "wren", "goldfinch"]
    d5 = am.change(d4, lambda d: d["birds"].__setitem__(1, "jay"))
    assert list(d5["birds"]) == ["robin", "jay", "goldfinch"]
    for d in (d1, d3, d5):
        rec.doc(d)
    rec.saved(am, d5)


def list_of_objects(am, rec):
    d1 = am.change(am.init(), set_key("todos", [{"title": "a", "done": False}]))
    assert d1["todos"][0]["title"] == "a"
    d2 = am.change(d1, lambda d: d["todos"][0].__setitem__("done", True))
    assert d2["todos"][0]["done"] is True
    rec.doc(d2)
    rec.changes(am.get_all_changes(d2))


def nested_lists(am, rec):
    d1 = am.change(am.init(), set_key("matrix", [[1, 2], [3, 4]]))
    assert list(d1["matrix"][1]) == [3, 4]
    d2 = am.change(d1, lambda d: d["matrix"][0].append(99))
    assert list(d2["matrix"][0]) == [1, 2, 99]
    rec.doc(d2)
    rec.saved(am, d2)


def assignment_past_end_pads_with_none(am, rec):
    d1 = am.change(am.init(), set_key("list", ["a"]))
    d2 = am.change(d1, lambda d: d["list"].__setitem__(3, "d"))
    assert list(d2["list"]) == ["a", None, None, "d"]
    rec.changes(am.get_all_changes(d2))


def element_ids(am, rec):
    d1 = am.change(am.init("aabbccdd"), set_key("list", ["a", "b"]))
    ids = am.get_element_ids(d1["list"])
    assert ids == ["2@aabbccdd", "3@aabbccdd"]
    rec.value(ids)


def add_and_remove_same_change(am, rec):
    d1 = am.change(am.init(), set_key("noodles", []))
    d1 = am.change(d1, lambda d: (d["noodles"].append("udon"),
                                  d["noodles"].delete_at(0)))
    assert list(d1["noodles"]) == []
    d1 = am.change(d1, lambda d: (d["noodles"].append("soba"),
                                  d["noodles"].delete_at(0)))
    assert list(d1["noodles"]) == []
    rec.saved(am, d1)


# ---------------------------------------------------------------------- #
# TestText


def text_editing(am, rec):
    d1 = am.change(am.init(), set_key("text", am.Text("init")))
    assert str(d1["text"]) == "init"
    d2 = am.change(d1, lambda d: d["text"].insert_at(0, "T", "h", "e", " "))
    assert str(d2["text"]) == "The init"
    d3 = am.change(d2, lambda d: d["text"].delete_at(4, 4))
    d4 = am.change(d3, lambda d: d["text"].insert_at(4, "e", "n", "d"))
    assert str(d4["text"]) == "The end"
    rec.doc(d4)
    rec.saved(am, d4)


def text_set(am, rec):
    d1 = am.change(am.init(), set_key("text", am.Text("abc")))
    d2 = am.change(d1, lambda d: d["text"].set(1, "B"))
    assert str(d2["text"]) == "aBc"
    rec.changes(am.get_all_changes(d2))


def concurrent_text_insertion_converges(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("text", am.Text("ab")))
    d2 = am.load(am.save(d1), "bbbbbbbb")
    d1 = am.change(d1, lambda d: d["text"].insert_at(1, "x"))
    d2 = am.change(d2, lambda d: d["text"].insert_at(1, "y"))
    m1 = am.merge(am.clone(d1, "cccccccc"), d2)
    m2 = am.merge(am.clone(d2, "dddddddd"), d1)
    assert str(m1["text"]) == str(m2["text"])
    assert_equals_one_of(str(m1["text"]), "axyb", "ayxb")
    rec.doc(m1)
    rec.saved(am, m2)


# ---------------------------------------------------------------------- #
# TestCounter


def counter_in_map(am, rec):
    d1 = am.change(am.init(), set_key("c", am.Counter(10)))
    d2 = am.change(d1, lambda d: d["c"].increment())
    d3 = am.change(d2, lambda d: d["c"].increment(5))
    d4 = am.change(d3, lambda d: d["c"].decrement(2))
    assert d4["c"].value == 14
    rec.doc(d4)
    rec.changes(am.get_all_changes(d4))


def concurrent_increments_add_up(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("c", am.Counter(0)))
    d2 = am.load(am.save(d1), "bbbbbbbb")
    d1 = am.change(d1, lambda d: d["c"].increment(3))
    d2 = am.change(d2, lambda d: d["c"].increment(4))
    merged = am.merge(d1, d2)
    assert merged["c"].value == 7
    rec.doc(merged)
    rec.saved(am, merged)


def cannot_overwrite_counter(am, rec):
    d1 = am.change(am.init(), set_key("c", am.Counter(0)))
    with pytest.raises(ValueError, match="Cannot overwrite a Counter") as err:
        am.change(d1, set_key("c", 1))
    rec.value(str(err.value))


# ---------------------------------------------------------------------- #
# TestTable


def table_rows(am, rec):
    d1 = am.change(am.init(), set_key("books", am.Table()))
    row_id = {}

    def add_row(d):
        row_id["id"] = d["books"].add({"title": "STP", "author": "MK"})

    d2 = am.change(d1, add_row)
    book = d2["books"].by_id(row_id["id"])
    assert book["title"] == "STP" and book["id"] == row_id["id"]
    assert d2["books"].count == 1
    d3 = am.change(d2, lambda d: d["books"].remove(row_id["id"]))
    assert d3["books"].count == 0
    rec.value(row_id["id"])
    rec.doc(d2)
    rec.saved(am, d3)


def table_row_update(am, rec):
    d1 = am.change(am.init(), set_key("books", am.Table()))
    holder = {}

    def add(d):
        holder["id"] = d["books"].add({"title": "old"})

    d2 = am.change(d1, add)
    d3 = am.change(d2, lambda d: d["books"].by_id(holder["id"]).__setitem__(
        "title", "new"))
    assert d3["books"].by_id(holder["id"])["title"] == "new"
    rec.doc(d3)
    rec.changes(am.get_all_changes(d3))


# ---------------------------------------------------------------------- #
# TestObservable


def observable_callback(am, rec):
    observable = am.Observable()
    d1 = am.init({"actorId": "aaaaaaaa", "observable": observable})
    d1 = am.change(d1, set_key("list", ["a"]))
    events = []
    observable.observe(
        d1["list"],
        lambda diff, before, after, local, changes: events.append(
            (diff["type"], local, diff)))
    am.change(d1, lambda d: d["list"].append("b"))
    assert [e[:2] for e in events] == [("list", True)]
    rec.patch([e[2] for e in events])


CASES = [
    list_operations, list_of_objects, nested_lists,
    assignment_past_end_pads_with_none, element_ids,
    add_and_remove_same_change, text_editing, text_set,
    concurrent_text_insertion_converges, counter_in_map,
    concurrent_increments_add_up, cannot_overwrite_counter, table_rows,
    table_row_update, observable_callback,
]


@run_cases(CASES)
def test_api_types_twin(scenario, monkeypatch):
    twin(scenario, monkeypatch)

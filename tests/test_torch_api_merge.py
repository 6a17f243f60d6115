"""The port's public API against the JAX package's, twins of
tests/test_api.py's merges, conflicts, save/load and history, plus the
API's sync entry points: each scenario runs through both packages under
pinned clocks and uuid factories (test_torch_api_doc.twin) and must
observe the same documents, saves, changes, patches and sync messages.
Beyond the twins: a JAX document and a port document sync with each other
over the wire, and each package's process-global state (default backend,
uuid factory) stays its own."""
import pytest
from test_torch_api_doc import PINNED_TIME, plain, run_cases, set_key, twin

import automerge_tpu
import automerge_tpu_torch

# ---------------------------------------------------------------------- #
# TestMergeAndConflicts


def merge_disjoint_keys(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("a", 1))
    d2 = am.change(am.init("bbbbbbbb"), set_key("b", 2))
    merged = am.merge(d1, d2)
    assert merged["a"] == 1 and merged["b"] == 2
    rec.doc(merged)
    rec.saved(am, merged)


def conflict_on_same_key(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("k", "from-a"))
    d2 = am.change(am.init("bbbbbbbb"), set_key("k", "from-b"))
    merged = am.merge(d1, d2)
    assert merged["k"] == "from-b"  # higher actorId wins
    conflicts = am.get_conflicts(merged, "k")
    assert set(conflicts.values()) == {"from-a", "from-b"}
    rec.value(conflicts)


def conflict_resolution_is_symmetric(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("k", "from-a"))
    d2 = am.change(am.init("bbbbbbbb"), set_key("k", "from-b"))
    m1 = am.merge(am.clone(d1, "11111111"), d2)
    m2 = am.merge(am.clone(d2, "22222222"), d1)
    assert m1["k"] == m2["k"]
    rec.doc(m1)
    rec.saved(am, m2)


def concurrent_list_edits_converge(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("l", ["a", "b", "c"]))
    d2 = am.load(am.save(d1), "bbbbbbbb")
    d1 = am.change(d1, lambda d: d["l"].insert(1, "x"))
    d2 = am.change(d2, lambda d: d["l"].delete_at(2))
    m1 = am.merge(am.clone(d1, "11111111"), d2)
    m2 = am.merge(am.clone(d2, "22222222"), d1)
    assert list(m1["l"]) == list(m2["l"]) == ["a", "x", "b"]
    rec.doc(m1)
    rec.changes(am.get_all_changes(m2))


def get_changes_and_apply(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("a", 1))
    d1_copy = am.load(am.save(d1))
    d2 = am.change(d1, set_key("b", 2))
    changes = am.get_changes(d1, d2)
    assert len(changes) == 1
    d3, patch = am.apply_changes(d1_copy, changes)
    assert d3["b"] == 2
    rec.changes(changes)
    rec.patch(patch)


# ---------------------------------------------------------------------- #
# TestSaveLoad


def round_trip(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), lambda d: (
        d.__setitem__("map", {"k": "v"}),
        d.__setitem__("list", [1, 2, 3]),
        d.__setitem__("text", am.Text("hi")),
    ))
    d2 = am.load(rec.saved(am, d1))
    assert dict(d2["map"]) == {"k": "v"}
    assert list(d2["list"]) == [1, 2, 3]
    assert str(d2["text"]) == "hi"
    rec.doc(d2)


def save_deterministic(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("x", 1))
    assert am.save(d1) == am.save(am.load(am.save(d1)))
    rec.saved(am, d1)


def clone(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), set_key("x", 1))
    d2 = am.clone(d1, "bbbbbbbb")
    d3 = am.change(d2, set_key("y", 2))
    assert "y" not in d1
    assert d3["x"] == 1 and d3["y"] == 2
    rec.saved(am, d3)
    am.free(d2)


# ---------------------------------------------------------------------- #
# TestHistory


def history_snapshots(am, rec):
    d1 = am.change(am.init("aaaaaaaa"), "first", set_key("a", 1))
    d2 = am.change(d1, "second", set_key("b", 2))
    history = am.get_history(d2)
    assert len(history) == 2
    assert [h.change["message"] for h in history] == ["first", "second"]
    assert dict(history[0].snapshot) == {"a": 1}
    assert dict(history[1].snapshot) == {"a": 1, "b": 2}
    rec.value([h.change for h in history])


# ---------------------------------------------------------------------- #
# the sync entry points


def _sync_pair(am, rec, a, b, rounds=10):
    """generate/receive between two documents until neither sends."""
    sa, sb = am.init_sync_state(), am.init_sync_state()
    for _ in range(rounds):
        sa, msg_a = am.generate_sync_message(a, sa)
        if msg_a is not None:
            rec.append(("message", msg_a))
            b, sb, patch = am.receive_sync_message(b, sb, msg_a)
            rec.patch(patch)
        sb, msg_b = am.generate_sync_message(b, sb)
        if msg_b is not None:
            rec.append(("message", msg_b))
            a, sa, patch = am.receive_sync_message(a, sa, msg_b)
            rec.patch(patch)
        if msg_a is None and msg_b is None:
            return a, b, sa, sb
    raise AssertionError("sync did not go quiet")


def sync_two_documents(am, rec):
    a = am.change(am.init("aaaaaaaa"), {"time": 1}, lambda d: d.update(
        {"n": 1, "t": am.Text("xy"), "c": am.Counter(2)}))
    b = am.change(am.init("bbbbbbbb"), {"time": 2}, set_key("m", [1, 2]))
    b = am.change(b, lambda d: d["m"].append(3))
    a, b, sa, sb = _sync_pair(am, rec, a, b)
    assert am.equals(a, b)
    rec.doc(a)
    rec.saved(am, b)
    rec.append(("state", am.encode_sync_state(sa)))
    state = am.decode_sync_state(am.encode_sync_state(sb))
    rec.value(sorted(state["sharedHeads"]))


def sync_with_patch_callback(am, rec):
    seen = []

    def callback(patch, before, after, local, changes):
        seen.append((local, [bytes(c) for c in changes or []]))

    a = am.change(am.init("aaaaaaaa"), set_key("k", 1))
    b = am.init({"actorId": "bbbbbbbb", "patchCallback": callback})
    _a, b, _sa, _sb = _sync_pair(am, rec, a, b)
    assert b["k"] == 1 and seen and seen[-1][0] is False
    rec.value([[local, [c.hex() for c in changes]] for local, changes in seen])


CASES = [
    merge_disjoint_keys, conflict_on_same_key,
    conflict_resolution_is_symmetric, concurrent_list_edits_converge,
    get_changes_and_apply, round_trip, save_deterministic, clone,
    history_snapshots, sync_two_documents, sync_with_patch_callback,
]


@run_cases(CASES)
def test_api_merge_twin(scenario, monkeypatch):
    twin(scenario, monkeypatch)


def test_jax_and_port_documents_sync_over_the_wire():
    """A JAX document and a port document sync through each other's
    messages (the wire format is one) and end equal; each package loads
    the other's save and saves it back to the same bytes."""
    jam, pam = automerge_tpu, automerge_tpu_torch
    j = jam.change(jam.init("aaaaaaaa"), {"time": 1}, lambda d: d.update(
        {"text": jam.Text("hello"), "n": 1}))
    p = pam.change(pam.init("bbbbbbbb"), {"time": 2}, set_key("list", [1, 2]))
    sj, sp = jam.init_sync_state(), pam.init_sync_state()
    for _ in range(10):
        sj, msg_j = jam.generate_sync_message(j, sj)
        if msg_j is not None:
            p, sp, _ = pam.receive_sync_message(p, sp, msg_j)
        sp, msg_p = pam.generate_sync_message(p, sp)
        if msg_p is not None:
            j, sj, _ = jam.receive_sync_message(j, sj, msg_p)
        if msg_j is None and msg_p is None:
            break
    else:
        raise AssertionError("sync did not go quiet")
    assert plain(j) == plain(p)
    for data in (jam.save(j), pam.save(p)):
        assert pam.save(pam.load(data)) == jam.save(jam.load(data)) == data


def test_process_global_state_is_per_package():
    """set_default_backend and the uuid factory of one package never reach
    the other's."""
    import importlib

    jax_uuid = importlib.import_module("automerge_tpu.uuid")
    port_uuid = importlib.import_module("automerge_tpu_torch.uuid")

    sentinel = object()
    pam = automerge_tpu_torch
    default = pam.get_backend()
    try:
        pam.set_default_backend(sentinel)
        assert pam.get_backend() is sentinel
        assert automerge_tpu.get_backend() is not sentinel
    finally:
        pam.set_default_backend(default)
    assert pam.get_backend() is pam.backend
    try:
        port_uuid.set_factory(lambda: "ab" * 16)
        assert pam.uuid() == "ab" * 16
        assert automerge_tpu.uuid() != "ab" * 16
    finally:
        port_uuid.reset_factory()
    assert pam.uuid() != pam.uuid()
    assert jax_uuid.make_uuid() != port_uuid.make_uuid()


def test_pinned_time_reaches_the_change_bytes(monkeypatch):
    """The twins' clock pin is what makes their bytes comparable: a change
    made without a "time" carries the pinned clock in both packages."""
    def made(am, rec):
        doc = am.change(am.init("aaaaaaaa"), set_key("k", 1))
        rec.value(am.get_history(doc)[0].change["time"])

    record = twin(made, monkeypatch)
    assert record[-1] == ("value", ["int", PINNED_TIME])


@pytest.mark.parametrize("options", ["cccccccc", {"actorId": "cccccccc"}])
def test_load_and_clone_take_actor_options(options):
    pam = automerge_tpu_torch
    doc = pam.change(pam.init("aaaaaaaa"), {"time": 0}, set_key("k", 1))
    assert pam.get_actor_id(pam.load(pam.save(doc), options)) == "cccccccc"
    assert pam.get_actor_id(pam.clone(doc, options)) == "cccccccc"

"""chip_smoke.py's phase 23 (``BASELINE.json`` ``configs[3]``: a Table whose
rows hold lists, merged three ways) on the CPU at 4 docs, held against the
JAX package: the corpus built over either package's API is the same
bytes, the farm's patches equal the JAX ``TpuDocFarm``'s and both
``OpSet``s', the farm's whole documents equal ``OpSet``'s after every
delivery and every branch's at the end, a fresh replica catches up over
the Bloom sync, and the frontend fault the corpus steers round is both
packages'."""
import copy
import types

import pytest

import automerge_tpu
import automerge_tpu_torch
import chip_smoke as c
from automerge_tpu import columnar as jax_columnar
from automerge_tpu.opset import OpSet as JaxOpSet
from automerge_tpu.tpu.farm import TpuDocFarm
from test_torch_api_doc import PACKAGES, twin

DOCS = 4


@pytest.fixture(scope="module")
def corpus():
    return c.run_branch_corpus(DOCS, 0)


@pytest.fixture(scope="module")
def merged(corpus):
    deliveries, _saves, _stats = corpus
    want, opsets, reference = c.branch_reference(deliveries)
    record = []
    farm, latency = c.run_branch_merge("cpu", deliveries, want,
                                       record=record)
    return farm, want, opsets, record, latency, reference


def test_corpus_is_the_same_bytes_over_both_apis(monkeypatch):
    """Epoch by epoch, doc by doc, the JAX API and the port's make the same
    change buffers, drop the same repeats, make the same edits and save
    the same branches."""
    def scenario(am, rec):
        deliveries, saves, stats = c.run_branch_corpus(DOCS, 0, api=am)
        for epoch in deliveries:
            for bufs in epoch:
                rec.changes(bufs)
        rec.value([stats["repeats"], stats["edits"], stats["steered"]])
        for row in saves:
            rec.changes(row)

    rec = twin(scenario, monkeypatch)
    assert len(rec) == c.BRANCH_EPOCHS * DOCS + 1 + DOCS


def test_corpus_shape(corpus):
    """Four deliveries a doc: the base's two changes lead the first, then
    each epoch's 4 changes from each of the 3 branches; no change is
    delivered twice, and get_changes did repeat some. Every kind of edit
    is made, and each change makes 1 to ``BRANCH_EDITS``."""
    deliveries, saves, stats = corpus
    assert len(deliveries) == c.BRANCH_EPOCHS
    assert all(len(epoch) == DOCS for epoch in deliveries)
    per_epoch = len(c.BRANCH_ACTORS) * c.BRANCH_CHANGES
    for d in range(DOCS):
        hashes = []
        for e, epoch in enumerate(deliveries):
            changes = [automerge_tpu_torch.decode_change(b)
                       for b in epoch[d]]
            base = changes[:2] if e == 0 else []
            assert [ch["actor"] for ch in base] == [c.BRANCH_BASE] * len(base)
            branch = changes[len(base):]
            assert len(branch) == per_epoch
            assert sorted({ch["actor"] for ch in branch}) == \
                sorted(c.BRANCH_ACTORS)
            hashes.extend(ch["hash"] for ch in changes)
        assert len(hashes) == len(set(hashes))
    assert len(saves) == DOCS
    assert all(len(row) == len(c.BRANCH_ACTORS) for row in saves)
    assert stats["repeats"] >= 1
    assert list(stats["edits"]) == list(c.BRANCH_MIX)
    assert min(stats["edits"].values()) > 0
    made = sum(stats["edits"].values())
    assert per_epoch * c.BRANCH_EPOCHS * DOCS <= made <= \
        per_epoch * c.BRANCH_EPOCHS * DOCS * c.BRANCH_EDITS
    assert 0 <= stats["steered"] < made
    assert c.run_branch_corpus(1, 0)[0][0][0] == deliveries[0][0]
    assert c.run_branch_corpus(1, 1)[0][0][0] != deliveries[0][0]


class _Drawn:
    """A stand-in for the corpus's rng that draws `kind` and the first of
    any other choice."""

    def __init__(self, kind):
        self.kind = kind

    def choices(self, _population, _weights):
        return [self.kind]

    def choice(self, seq):
        return seq[0]

    def randrange(self, _n):
        return 0

    def random(self):
        return 0.0


@pytest.mark.parametrize("kind, rows, made", [
    ("remove", 1, "title"), ("delete", 1, "overwrite")])
def test_edit_steered_from_emptying_reports_what_it_made(kind, rows, made):
    """``branch_edit`` on a board of one row with one item: removing the
    last row retitles it and deleting the last item overwrites it, and it
    reports the kind drawn beside the kind made, which the phase logs."""
    am = automerge_tpu_torch
    doc = am.change(am.init("aaaa"),
                    lambda x: x.__setitem__("board", am.Table()))
    doc = am.change(doc, lambda x: x["board"].add(
        {"title": "t", "done": False, "items": ["a"]}))
    seen = []
    doc = am.change(doc, lambda x: seen.append(
        c.branch_edit(_Drawn(kind), x, "z")))
    assert seen == [(kind, made)]
    [row] = doc["board"].rows
    assert (row["title"], list(row["items"])) == (
        ("z", ["a"]) if made == "title" else ("t", ["z"]))


def test_corpus_lists_grow_shrink_and_rows_hold_lists(corpus):
    """The corpus exercises what the configuration names: every doc's board
    is a Table whose rows hold lists, and the branches' edits insert,
    delete and overwrite items concurrently."""
    deliveries, saves, _stats = corpus
    actions = set()
    for epoch in deliveries:
        for bufs in epoch:
            for buf in bufs:
                for op in automerge_tpu_torch.decode_change(buf)["ops"]:
                    actions.add((op["action"], op.get("insert", False)))
    assert {("makeTable", False), ("makeMap", False), ("makeList", False),
            ("set", True), ("set", False), ("del", False)} <= actions
    for row in saves:
        board = automerge_tpu_torch.load(row[0])["board"]
        assert type(board).__name__ == "Table" and board.count > 0
        assert all(isinstance(r["items"], list) for r in board.rows)


def test_merge_matches_jax_farm_and_both_opsets(corpus, merged):
    """(a): every delivery's patch of every doc from the port's CPU farm
    equals the port's OpSet's (the phase checks it), the JAX OpSet's and
    a JAX ``TpuDocFarm``'s fed the same deliveries; so do the whole
    patches after every delivery, which (c) holds between card and CPU."""
    deliveries, _saves, _stats = corpus
    farm, want, opsets, record, latency, _ = merged
    jax_opsets = [JaxOpSet() for _ in range(DOCS)]
    jax_want = [[o.apply_changes(bufs) for o, bufs in zip(jax_opsets, epoch)]
                for epoch in deliveries]
    assert jax_want == want
    whole = {"port": [], "jax": []}

    def reads(name):
        return lambda _e, f: whole[name].append(
            [c.canon(f.get_patch(d)) for d in range(DOCS)])

    c.run_branch_merge("cpu", deliveries, want, after=reads("port"))
    jax_record = []
    jax_farm, _ = c.run_branch_merge(
        "cpu", deliveries, jax_want, record=jax_record,
        make_farm=lambda n, cap: TpuDocFarm(n, capacity=cap),
        after=reads("jax"))
    assert jax_record == record
    assert whole["port"] == whole["jax"]
    assert len(whole["port"]) == c.BRANCH_EPOCHS
    assert len(record) == c.BRANCH_EPOCHS * DOCS
    assert len(latency) == c.BRANCH_EPOCHS
    for d in range(DOCS):
        assert farm.get_patch(d) == jax_farm.get_patch(d)
        assert farm.get_heads(d) == jax_farm.get_heads(d) == opsets[d].heads


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_whole_patch_of_a_conflicted_element_drops_its_losers(pkg):
    """A divergence both packages' farms share, which this corpus reaches
    (two branches overwrite one item concurrently): the whole-document
    patch of a list element with two values lists only the winner, where
    ``OpSet``'s lists both (an insert, then an update). The incremental
    patches agree, and so do the documents a frontend reads from them."""
    P = (c.port_pkg("cpu") if pkg == "port" else types.SimpleNamespace(
        farm=TpuDocFarm, OpSet=JaxOpSet, columnar=jax_columnar))
    make, h1 = c.farm_change(P, "aaaaaaaa", 1, 1, [], [
        {"action": "makeList", "obj": "_root", "key": "l", "pred": []},
        {"action": "set", "obj": "1@aaaaaaaa", "elemId": "_head",
         "insert": True, "value": "x", "pred": []}])
    over = [c.farm_change(P, actor, 1, 3, [h1], [
        {"action": "set", "obj": "1@aaaaaaaa", "elemId": "2@aaaaaaaa",
         "insert": False, "value": actor, "pred": ["2@aaaaaaaa"]}])[0]
        for actor in ("bbbbbbbb", "cccccccc")]
    farm, opset = P.farm(1, capacity=16), P.OpSet()
    for bufs in ([make], over):
        assert farm.apply_changes([bufs])[0] == opset.apply_changes(bufs)
    edits = farm.get_patch(0)["diffs"]["props"]["l"]["1@aaaaaaaa"]["edits"]
    want = opset.get_patch()["diffs"]["props"]["l"]["1@aaaaaaaa"]["edits"]
    assert [e["action"] for e in want] == ["insert", "update"]
    assert edits == [{**want[0], "opId": "3@cccccccc",
                      "value": want[1]["value"]}]


def test_merge_catches_a_wrong_patch(corpus, merged):
    deliveries, _saves, _stats = corpus
    want = [list(epoch) for epoch in merged[1]]
    want[1][2] = {**want[1][2], "maxOp": -1}
    with pytest.raises(RuntimeError, match="epoch 1 doc 2"):
        c.run_branch_merge("cpu", deliveries, want)


def test_merge_is_deterministic_on_the_cpu(corpus, merged):
    """(c)'s premise: a second CPU farm on the first docs gives the same
    patches, as the card's must."""
    deliveries, _saves, _stats = corpus
    record = []
    c.run_branch_merge("cpu", [e[:2] for e in deliveries],
                       [e[:2] for e in merged[1]], record=record)
    assert record == [p for e in range(c.BRANCH_EPOCHS)
                      for p in merged[3][e * DOCS:e * DOCS + 2]]


def test_farm_converges_after_every_delivery(corpus, merged):
    """(b) over both packages: after every delivery the port's farm's
    whole documents equal ``OpSet``'s, with its heads; after the last the
    port's branches equal the port's farm, and the JAX API's branches a
    JAX farm."""
    deliveries, saves, _stats = corpus
    reference = merged[5]
    checked = []

    def after(e, farm):
        assert c.check_whole(farm, reference[e], f"epoch {e}", keep=2) == [
            c.canon(farm.get_patch(d)) for d in range(2)]
        checked.append(e)

    farm, _ = c.run_branch_merge("cpu", deliveries, merged[1], after=after)
    assert checked == list(range(c.BRANCH_EPOCHS))
    c.check_branches(farm, saves, "port")
    deliveries, branches, _ = c.run_branch_corpus(DOCS, 0, api=automerge_tpu)
    jax_farm = TpuDocFarm(DOCS, capacity=c.BRANCH_CAPACITY)
    for epoch in deliveries:
        jax_farm.apply_changes(epoch)
    c.check_branches(jax_farm, branches, "jax", api=automerge_tpu)


def _first_string(diff):
    """The first string value diff in a patch, depth first."""
    if isinstance(diff, dict):
        if diff.get("type") == "value" and isinstance(diff.get("value"), str):
            return diff
        values = diff.values()
    elif isinstance(diff, list):
        values = diff
    else:
        return None
    for value in values:
        found = _first_string(value)
        if found is not None:
            return found
    return None


def test_convergence_check_raises_on_one_altered_patch(corpus, merged,
                                                       monkeypatch):
    farm = merged[0]
    real = farm.get_patch
    altered = copy.deepcopy(real(1))
    _first_string(altered["diffs"])["value"] = "altered"

    monkeypatch.setattr(farm, "get_patch",
                        lambda d: altered if d == 1 else real(d))
    with pytest.raises(RuntimeError, match="doc 1 branch 0: its saved"):
        c.check_branches(farm, corpus[1], "altered")
    monkeypatch.setattr(farm, "get_patch", real)
    heads = farm.get_heads
    monkeypatch.setattr(farm, "get_heads",
                        lambda d: heads(d)[:0] if d == 2 else heads(d))
    with pytest.raises(RuntimeError, match="doc 2 branch 0: heads"):
        c.check_branches(farm, corpus[1], "heads")


def test_convergence_check_raises_on_an_earlier_epochs_patch(corpus,
                                                             merged):
    """The check after a delivery before the last catches a whole patch
    altered there, and wrong heads: each delivery's farm is held to
    ``OpSet``'s documents after that delivery, not only the last."""
    deliveries, _saves, _stats = corpus
    reference = merged[5]

    def altering(e, farm):
        if e == 1:
            real = farm.get_patch
            altered = copy.deepcopy(real(3))
            _first_string(altered["diffs"])["value"] = "altered"
            farm.get_patch = lambda d: altered if d == 3 else real(d)
        c.check_whole(farm, reference[e], f"epoch {e}")

    with pytest.raises(RuntimeError,
                       match="epoch 1: doc 3: the farm's whole document"):
        c.run_branch_merge("cpu", deliveries, merged[1], after=altering)
    stale = [[(doc, heads[:0] if (e, d) == (2, 0) else heads)
              for d, (doc, heads) in enumerate(epoch)]
             for e, epoch in enumerate(reference)]
    with pytest.raises(RuntimeError, match="epoch 2: doc 0: the farm's heads"):
        c.run_branch_merge("cpu", deliveries, merged[1],
                           after=lambda e, farm: c.check_whole(
                               farm, stale[e], f"epoch {e}"))


def test_catchup_converges_on_the_cpu(merged):
    """(d): a fresh replica reaches the farm's heads and whole patches
    over the Bloom sync, and the last sweep moves nothing."""
    farm = merged[0]
    messages = []
    replica, sweeps = c.run_branch_catchup("cpu", farm, DOCS,
                                           messages.append)
    assert sweeps[-1].moved == 0 and len(sweeps) >= 2
    assert sum(isinstance(m, bytes) for m in messages) == \
        sum(sw.moved for sw in sweeps) > 0
    for d in range(DOCS):
        assert replica.get_heads(d) == farm.get_heads(d)
    c.check_no_quarantine([farm, replica], "catch-up")


def test_rank_timer_counts_the_whole_document_reads(merged):
    farm = merged[0]
    with c.timed_rga_ranks("cpu") as ranks:
        for d in range(DOCS):
            farm.get_patch(d)
    assert ranks == {"calls": DOCS, "ms": None}


def test_phase_runs_on_the_cpu_up_to_the_launch_check():
    """The whole phase at 4 docs on the CPU: (a)-(c) and the catch-up
    hold, and it stops where the CPU cannot go, at the Bloom kernels'
    launch check."""
    table = {"kernels": [{}, {}]}
    with c.counting_fallbacks(), \
            pytest.raises(RuntimeError, match="never launched bloom_build"):
        c.run_branch_phase(types.SimpleNamespace(seed=0), table, "cpu",
                           "cpu", docs=DOCS)


@pytest.mark.parametrize("am", PACKAGES, ids=lambda am: am.__name__)
def test_emptied_object_reads_stale_in_the_same_change(am):
    """The fault ``branch_edit`` steers round, in both packages' frontends:
    once a change has emptied a list, the next read of it in that change
    returns the list as it was before the change, and overwriting its
    first element fails."""
    doc = am.change(am.init("bbbb"),
                    lambda x: x.__setitem__("row", {"items": ["a"]}))
    seen = []

    def edit(x):
        x["row"]["items"].delete_at(0)
        seen.append(list(x["row"]["items"]))
        x["row"]["items"][0] = "z"

    with pytest.raises(IndexError):
        am.change(doc, edit)
    assert seen == [["a"]]

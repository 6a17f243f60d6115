"""chip_smoke.py's phase 22 runs on the CPU at a small size, each held
against the JAX package: (a) the nine farm-basics cases through both
packages' farms and OpSets, (b) the copy of tests/test_farm.py's
``Workload`` against the suite's own generator, the differential run
against a ``TpuDocFarm`` on the same deliveries and its oracle catching a
wrong patch, (c) the counter configuration's stream and run against a
``TpuDocFarm`` and the JAX ``OpSet``, (d) the sync v2 sweeps and
(e) the instrument counts against the JAX registry's."""
import pytest

import chip_smoke as c
import test_farm
from automerge_tpu.columnar import decode_change
from automerge_tpu.obs.metrics import enabled_metrics as jax_enabled_metrics
from automerge_tpu.obs.metrics import get_metrics as jax_get_metrics
from automerge_tpu.opset import OpSet as JaxOpSet
from automerge_tpu.tpu.farm import TpuDocFarm
from test_torch_faults_domain import twin_pkgs

DIFF_DOCS, DIFF_ROUNDS = 6, 6
# (c) at a small size: actors, changes per actor, increments per change
ACTORS, CHANGES, INCS = 8, 4, 8


def test_farm_basics_run_matches_jax(monkeypatch):
    """(a): the nine cases through each package's farm, each call held to
    that package's OpSet, the records equal."""
    rec = twin_pkgs(lambda P, rec: rec.extend(c.run_farm_basics(P)),
                    monkeypatch)
    assert len(rec) == 14


@pytest.mark.parametrize("kw", [
    {"delay_prob": c.DIFF_DELAY},
    {"with_counters": False, "with_nesting": False},
])
def test_workload_copy_is_the_suite_generator(kw):
    """(b)'s ``FarmWorkload`` over the port draws the same buffers as
    tests/test_farm.py's ``Workload`` over the JAX package, round by round,
    drain included."""
    for d in range(3):
        seed = c.DIFF_SEED + 17 * d
        ours, theirs = c.FarmWorkload(seed, **kw), test_farm.Workload(seed, **kw)
        port_opset, jax_opset = c.port_pkg("cpu").OpSet(), JaxOpSet()
        for rnd in range(DIFF_ROUNDS + 1):
            got = ours.next_round(port_opset) if rnd < DIFF_ROUNDS \
                else ours.drain()
            want = theirs.next_round(jax_opset) if rnd < DIFF_ROUNDS \
                else theirs.drain()
            assert got == want, f"seed {seed} round {rnd}"
            port_opset.apply_changes(got)
            jax_opset.apply_changes(want)


@pytest.fixture(scope="module")
def diff():
    return c.diff_traffic(range(DIFF_DOCS), DIFF_ROUNDS, c.DIFF_SEED,
                          delay_prob=c.DIFF_DELAY)


def test_diff_run_matches_jax_farm(diff):
    """(b) at 6 docs: the phase's checks hold on the CPU, and a JAX
    ``TpuDocFarm`` fed the same deliveries returns the same patches."""
    deliveries, want, opsets = diff
    farm, _seconds = c.run_farm_diff("cpu", deliveries, want, opsets)
    jax_farm = TpuDocFarm(DIFF_DOCS, capacity=c.DIFF_CAPACITY)
    for rnd, per_doc in enumerate(deliveries):
        assert list(jax_farm.apply_changes(per_doc)) == want[rnd], rnd
    for d in range(DIFF_DOCS):
        assert farm.get_patch(d) == jax_farm.get_patch(d)
        assert farm.get_heads(d) == jax_farm.get_heads(d)
    assert len(deliveries) == DIFF_ROUNDS + c.DIFF_DRAIN


def test_diff_run_catches_a_wrong_patch(diff):
    deliveries, want, opsets = diff
    rnd = next(r for r, per_doc in enumerate(want) if per_doc[1]["diffs"])
    wrong = [list(per_doc) for per_doc in want]
    wrong[rnd][1] = {**wrong[rnd][1], "maxOp": -1}
    with pytest.raises(RuntimeError, match=f"round {rnd} doc 1"):
        c.run_farm_diff("cpu", deliveries, wrong, opsets)
    # a pair listed as a known divergence must diverge
    with pytest.raises(RuntimeError, match=f"round {rnd} doc 1.*equals"):
        c.run_farm_diff("cpu", deliveries, want, opsets, known={(rnd, 1)})


def test_known_divergences_are_the_jax_farms():
    """(b)'s ``DIFF_KNOWN``: at 512 docs the incremental patches of docs 366
    and 449 differ from OpSet's at these rounds in the JAX farm too, and
    the two farms' patches are equal there; their neighbours agree with
    OpSet throughout. Every whole-doc patch agrees with OpSet's at the
    end."""
    ids = [365, 366, 449, 450]
    deliveries, want, opsets = c.diff_traffic(
        ids, c.DIFF_ROUNDS, c.DIFF_SEED, delay_prob=c.DIFF_DELAY)
    known = c.known_divergences(ids)
    assert len(known) == len(c.DIFF_KNOWN) == 14
    record = []
    c.run_farm_diff("cpu", deliveries, want, opsets, known, record=record)
    jax_farm, diverged, jax_record = TpuDocFarm(len(ids), capacity=256), set(), []
    for rnd, per_doc in enumerate(deliveries):
        got = jax_farm.apply_changes(per_doc)
        diverged |= {(rnd, i) for i in range(len(ids)) if got[i] != want[rnd][i]}
        jax_record.extend(c.canon(p) for p in got)
    assert diverged == known
    assert record == jax_record
    for i, opset in enumerate(opsets):
        assert jax_farm.get_patch(i) == opset.get_patch()


@pytest.fixture(scope="module")
def counter_rounds():
    return c.counter_stream(ACTORS, CHANGES, INCS, 0)


def test_counter_stream_is_the_configuration(counter_rounds):
    """(c)'s stream: one creating change, then every actor's r-th change in
    round r, each of `INCS` increments of 1 on the counter's op id, on the
    actor's previous change; the same stream for a seed."""
    assert [len(r) for r in counter_rounds] == [1] + [ACTORS] * CHANGES
    create = decode_change(counter_rounds[0][0])
    target = f"1@{create['actor']}"
    assert create["ops"][0]["action"] == "set" and \
        create["ops"][0]["datatype"] == "counter"
    seen = {}
    for r, bufs in enumerate(counter_rounds[1:]):
        for buf in bufs:
            change = decode_change(buf)
            actor = change["actor"]
            assert change["startOp"] == 2 + r * INCS
            assert len(change["ops"]) == INCS
            assert all(op["action"] == "inc" and op["value"] == 1 and
                       op["pred"] == [target] for op in change["ops"])
            assert change["deps"] == [seen.get(actor, create["hash"])]
            seen[actor] = change["hash"]
    assert len(seen) == ACTORS
    assert c.counter_stream(ACTORS, CHANGES, INCS, 0) == counter_rounds
    assert c.counter_stream(ACTORS, CHANGES, INCS, 1) != counter_rounds


def test_counter_run_matches_jax(counter_rounds):
    """(c) at 8 actors x 4 x 8: the phase's checks hold on the CPU against
    the port's OpSet, and a JAX ``TpuDocFarm`` and the JAX ``OpSet`` fed the
    same rounds give docs 0-1 the same patches."""
    per_round = ACTORS * INCS
    record = []
    farm, _seconds = c.run_counters("cpu", 3, counter_rounds, per_round,
                                    record=record,
                                    opset=c.port_pkg("cpu").OpSet())
    jax_farm, jax_opset, want = TpuDocFarm(3, capacity=64), JaxOpSet(), []
    for bufs in counter_rounds:
        patches = list(jax_farm.apply_changes([bufs] * 3))
        assert patches[0] == jax_opset.apply_changes(bufs)
        want.extend(c.canon(p) for p in patches[:c.COUNTER_CPU_DOCS])
    assert record == want
    assert int(farm.engine.lengths.sum()) == 3 * (1 + CHANGES * per_round)
    assert c.counter_value(farm.get_patch(2), "doc 2") == CHANGES * per_round


def test_counter_run_checks_the_closed_form(counter_rounds):
    with pytest.raises(RuntimeError, match="round 1 doc 0"):
        c.run_counters("cpu", 1, counter_rounds, ACTORS * INCS + 1)


def test_v2_sweeps_hold_on_the_cpu():
    """(d): converged with at most one reduction per generate call, and the
    same messages and patches in a second run."""
    first, second = [], []
    per_call = c.run_v2_sweeps("cpu", first)
    c.run_v2_sweeps("cpu", second)
    assert first == second and first
    assert max(per_call) == 1 and per_call[-1] == 0


def test_instrument_counts_match_jax_registry():
    """(e): the port's counts for the two-call case equal the JAX
    registry's for the same case (tests/test_obs.py:439)."""
    from automerge_tpu.obs.__main__ import _change_stream

    got = c.run_instrument_counts("cpu")
    reg = jax_get_metrics()
    reg.reset()
    with jax_enabled_metrics():
        farm = TpuDocFarm(5, capacity=96)
        for buf in _change_stream("aaaaaaaa", 2, 4, seed=0):
            farm.apply_changes([[buf]] * 5)
    want = {name: reg.as_dict()[name]["value"] for name in (
        "farm.rows.transcoded", "farm.rows.padding", "farm.changes.applied",
        "engine.device.dispatches")}
    assert {k: got[k] for k in want} == want
    assert got["engine.jit.cache_hits"] + got["engine.jit.recompiles"] == \
        want["engine.device.dispatches"] == 6
    reg.reset()


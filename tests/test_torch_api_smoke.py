"""Smoke gate for the port's public API against its farm, phase 17 of
chip_smoke.py on the CPU: ``chip_smoke.run_api`` at 8 docs x 4 API
clients x 2 rounds (one 16-op change per client per round: root-map sets,
list and Text inserts and deletes, a Counter increment, from round 2 a
Table row), each round delivered to a ``TorchDocFarm`` and synced back to
every client over the Bloom protocol. The same scenario runs through the
JAX package's API, ``TpuDocFarm`` and ``SyncFarm``; every farm patch,
sync message, patch and ``save()`` must be byte-identical, and the two
program observatories must count the same dispatches."""
import pytest

import automerge_tpu
import automerge_tpu_torch
import chip_smoke
from automerge_tpu.obs import prof as jax_prof
from automerge_tpu_torch.obs import prof as port_prof

DOCS, CLIENTS, ROUNDS = 8, 4, 2


def _jax_farm(docs, capacity):
    from automerge_tpu.tpu.farm import TpuDocFarm

    return TpuDocFarm(docs, capacity=capacity)


@pytest.fixture(scope="module")
def runs():
    """Both packages through phase 17's scenario with their observatories
    on: {package: (farm, clients, stats, record, programs, stale)}."""
    from automerge_tpu.tpu.sync_farm import SyncFarm as JaxSyncFarm

    out = {}
    for name, prof, kwargs in (
            ("jax", jax_prof, dict(api=automerge_tpu, make_farm=_jax_farm,
                                   sync_cls=JaxSyncFarm)),
            ("port", port_prof, {})):
        record = []
        obs = prof.get_observatory()
        with chip_smoke.counting_fallbacks(), prof.enabled_observatory():
            obs.reset()
            fallbacks = chip_smoke.fallback_counts()
            farm, clients, stats = chip_smoke.run_api(
                "cpu", DOCS, CLIENTS, ROUNDS, 0, record=record, **kwargs)
            programs = {n: r["dispatches"] for n, r in obs.table().items()}
            obs.reset()
            if name == "port":
                chip_smoke.check_no_fallback(fallbacks, [farm], "api smoke")
        api = kwargs.get("api", automerge_tpu_torch)
        stale = chip_smoke.check_api(farm, clients, f"api smoke ({name})",
                                     api=api)
        out[name] = (farm, clients, stats, record, programs, stale)
    return out


def test_records_are_byte_identical_to_jax(runs):
    want, got = runs["jax"][3], runs["port"][3]
    assert len(got) == len(want) > 0
    assert got == want


def test_clients_converge_with_the_farm(runs):
    """check_api passed in the fixture (every client's saved document
    equals the farm's, heads equal); the sync went quiet every round."""
    farm, clients, stats, *_ = runs["port"]
    assert len(stats["sweeps"]) == ROUNDS
    assert all(sweeps[-1].moved == 0 for sweeps in stats["sweeps"])
    assert not farm.degraded
    for d, row in enumerate(clients):
        assert len(row) == CLIENTS
        for doc in row:
            assert len(automerge_tpu_torch.get_all_changes(doc)) == \
                len(farm.get_all_changes(d))


def test_live_views_that_lag_the_farm_match_jax(runs):
    """The live documents that differ from the farm's (the incremental
    patch of both packages' backends drops a concurrent value, ROADMAP
    queue C) are the same clients, lagging at the same keys, in both
    packages; check_api held each lagging key to a conflict's value."""
    assert runs["port"][5] == runs["jax"][5]
    assert runs["port"][5]


def test_launch_recorders_see_the_sync_paths_kernels():
    """``chip_smoke.recorded_bloom_launches`` sees every Bloom launch the
    farm's sync makes through the ``sync.*`` names, keeps the largest
    one's inputs, and puts the kernels back afterwards."""
    from automerge_tpu_torch.tpu import bloom_kernels as bk

    fns = bk.bloom_build.fn, bk.bloom_query.fn
    with chip_smoke.recorded_bloom_launches() as (build, query):
        _farm, _clients, stats = chip_smoke.run_api("cpu", 2, 2, 1, 0)
    assert (bk.bloom_build.fn, bk.bloom_query.fn) == fns
    assert build.args is not None and query.args is not None
    assert sum(n for n, _ in build.shapes.values()) > 0
    assert sum(n for n, _ in query.shapes.values()) > 0
    assert len(stats["sweeps"]) == 1


@pytest.mark.parametrize("bad", ["other value", "other key", "missing key",
                                 "extra key"])
def test_conflict_lag_refuses_any_other_difference(bad):
    """A live view may differ from its saved document only by holding
    another value of a conflict at a root key (``chip_smoke.conflict_lag``);
    any other difference fails phase 17."""
    am = automerge_tpu_torch
    a = am.change(am.init("aa" * 8), {"time": 0},
                  lambda x: x.update({"k": "a", "n": 1}))
    b = am.change(am.init("bb" * 8), {"time": 0},
                  lambda x: x.update({"k": "b"}))
    saved = am.merge(a, b)
    conflicts = am.get_conflicts(saved, "k")
    assert sorted(conflicts.values()) == ["a", "b"]
    live = {key: saved[key] for key in saved.keys()}
    assert chip_smoke.conflict_lag(am, live, saved, "t") == []
    loser = next(v for v in conflicts.values() if v != saved["k"])
    assert chip_smoke.conflict_lag(am, {**live, "k": loser}, saved,
                                   "t") == ["k"]
    live = {"other value": {**live, "k": "c"},
            "other key": {**live, "n": 2},
            "missing key": {"k": live["k"]},
            "extra key": {**live, "x": 1}}[bad]
    with pytest.raises(RuntimeError, match="not by a value of a conflict"):
        chip_smoke.conflict_lag(am, live, saved, "t")


def test_every_api_change_has_the_planned_ops(runs):
    from automerge_tpu_torch.columnar import decode_change

    farm = runs["port"][0]
    for d in range(DOCS):
        changes = [decode_change(c) for c in farm.get_all_changes(d)]
        assert len(changes) == 1 + CLIENTS * ROUNDS
        seed, edits = changes[0], changes[1:]
        assert seed["message"] == "seed"
        assert all(len(c["ops"]) == chip_smoke.API_OPS for c in edits)
        actions = {op["action"] for c in edits for op in c["ops"]}
        assert {"set", "del", "inc", "makeMap"} <= actions


def test_program_dispatches_match_jax(runs):
    """Each farm program the phase drives dispatches as often in the port
    as in the JAX package. The port's ``sync.*`` filter programs are its
    Bloom kernels' programs under the JAX names, and the phase calls no
    kernel but through them."""
    want, got = runs["jax"][4], runs["port"][4]
    assert {n: v for n, v in got.items() if not n.startswith("kernel.")} \
        == want
    for name in chip_smoke.API_PROGRAMS:
        assert got[name] > 0, name
    assert got["kernel.bloom_build"] == want["sync.build_filters"]
    assert got["kernel.bloom_query"] == want["sync.query_filters"]


def test_uuid_factories_are_restored(runs):
    """run_api pins each package's uuid factory for its run only."""
    ids = {automerge_tpu_torch.uuid() for _ in range(3)}
    assert len(ids) == 3 and not any(i.startswith("0" * 20) for i in ids)

"""The port's memory sampler and the export pivots the observatory feeds,
against the JAX package's (tests/test_prof.py), on the CPU: the same fakes
through both packages' ``Sampler`` give the same samples and gauges, a real
farm of each package samples to the same page figures, each sampler reads
its own package's DecodeCache when both are loaded, and ``shard_table`` /
``program_table`` pivot the same snapshots the same way. The port's
``obs`` package re-exports what the JAX package's does."""
import json

import numpy as np
import pytest

from automerge_tpu.obs import export as jax_export
from automerge_tpu.obs import metrics as jax_metrics
from automerge_tpu.obs import prof as jax_prof
from automerge_tpu_torch.obs import export as port_export
from automerge_tpu_torch.obs import metrics as port_metrics
from automerge_tpu_torch.obs import prof as port_prof

PACKAGES = {"jax": (jax_prof, jax_metrics), "port": (port_prof, port_metrics)}


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakePages:
    def __init__(self, allocated, free):
        self._allocated = allocated
        self._free = list(free)
        self.page_size = np.int64(64)  # deliberately numpy: must be cast

    @property
    def allocated(self):
        return np.int64(self._allocated)

    @property
    def free_count(self):
        return len(self._free)


class FakeEngine:
    def __init__(self, pages, lengths):
        self.pages = pages
        self.lengths = np.asarray(lengths, np.int64)


class FakeCols:
    def __init__(self, nbytes, sorted_nbytes=0):
        self.arr = np.zeros(nbytes, np.uint8)
        self._sorted = (
            (np.zeros(sorted_nbytes, np.uint8),) if sorted_nbytes else None)


class FakeFarm:
    def __init__(self, engine, cols_cache):
        self.engine = engine
        self._cols_cache = cols_cache


def make_sampler(pkg):
    prof, metrics = PACKAGES[pkg]
    registry = metrics.MetricsRegistry(enabled=True)
    clock = ManualClock()
    return prof.Sampler(registry=registry, clock=clock), registry, clock


def both(scenario):
    return [scenario(*make_sampler(pkg)) for pkg in PACKAGES]


def _without_decode(sample):
    """A sample less the DecodeCache bytes, which each package reads from
    its own codecs module (compared in the test below)."""
    return {k: v for k, v in sample.items() if k != "decode_cache_bytes"}


def test_sampler_page_math_and_int_casts():
    # free list {3,4,5, 9}: longest run 3 of 4 free -> fragmentation 0.25
    def scenario(sampler, registry, _clock):
        engine = FakeEngine(FakePages(allocated=6, free=[9, 3, 5, 4]),
                            lengths=[np.int64(100), np.int64(92)])
        sample = sampler.sample(farm=FakeFarm(engine, {}))
        snap = registry.as_dict()
        return (_without_decode(sample),
                snap["prof.mem.pages.allocated"]["value"],
                snap["prof.mem.pages.fragmentation"]["value"])

    jax_run, port_run = both(scenario)
    sample, allocated, fragmentation = port_run
    assert sample["pages_allocated"] == 6 and sample["pages_free"] == 4
    assert sample["rows"] == 192
    assert sample["occupancy"] == 0.5       # 192 rows / (6 * 64)
    assert sample["fragmentation"] == 0.25  # 1 - 3/4
    for key, value in sample.items():
        assert not isinstance(value, np.generic), (key, type(value))
    assert '"' not in json.dumps(list(sample.values()))
    assert (allocated, fragmentation) == (6, 0.25)
    assert port_run == jax_run


def test_sampler_counts_change_col_bytes_and_sentinels():
    def scenario(sampler, registry, _clock):
        engine = FakeEngine(FakePages(allocated=1, free=[]), lengths=[4])
        cache = {
            "a": FakeCols(100),
            "b": FakeCols(40, sorted_nbytes=10),
            "c": object(),  # uncacheable sentinel: counted, zero bytes
        }
        sample = sampler.sample(farm=FakeFarm(engine, cache))
        return (sample["change_cols_bytes"], sample["change_cols_entries"],
                registry.as_dict()["prof.mem.change_cols.bytes"]["value"])

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == (150, 3, 150)


def test_sampler_ring_is_bounded():
    def scenario(sampler, _registry, clock):
        engine = FakeEngine(FakePages(allocated=1, free=[]), lengths=[1])
        sampler.samples = type(sampler.samples)(maxlen=4)
        for _ in range(10):
            clock.t += 1.0
            sampler.sample(engine=engine)
        return len(sampler.samples), sampler.samples[-1]["t"]

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == (4, 10.0)


def test_sampler_reads_its_own_package_decode_cache():
    """Both packages loaded, each DecodeCache pinning a different byte
    count: each Sampler reports its own package's, never the other's."""
    from automerge_tpu.codecs import DecodeCache as JaxDecodeCache
    from automerge_tpu_torch.codecs import DecodeCache

    jax_cache = JaxDecodeCache(4, name="prof-twin-jax")
    port_cache = DecodeCache(4, name="prof-twin-port")
    try:
        jax_base = make_sampler("jax")[0].sample()["decode_cache_bytes"]
        port_base = make_sampler("port")[0].sample()["decode_cache_bytes"]
        jax_cache.put(b"x" * 100, {"decoded": True})
        port_cache.put(b"y" * 300, {"decoded": True})
        jax_got = make_sampler("jax")[0].sample()["decode_cache_bytes"]
        port_got = make_sampler("port")[0].sample()["decode_cache_bytes"]
    finally:
        jax_cache.clear()
        port_cache.clear()
    assert type(port_got) is int
    assert port_got - port_base >= 300
    assert jax_got - jax_base >= 100
    assert port_got - port_base != jax_got - jax_base


@pytest.mark.parametrize("deliveries", [1, 3])
def test_sampler_on_real_farms_matches_jax(deliveries):
    """One farm of each package fed the same changes samples to the same
    slab pages, rows, occupancy and fragmentation."""
    from automerge_tpu.tpu.farm import TpuDocFarm
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.obs.__main__ import _change_stream

    streams = [_change_stream(f"{d:02x}" * 4, deliveries, 40, seed=d)
               for d in range(3)]
    farms = {"jax": TpuDocFarm(3, capacity=64),
             "port": TorchDocFarm(3, capacity=64, device="cpu")}
    samples = {}
    for pkg, farm in farms.items():
        for r in range(deliveries):
            farm.apply_changes([[s[r]] for s in streams])
        sample = make_sampler(pkg)[0].sample(farm=farm)
        samples[pkg] = {k: v for k, v in sample.items()
                        if k.startswith(("pages", "page_size", "rows",
                                         "occupancy", "fragmentation"))}
    assert samples["port"] == samples["jax"]
    assert samples["port"]["rows"] == 3 * deliveries * 40


# ---------------------------------------------------------------------- #
# export pivots


def _hist(count, total):
    return {"type": "histogram", "count": count, "sum": total, "p99": 1.0}


def test_shard_table_pivots_pipe_rows_without_shadowing():
    snapshot = {
        "mesh.shard.0.docs": {"type": "counter", "value": 12},
        "mesh.shard.0.dispatch_ms": _hist(3, 42.0),
        "mesh.pipe.0.bytes_out": {"type": "counter", "value": 512},
        "mesh.pipe.0.bytes_in": {"type": "counter", "value": 2048},
        "mesh.pipe.0.serialize_ms": _hist(4, 1.5),
        "serve.flush.shard.0.docs": {"type": "counter", "value": 7},
        "mesh.pipe.1.bytes_out": {"type": "counter", "value": 99},
        "farm.changes.applied": {"type": "counter", "value": 5},
    }
    table = port_export.shard_table(snapshot)
    assert sorted(table) == [0, 1]
    row = table[0]
    assert row["docs"] == 12 and row["flush.docs"] == 7
    assert row["pipe.bytes_out"] == 512 and row["pipe.bytes_in"] == 2048
    assert row["pipe.serialize_ms"]["count"] == 4
    assert table[1] == {"pipe.bytes_out": 99}
    assert table == jax_export.shard_table(snapshot)


def test_program_table_rolls_up_prof_rows():
    snapshot = {
        "prof.program.paging.apply_ops.compiles":
            {"type": "counter", "value": 2},
        "prof.program.paging.apply_ops.dispatches":
            {"type": "counter", "value": 9},
        "prof.program.paging.apply_ops.dispatch_ms": _hist(9, 123.4567),
        "prof.program.kernel.bloom_build.dispatches":
            {"type": "counter", "value": 3},
        "mesh.shard.0.docs": {"type": "counter", "value": 1},
    }
    table = port_export.program_table(snapshot)
    assert list(table) == ["kernel.bloom_build", "paging.apply_ops"]
    assert table["paging.apply_ops"]["compiles"] == 2
    assert table["paging.apply_ops"]["dispatch_ms"] == 123.457
    assert table["kernel.bloom_build"] == {"dispatches": 3}
    assert table == jax_export.program_table(snapshot)


def test_obs_package_reexports_match_jax():
    import automerge_tpu.obs as jax_obs
    import automerge_tpu_torch.obs as port_obs

    assert sorted(port_obs.__all__) == sorted(jax_obs.__all__)
    for name in port_obs.__all__:
        assert getattr(port_obs, name).__module__.startswith(
            "automerge_tpu_torch."), name


def test_enabled_observability_turns_the_whole_stack_on_and_off():
    import automerge_tpu_torch.obs as port_obs

    parts = (port_obs.get_metrics(), port_obs.get_amscope(),
             port_obs.get_flight(), port_obs.get_observatory())
    before = [p.enabled for p in parts]
    with port_obs.enabled_observability():
        assert all(p.enabled for p in parts)
    assert [p.enabled for p in parts] == before

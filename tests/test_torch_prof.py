"""The port's program observatory (automerge_tpu_torch/obs/prof.py,
tpu/jitprof.py) against the JAX package's (tests/test_prof.py), on the CPU.

Each scenario runs through both observatories with the same calls on the
same clocks and must give the same tallies, stats, flight events and storm
verdicts. In the port a compile is a dispatch at a shape bucket new to the
program (obs/prof.py); the JAX twins drive a stand-in jitted function
whose cache grows by one per distinct argument shape, which is that same
rule. Beside them: the roster of registered programs, one CPU scenario
that dispatches every program of both packages with both observatories on
(equal dispatch counts under the JAX names, kernels as ``kernel.*``), the
engine's ``engine.recompile`` and ``engine.slab.grow`` flight events
against the JAX engine's, and the disabled path's cost (no bucket work).
"""
import numpy as np
import pytest
import torch

from automerge_tpu.obs import flight as jax_flight
from automerge_tpu.obs import metrics as jax_metrics
from automerge_tpu.obs import prof as jax_prof
from automerge_tpu_torch.obs import flight as port_flight
from automerge_tpu_torch.obs import metrics as port_metrics
from automerge_tpu_torch.obs import prof as port_prof

PACKAGES = {
    "jax": (jax_prof, jax_metrics, jax_flight),
    "port": (port_prof, port_metrics, port_flight),
}

#: every program the port registers (tpu/jitprof.py's roster)
PROGRAMS = (
    "engine.apply_ops", "engine.visible_cmp", "engine.gather_rows",
    "paging.apply_ops", "paging.probe_ops", "paging.visible_plain",
    "paging.visible_ranked", "paging.patch_column_rows",
    "paging.dense_view", "paging.adopt_rows",
    "sync.build_filters", "sync.query_filters", "sync.fingerprint_ranges",
    "rga.rank",
    "kernel.bloom_build", "kernel.bloom_query", "kernel.leb128_segment_sum",
)

#: the JAX programs each of the port's Bloom programs stands for (the
#: ``sync.*`` names are aliases of the kernel wrappers' programs)
JAX_PROGRAMS = {
    name: ("sync.build_filters", "pallas.bloom_build")
    for name in ("sync.build_filters", "kernel.bloom_build")
} | {
    name: ("sync.query_filters", "pallas.bloom_query")
    for name in ("sync.query_filters", "kernel.bloom_query")
}


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeJit:
    """A jitted-function stand-in: every distinct arg shape grows the
    tracing cache by one, like jax.jit's per-signature cache (the port
    ignores ``_cache_size`` and counts the same shapes as buckets)."""

    __name__ = "fake_jit"

    def __init__(self):
        self.shapes = set()
        self.calls = 0

    def __call__(self, x, *rest, **kwargs):
        self.calls += 1
        self.shapes.add(getattr(x, "shape", None))
        return x

    def _cache_size(self):
        return len(self.shapes)


def make_observatory(pkg, **kwargs):
    prof, metrics, flight = PACKAGES[pkg]
    registry = metrics.MetricsRegistry(enabled=True)
    rec = flight.FlightRecorder(clock=lambda: 0.0)
    rec.enabled = True
    clock = ManualClock()
    obs = prof.Observatory(registry=registry, flight=rec, clock=clock,
                           **kwargs)
    return obs, registry, rec, clock


def arr(*shape):
    return np.zeros(shape, np.int32)


def both(scenario, **kwargs):
    """Runs `scenario(obs, registry, flight, clock)` through each package's
    observatory; returns the two results (JAX, port)."""
    return [scenario(*make_observatory(pkg, **kwargs)) for pkg in PACKAGES]


def events(rec, name):
    return [e["fields"] for e in rec.snapshot() if e["event"] == name]


# ---------------------------------------------------------------------- #
# ProfiledProgram


def test_disabled_program_falls_through_without_tallies():
    def scenario(obs, registry, _flight, _clock):
        fn = FakeJit()
        prog = obs.register("t.prog", fn)
        out = prog(arr(4))
        return (out.shape, fn.calls, prog.dispatches, prog.compiles,
                "prof.program.t.prog.dispatches" in registry.as_dict())

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == ((4,), 1, 0, 0, False)


def test_enabled_program_attributes_compiles_and_dispatches():
    def scenario(obs, registry, _flight, clock):
        prog = obs.register("t.prog", FakeJit())
        obs.enable()
        prog(arr(4))          # new shape: compile
        clock.t += 0.25
        prog(arr(4))          # warm shape: plain dispatch
        prog(arr(8))          # new shape: compile
        snap = registry.as_dict()
        return (prog.compiles, prog.dispatches,
                snap["prof.program.t.prog.compiles"]["value"],
                snap["prof.program.t.prog.dispatches"]["value"],
                snap["prof.program.t.prog.dispatch_ms"]["count"])

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == (2, 3, 2, 3, 3)


def test_dispatch_wall_time_reads_the_injected_clock():
    def scenario(obs, _registry, _flight, clock):
        prog = obs.register("t.prog", FakeJit())
        obs.enable()
        original = prog.fn

        def slow(x):
            clock.t += 0.5
            return original(x)

        prog.fn = slow
        prog(arr(4))
        return prog.stats()["dispatch_ms"]

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == 500.0


def test_recompile_event_carries_program_identity():
    def scenario(obs, _registry, rec, _clock):
        prog = obs.register("t.prog", FakeJit())
        obs.enable()
        prog(arr(4), arr(2, 2))
        return events(rec, "engine.recompile")

    jax_run, port_run = both(scenario)
    assert len(port_run) == 1
    fields = port_run[0]
    assert fields["program"] == "t.prog" and fields["fn"] == "fake_jit"
    assert fields["cache_size"] == 1
    assert [tuple(s) for s in fields["shapes"]] == [(2, 2), (4,)]
    assert port_run == jax_run


def test_recompile_event_fires_even_when_observatory_disabled():
    """The flight event is gated on the flight recorder alone; the
    observatory flag only gates the tallies."""
    def scenario(obs, _registry, rec, _clock):
        prog = obs.register("t.prog", FakeJit())
        _out, grew, _dt = prog.call_profiled((arr(4),), {})
        return grew, [e["event"] for e in rec.snapshot()], prog.dispatches

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == (1, ["engine.recompile"], 0)


def test_plain_function_compiles_once_per_shape_bucket():
    """Where the JAX observatory cannot probe a plain function (growth
    -1), the port counts its buckets: the torch meaning of a compile."""
    obs, _registry, rec, _clock = make_observatory("port")
    prog = obs.register("t.plain", lambda x: x)
    obs.enable()
    grown = [prog.call_profiled((arr(*s),), {})[1]
             for s in ((4,), (4,), (2, 2), (4,))]
    assert grown == [1, 0, 1, 0]
    assert prog.compiles == 2 and prog.cache_size() == 2
    assert len(events(rec, "engine.recompile")) == 2
    # like a jit cache, the buckets seen outlive a reset of the tallies
    obs.reset()
    assert prog.call_profiled((arr(4),), {})[1] == 0
    assert prog.compiles == 0 and prog.dispatches == 1


def test_reregistration_rebinds_fn_but_keeps_tallies():
    def scenario(obs, _registry, _flight, _clock):
        prog = obs.register("t.prog", FakeJit())
        obs.enable()
        prog(arr(4))
        reloaded = FakeJit()
        again = obs.register("t.prog", reloaded)
        return again is prog, prog.fn is reloaded, prog.compiles

    jax_run, port_run = both(scenario)
    assert port_run == jax_run == (True, True, 1)


def test_shape_bucket_walks_nested_containers():
    args = ((arr(4), [arr(2, 3), (arr(4),)]), {"k": {"n": arr(5)}})
    want = [(2, 3), (4,), (5,)]
    assert jax_prof.shape_bucket(*args) == port_prof.shape_bucket(*args) == want
    assert port_prof.shape_bucket((1, "x"), {}) == []
    # tensors and torch.Size shapes read as plain tuples
    tensors = ((torch.zeros(4), [torch.zeros(2, 3, dtype=torch.int64)]),
               {"n": torch.zeros(5, dtype=torch.bool)})
    assert port_prof.shape_bucket(*tensors) == want


# ---------------------------------------------------------------------- #
# Observatory: storm detector, table, context manager


def test_storm_fires_once_and_rearms():
    def scenario(obs, _registry, rec, _clock):
        prog = obs.register("t.prog", FakeJit())
        obs.enable()
        for n in range(1, 6):
            prog(arr(n))  # every call is a fresh shape: 5 compiles
        return events(rec, "prof.recompile.storm")

    jax_run, port_run = both(scenario, storm_compiles=3, storm_window_s=10.0)
    # 3 compiles -> storm, detector clears, 2 more compiles stay below K
    assert len(port_run) == 1
    fields = port_run[0]
    assert fields["program"] == "t.prog" and fields["compiles"] == 3
    assert fields["window_s"] == 10.0 and fields["buckets"]
    assert port_run == jax_run


def test_slow_compile_drizzle_never_storms():
    def scenario(obs, _registry, rec, clock):
        prog = obs.register("t.prog", FakeJit())
        obs.enable()
        for n in range(1, 7):
            prog(arr(n))
            clock.t += 6.0  # compiles 6s apart: never 3 inside a 10s window
        return events(rec, "prof.recompile.storm"), prog.compiles

    jax_run, port_run = both(scenario, storm_compiles=3, storm_window_s=10.0)
    assert port_run == jax_run == ([], 6)


def test_table_reports_only_active_programs_as_plain_ints():
    import json

    def scenario(obs, _registry, _flight, _clock):
        obs.register("t.idle", FakeJit())
        prog = obs.register("t.busy", FakeJit())
        obs.enable()
        prog(arr(4))
        return obs.table()

    jax_run, port_run = both(scenario)
    assert list(port_run) == ["t.busy"]
    stats = port_run["t.busy"]
    assert type(stats["compiles"]) is int and type(stats["dispatches"]) is int
    assert stats["cache_size"] == 1 and stats["buckets"] == [[[4]]]
    json.dumps(port_run)  # fully serializable, no default= needed
    assert port_run == jax_run


def test_enabled_observatory_restores_prior_state():
    for prof in (jax_prof, port_prof):
        obs = prof.get_observatory()
        assert obs.enabled is False
        with prof.enabled_observatory():
            assert obs.enabled is True
            with prof.enabled_observatory():
                assert obs.enabled is True
            assert obs.enabled is True
        assert obs.enabled is False
    # two observatories: enabling one leaves the other off
    with port_prof.enabled_observatory():
        assert jax_prof.get_observatory().enabled is False


def test_roster_registers_every_program_under_the_jax_name():
    """Importing the port's tpu layer registers every program it has: the
    JAX package's roster (tests/test_prof.py), ``engine.apply_ops`` (the
    dense whole-state merge) included, with the three CUDA kernel wrappers
    as ``kernel.*`` for the JAX ``pallas.*``."""
    import automerge_tpu.tpu.pallas_kernels  # noqa: F401 - registration
    import automerge_tpu.tpu.paging  # noqa: F401
    import automerge_tpu.tpu.rga  # noqa: F401
    import automerge_tpu.tpu.sync_batch  # noqa: F401
    import automerge_tpu.tpu.fingerprint  # noqa: F401
    import automerge_tpu_torch.tpu.farm  # noqa: F401 - registration
    import automerge_tpu_torch.tpu.leb_kernels  # noqa: F401
    import automerge_tpu_torch.tpu.sync_farm  # noqa: F401

    port = set(port_prof.get_observatory().programs())
    jax = {n for n in jax_prof.get_observatory().programs()
           if n.split(".")[0] in ("engine", "paging", "sync", "rga", "pallas")}
    assert port == set(PROGRAMS)
    assert {n.replace("kernel.", "pallas.") for n in port} == jax
    obs = port_prof.get_observatory()
    for kind in ("build", "query"):
        prog = obs.program(f"kernel.bloom_{kind}")
        assert obs.program(f"sync.{kind}_filters") is prog
        assert prog.name == f"kernel.bloom_{kind}"


# ---------------------------------------------------------------------- #
# the engine's flight events and the disabled path


def _stream(rounds, ops, actor="aaaaaaaa", seed=0):
    from automerge_tpu_torch.obs.__main__ import _change_stream

    return _change_stream(actor, rounds, ops, seed=seed)


def _jax_farm(docs, capacity):
    from automerge_tpu.tpu.farm import TpuDocFarm

    return TpuDocFarm(docs, capacity=capacity)


def _port_farm(docs, capacity):
    from automerge_tpu_torch import TorchDocFarm

    return TorchDocFarm(docs, capacity=capacity, device="cpu")


RECOMPILE_PROBE = """
import json, sys
sys.path.insert(0, "tests")
import test_torch_prof as t
buf = t._stream(1, 4)[0]
out = {}
for pkg, make in (("jax", t._jax_farm), ("port", t._port_farm)):
    _prof, metrics, flight = t.PACKAGES[pkg]
    with flight.enabled_flight() as rec:
        rec.clear()
        farm = make(2, 32)
        with metrics.enabled_metrics():
            farm.apply_changes([[buf], [buf]])
        out[pkg] = [{"program": e["program"], "fn": e["fn"],
                     "shapes": e["shapes"]}
                    for e in t.events(rec, "engine.recompile")]
print("EVENTS=" + json.dumps(out))
"""


def test_engine_recompile_event_names_shape_bucket():
    """Twin of tests/test_flight.py's: a fresh farm's first delivery under
    metrics and the flight recorder records ``engine.recompile`` with the
    program, its function and the shape bucket, in both packages. Both
    run in a fresh interpreter: a JAX program compiled at these shapes by
    an earlier test in this process records no event, and which ones did
    depends on the order the files ran in."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", RECOMPILE_PROBE], cwd=root,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.split("EVENTS=")[1])
    names = {}
    for pkg in ("jax", "port"):
        assert got[pkg], f"{pkg}: fresh shapes dispatched without a recompile event"
        assert got[pkg][0]["fn"] and got[pkg][0]["shapes"]
        names[pkg] = {e["program"] for e in got[pkg]}
    assert "paging.apply_ops" in names["port"]
    assert names["port"] <= names["jax"]


def test_slab_grow_event_matches_jax():
    """The port's engine records ``engine.slab.grow`` with the JAX engine's
    fields when a delivery outgrows the slab (2 docs x 4 pages against the
    4 pages a 2-doc, 32-row farm starts with)."""
    bufs = [_stream(1, 200, actor=a)[0] for a in ("aaaaaaaa", "bbbbbbbb")]
    grows = {}
    for pkg, make in (("jax", _jax_farm), ("port", _port_farm)):
        _prof, _metrics, flight = PACKAGES[pkg]
        with flight.enabled_flight() as rec:
            rec.clear()
            farm = make(2, 32)
            farm.apply_changes([[bufs[0]], [bufs[1]]])
            grows[pkg] = events(rec, "engine.slab.grow")
    assert grows["port"] == grows["jax"]
    assert grows["port"] and set(grows["port"][0]) == {"pages", "rows"}


def test_disabled_dispatch_does_no_bucket_work(monkeypatch):
    """With metrics and the observatory off, the engine's funnel calls the
    bare function: no shape bucket is computed, no tally moves."""
    import automerge_tpu_torch.tpu.paging  # noqa: F401 - registration

    def boom(*_a, **_k):
        raise AssertionError("shape bucket computed on the disabled path")

    monkeypatch.setattr(port_prof, "shape_bucket", boom)
    assert not port_metrics.get_metrics().enabled
    assert not port_prof.get_observatory().enabled
    prog = port_prof.get_observatory().programs()["paging.apply_ops"]
    before = (prog.dispatches, prog.cache_size())
    farm = _port_farm(2, 32)
    result = farm.apply_changes([[_stream(1, 4)[0]], []])
    assert not result.quarantined and not farm.degraded
    assert farm.get_patch(0)
    assert (prog.dispatches, prog.cache_size()) == before


# ---------------------------------------------------------------------- #
# every program of both packages, dispatched on one CPU scenario

A_ACTOR = "aa" * 16


def _list_doc_changes():
    """A list and a Text through the port's API (byte-identical to the
    JAX package's, tests/test_torch_api_doc.py)."""
    import automerge_tpu_torch as am

    doc = am.change(am.init(A_ACTOR), {"time": 0},
                    lambda d: d.update({"l": [1, 2], "t": am.Text("ab")}))
    return am.get_all_changes(doc)


def _scenario(pkg):
    """Drives every program of one package once or more: two deliveries to
    a map doc, a list/text doc in a farm of its own and its whole-doc read,
    a scoped visibility readback, a probe, a migration, a sync sweep with
    one v2 and one v1 replica, the dense
    merge and visibility programs, both Bloom kernels and the device LEB128 scan.
    Returns {program: dispatches} from the package's observatory."""
    import chip_smoke

    data = np.frombuffer(b"".join(_stream(2, 6)), np.uint8).copy()
    rng = np.random.default_rng(4)
    xyz = rng.integers(0, 2**32, (2, 5, 3), dtype=np.uint64).astype(np.uint32)
    counts = np.array([5, 3], np.int32)
    vis = [np.full((1, 8), 2**31 - 1, np.int32), np.zeros((1, 8), np.int64),
           np.zeros((1, 8), np.int32), np.zeros((1, 8), np.int64),
           np.full((1, 8), -1, np.int64), np.zeros((1, 8), bool)]
    pad = [np.full((1, 4), 2**31 - 1, np.int32), np.zeros((1, 4), np.int64),
           np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int64),
           np.full((1, 4), -1, np.int64)]
    if pkg == "jax":
        import jax.numpy as jnp

        from automerge_tpu.tpu import decode, engine
        from automerge_tpu.tpu import pallas_kernels as kernels
        from automerge_tpu.tpu.sync_farm import SyncFarm

        make = _jax_farm
        probe = engine.ChangeOpsBatch(*[jnp.asarray(x) for x in pad])

        def dense_visible():
            state = engine.batched_apply_ops(engine.BatchedDocState(
                *[jnp.asarray(x) for x in vis], jnp.zeros(1, jnp.int32)),
                probe)
            engine.batched_visible_state(state)

        def run_kernels():
            words, modulo = kernels.bloom_build(xyz, counts, 2, interpret=True)
            kernels.bloom_query(words, modulo, counts, xyz, interpret=True)
            decode.leb128_scan_device(data)
    else:
        from automerge_tpu_torch.tpu import bloom_kernels as kernels
        from automerge_tpu_torch.tpu import decode, engine
        from automerge_tpu_torch.tpu.sync_farm import SyncFarm

        make = _port_farm
        probe = engine.changes_from_numpy(*pad, device="cpu")

        def dense_visible():
            state = engine.batched_apply_ops(engine.BatchedDocState(
                *[torch.from_numpy(x) for x in vis],
                torch.zeros(1, dtype=torch.int32)), probe)
            engine.batched_visible_state(state)

        def run_kernels():
            x, c = torch.from_numpy(xyz.view(np.int32)), torch.from_numpy(counts)
            words, modulo = kernels.bloom_build(x, c, 2)
            kernels.bloom_query(words, modulo, c, x)
            decode.leb128_scan_device(torch.from_numpy(data))

    prof = PACKAGES[pkg][0]
    obs = prof.get_observatory()
    with prof.enabled_observatory():
        obs.reset()
        server, v2_peer, v1_peer = make(3, 64), make(3, 64), make(3, 64)
        stream = _stream(2, 6)
        # no doc may stay empty on every side: both packages' SyncFarm
        # never goes quiet on such a doc
        server.apply_changes([[stream[0]]] * 3)
        server.apply_changes([[stream[1]]] * 3)  # the fused patch path
        lists = make(1, 64)
        lists.apply_changes([_list_doc_changes()])
        lists.get_patch(0)  # the device RGA rank
        server.engine.read_visibility_rows([(0, np.arange(2))])
        server.engine.probe_apply(probe, [0])
        make(3, 64).adopt_doc(2, server.export_doc(0))
        chip_smoke.sync_until_quiet(
            "cpu", SyncFarm(server), [SyncFarm(v2_peer), SyncFarm(v1_peer)],
            3, lambda _x: None, v2_replicas=1)
        dense_visible()
        run_kernels()
        table = {name: row["dispatches"] for name, row in obs.table().items()}
        obs.reset()
    return table


def test_program_dispatches_match_jax():
    """Each port program dispatches as often as its JAX counterpart on the
    same scenario. The port's sync programs run the CUDA kernel wrappers
    (the JAX package's run XLA): the port's one program stands for both
    JAX programs and counts both's dispatches, under either name."""
    jax_table, port_table = _scenario("jax"), _scenario("port")
    assert sorted(port_table) == sorted(PROGRAMS), port_table
    for name in PROGRAMS:
        want = sum(jax_table.get(n, 0) for n in JAX_PROGRAMS.get(
            name, (name.replace("kernel.", "pallas."),)))
        assert port_table[name] == want > 0, (name, port_table, jax_table)

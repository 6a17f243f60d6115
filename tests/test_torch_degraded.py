"""The degraded walk after a failed device dispatch, the port against the
JAX farm on the CPU: each package's own ``farm.device_dispatch`` fault
point is injected with ``fail_docs``/``fail_always`` during the same
delivery, and the two farms must agree on every outcome (status, fallback
flag, error kind), every patch, every whole-document read and the degraded
walk's metrics — on map and list documents, on the call after the fault,
and for a degraded document carried across from a JAX export."""
import pytest

from automerge_tpu.obs.metrics import enabled_metrics as jax_enabled_metrics
from automerge_tpu.obs.metrics import get_metrics as jax_get_metrics
from automerge_tpu.testing import faults as jax_faults
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu_torch import TorchDocFarm
from automerge_tpu_torch.carry import doc_from_jax_export
from automerge_tpu_torch.errors import DeviceFaultError
from automerge_tpu_torch.obs.metrics import enabled_metrics, get_metrics
from automerge_tpu_torch.testing import faults
from test_farm_lists import ListWorkload

METRICS = ("farm.bisect.rounds", "farm.fallback.calls", "farm.fallback.docs",
           "farm.quarantine.causes.device")


def healthy_change(actor, seq, start_op, deps=(), key="k", value=1):
    return faults.make_change(actor, seq, start_op, deps,
                              [faults.set_op(key, value)])


def _counts(registry):
    snap = registry.as_dict()
    return {name: snap.get(name, {"value": 0})["value"] for name in METRICS}


def _deliver(jax, port, per_doc, jax_hook=None, port_hook=None):
    """One delivery to both farms, each with its own package's hook at
    ``farm.device_dispatch`` (none when None). Returns (want, got, the
    JAX metric deltas, the port's metric deltas)."""
    j0, p0 = _counts(jax_get_metrics()), _counts(get_metrics())
    with jax_enabled_metrics(), enabled_metrics():
        if jax_hook is None:
            want = jax.apply_changes(per_doc)
            got = port.apply_changes(per_doc)
        else:
            with jax_faults.inject("farm.device_dispatch", jax_hook):
                want = jax.apply_changes(per_doc)
            with faults.inject("farm.device_dispatch", port_hook):
                got = port.apply_changes(per_doc)
    j1, p1 = _counts(jax_get_metrics()), _counts(get_metrics())
    return (want, got, {k: j1[k] - j0[k] for k in METRICS},
            {k: p1[k] - p0[k] for k in METRICS})


def _outcomes_equal(got, want):
    assert len(got.outcomes) == len(want.outcomes)
    for d, (g, w) in enumerate(zip(got.outcomes, want.outcomes)):
        assert (g.status, g.fallback, g.error_kind, g.offending_hashes) == (
            w.status, w.fallback, w.error_kind, w.offending_hashes), f"doc {d}"
        assert type(g.error).__name__ == type(w.error).__name__, f"doc {d}"
    assert list(got) == list(want)


def _whole_docs_equal(jax, port):
    assert port.degraded == jax.degraded
    for d in range(jax.num_docs):
        assert port.get_heads(d) == jax.get_heads(d), f"heads doc {d}"
        assert port.get_patch(d) == jax.get_patch(d), f"get_patch doc {d}"
        assert port.get_all_changes(d) == jax.get_all_changes(d)


def _seeded_maps(n):
    jax = TpuDocFarm(n, capacity=64, quarantine_threshold=None)
    port = TorchDocFarm(n, capacity=64, quarantine_threshold=None,
                        device="cpu")
    seeds = [[healthy_change(f"{d:08x}", 1, 1, value=d)] for d in range(n)]
    _deliver(jax, port, seeds)
    return jax, port


@pytest.mark.parametrize("poison", [[0], [3], [2, 5]])
def test_map_docs_bisect_and_walk_like_jax(poison):
    jax, port = _seeded_maps(8)
    second = [[healthy_change(f"{d:08x}", 2, 2, jax.get_heads(d), key="r2",
                              value=d * 10)] for d in range(8)]
    slab = [col.clone() for col in port.engine.slab]
    lengths = port.engine.lengths.copy()
    want, got, jm, pm = _deliver(jax, port, second,
                                 jax_faults.fail_docs(poison),
                                 faults.fail_docs(poison))
    _outcomes_equal(got, want)
    # the failed dispatch and every bisection probe wrote nothing
    assert all(a.equal(b) for a, b in zip(port.engine.slab, slab))
    assert (port.engine.lengths == lengths).all()
    assert sorted(got.quarantined) == poison
    for d in poison:
        assert isinstance(got.outcomes[d].error, DeviceFaultError)
        assert got.outcomes[d].error_kind == "device"
        assert len(port.get_all_changes(d)) == 1  # rolled back
    assert all(got.outcomes[d].fallback for d in range(8) if d not in poison)
    assert pm == jm
    assert pm["farm.fallback.calls"] == 1
    assert pm["farm.fallback.docs"] == 8 - len(poison)
    assert pm["farm.quarantine.causes.device"] == len(poison)
    assert pm["farm.bisect.rounds"] > 0
    _whole_docs_equal(jax, port)


def test_degraded_docs_keep_applying_on_the_next_call():
    jax, port = _seeded_maps(4)
    second = [[healthy_change(f"{d:08x}", 2, 2, jax.get_heads(d), key="r2")]
              for d in range(4)]
    _deliver(jax, port, second, jax_faults.fail_docs([2]),
             faults.fail_docs([2]))
    assert port.degraded == {0, 1, 3}
    third = [[healthy_change(f"{d:08x}", 3, 3, jax.get_heads(d), key="r3")]
             for d in range(4)]
    third[2] = second[2]  # the poisoned delivery, again, on a sound device
    want, got, jm, pm = _deliver(jax, port, third)
    _outcomes_equal(got, want)
    assert not got.quarantined and not any(o.fallback for o in got.outcomes)
    assert pm == jm == dict.fromkeys(METRICS, 0)
    _whole_docs_equal(jax, port)


def test_wedged_device_blames_nobody_and_walks_every_doc():
    jax, port = _seeded_maps(4)
    second = [[healthy_change(f"{d:08x}", 2, 2, jax.get_heads(d), key="r2")]
              for d in range(4)]
    want, got, jm, pm = _deliver(jax, port, second, jax_faults.fail_always(),
                                 faults.fail_always())
    _outcomes_equal(got, want)
    assert not got.quarantined
    assert all(o.status == "applied" and o.fallback for o in got.outcomes)
    assert pm == jm
    assert pm["farm.fallback.docs"] == 4
    assert pm["farm.quarantine.causes.device"] == 0
    _whole_docs_equal(jax, port)


@pytest.mark.parametrize("poison", [0, 1])
def test_list_docs_bisect_and_walk_like_jax(poison):
    """List/text documents (embedded walk + device rank): the fault round
    quarantines one doc and walk-serves the other, and the rounds after it
    (the lost delivery re-sent first) keep both farms equal."""
    jax = TpuDocFarm(2, capacity=512)
    port = TorchDocFarm(2, capacity=512, device="cpu")
    loads = [ListWorkload(60 + d) for d in range(2)]

    def next_round():
        bufs = [loads[d].next_change(jax.get_heads(d)) for d in range(2)]
        return [[b] if b else [] for b in bufs]

    for _ in range(3):
        want, got, _, _ = _deliver(jax, port, next_round())
        _outcomes_equal(got, want)
    lost = next_round()
    want, got, jm, pm = _deliver(jax, port, lost,
                                 jax_faults.fail_docs([poison]),
                                 faults.fail_docs([poison]))
    _outcomes_equal(got, want)
    assert list(got.quarantined) == [poison]
    assert got.outcomes[1 - poison].fallback
    assert pm == jm
    _whole_docs_equal(jax, port)
    for r in range(3):
        per_doc = next_round()
        if r == 0:
            per_doc[poison] = lost[poison] + per_doc[poison]
        want, got, _, _ = _deliver(jax, port, per_doc)
        _outcomes_equal(got, want)
    _whole_docs_equal(jax, port)


def test_jax_degraded_export_carries_across():
    """A document the JAX farm walk-serves after a failed dispatch carries
    across: the port rebuilds its walk, keeps it degraded, and serves the
    next deliveries with the JAX farm's patches."""
    jax, _ = _seeded_maps(3)
    second = [[healthy_change(f"{d:08x}", 2, 2, jax.get_heads(d), key="r2")]
              for d in range(3)]
    with jax_faults.inject("farm.device_dispatch", jax_faults.fail_docs([0])):
        jax.apply_changes(second)
    assert jax.degraded == {1, 2}
    port = TorchDocFarm(3, capacity=64, quarantine_threshold=None,
                        device="cpu")
    for d in (2, 0, 1):
        port.adopt_doc(d, doc_from_jax_export(jax.export_doc(d)))
    _whole_docs_equal(jax, port)
    third = [[healthy_change(f"{d:08x}", 3, 3, jax.get_heads(d), key="r3")]
             for d in range(3)]
    third[0] = second[0]
    want, got, _, _ = _deliver(jax, port, third)
    _outcomes_equal(got, want)
    _whole_docs_equal(jax, port)


def test_engine_fault_point_degrades_like_the_farm_point():
    """``engine.apply_batch`` fires inside the engine's dispatch: the farm
    treats it as a failed dispatch, as the JAX farm does (each probe of the
    bisection runs the merge, which does not fire the point, so nobody is
    blamed)."""
    jax, port = _seeded_maps(4)
    second = [[healthy_change(f"{d:08x}", 2, 2, jax.get_heads(d), key="r2")]
              for d in range(4)]
    with jax_faults.inject("engine.apply_batch", jax_faults.fail_always()):
        want = jax.apply_changes(second)
    with faults.inject("engine.apply_batch", faults.fail_always()):
        got = port.apply_changes(second)
    _outcomes_equal(got, want)
    assert all(o.fallback for o in got.outcomes)
    _whole_docs_equal(jax, port)


def test_registries_are_separate():
    """A hook in the JAX package's registry never fires in the port."""
    _, port = _seeded_maps(2)
    second = [[healthy_change(f"{d:08x}", 2, 2, port.get_heads(d))]
              for d in range(2)]
    with jax_faults.inject("farm.device_dispatch", jax_faults.fail_always()):
        got = port.apply_changes(second)
    assert not any(o.fallback for o in got.outcomes)
    assert not port.degraded


def test_phase14_checks_pass_on_the_cpu():
    """chip_smoke.py's device-fault phase, at a small size on the CPU."""
    import chip_smoke

    stats = chip_smoke.run_device_fault("cpu", 6, 2, 3)
    assert stats["round1"]["farm.fallback.docs"] == 7
    assert stats["round3"]["farm.fallback.docs"] == 8

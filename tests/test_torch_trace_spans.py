"""The port's program spans and counters behind the benchmark's per-layer
metrics: the farm's ``decode/decode_parse`` and ``prevalidate``, the
six spans of a ``SyncFarm`` call (v1 and v2 channels), nothing recorded on
a disabled trace, the counters ``decode.cache.lookups``,
``sync.channels.swept`` and ``farm.gate.rounds`` (exact on a stream, and
shown by the obs CLI's canned workload), and a tiny run of each benchmark
cell that reports the new metrics."""
import contextlib
import importlib.util
import io
import json
import os
import uuid

import pytest

from automerge_tpu_torch import SyncFarm, TorchDocFarm
from automerge_tpu_torch.columnar import decode_change_columns
from automerge_tpu_torch.obs import metrics
from automerge_tpu_torch.obs.__main__ import main as obs_main
from automerge_tpu_torch.profiling import PhaseProfile, use_profile
from automerge_tpu_torch.testing.faults import make_change, set_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SYNC_SPANS = ("sync.plan", "sync.bloom_build", "sync.bloom_query",
              "sync.finish")
RECEIVE_SPANS = ("sync.receive_decode", "sync.receive_post")
COUNTERS = ("decode.cache.lookups", "farm.gate.rounds", "sync.channels.swept")
SEED = 2**33 + 29


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _actor():
    return uuid.uuid4().hex[:8]


def _chain(actor, n):
    """`n` changes of one actor, each on the one before it."""
    bufs, deps = [], []
    for seq in range(1, n + 1):
        buf = make_change(actor, seq, seq, deps, [set_op(f"k{seq}", seq)])
        bufs.append(buf)
        deps = [decode_change_columns(buf)["hash"]]
    return bufs


def _counts(prof):
    return {path: calls for path, (_, calls) in prof.totals_by_path().items()}


# ---------------------------------------------------------------------- #
# the farm


def test_farm_records_decode_parse_and_prevalidate_once():
    farm = TorchDocFarm(2, capacity=32, device="cpu")
    bufs = _chain(_actor(), 2)
    prof = PhaseProfile()
    with use_profile(prof):
        farm.apply_changes([bufs, bufs[:1]])
    calls = _counts(prof)
    assert calls["decode/decode_parse"] == 1
    assert calls["prevalidate"] == 1
    assert calls["decode"] == 1


# ---------------------------------------------------------------------- #
# the sync driver


def _sweep(prof, protocol):
    """One message each way between two one-document farms on `protocol`;
    returns the calls of generate_messages and of receive_messages."""
    farms = [TorchDocFarm(1, capacity=32, device="cpu") for _ in range(2)]
    syncs = [SyncFarm(f) for f in farms]
    farms[0].apply_changes([_chain(_actor(), 2)])
    farms[1].apply_changes([_chain(_actor(), 1)])
    states = [SyncFarm.init_state(), SyncFarm.init_state()]
    generated = received = 0
    with use_profile(prof):
        for src, dst in ((0, 1), (1, 0)):
            ((states[src], msg),) = syncs[src].generate_messages(
                [(0, states[src])], protocols=[protocol])
            generated += 1
            assert msg is not None
            ((states[dst], _),) = syncs[dst].receive_messages(
                [(0, states[dst], msg)])
            received += 1
    return generated, received


@pytest.mark.parametrize("protocol", ["v1", "v2"])
def test_a_sweep_records_each_sync_span_once_per_call(protocol):
    prof = PhaseProfile()
    generated, received = _sweep(prof, protocol)
    # bare paths: the sync spans sit at the top of the tree, beside the
    # phases of the farm's apply inside receive_messages
    calls = _counts(prof)
    assert {s: calls[s] for s in SYNC_SPANS} == dict.fromkeys(
        SYNC_SPANS, generated)
    assert {s: calls[s] for s in RECEIVE_SPANS} == dict.fromkeys(
        RECEIVE_SPANS, received)
    if protocol == "v1":
        # the reply carries changes; v2's first round trip only ranges
        assert calls["decode"] >= 1


def test_a_disabled_trace_records_no_span():
    prof = PhaseProfile(enabled=False)
    farm = TorchDocFarm(2, capacity=32, device="cpu")
    bufs = _chain(_actor(), 2)
    with use_profile(prof):
        farm.apply_changes([bufs, bufs[:1]])
    _sweep(prof, "v1")
    assert prof.totals_by_path() == {}


# ---------------------------------------------------------------------- #
# counters


def test_counters_count_a_stream_with_a_repeated_buffer():
    reg = metrics.get_metrics()
    names = ("decode.cache.lookups", "codecs.vector.chunks",
             "farm.gate.rounds", "sync.channels.swept")
    farm = TorchDocFarm(2, capacity=32, device="cpu")
    sync = SyncFarm(farm)
    first, second = _chain(_actor(), 2)
    reg.reset()
    with metrics.enabled_metrics():
        # doc 0 takes the chain out of order: the gate's fixpoint sweeps
        # twice (the second finds nothing to change); doc 1's lone change
        # extends committed heads and skips the loop
        farm.apply_changes([[second, first], [first]])
        sync.generate_messages([(0, SyncFarm.init_state()),
                                (1, SyncFarm.init_state())])
        snap = reg.as_dict()
    values = {n: snap[n]["value"] for n in names}
    reg.reset()
    assert values == {"decode.cache.lookups": 3, "codecs.vector.chunks": 2,
                      "farm.gate.rounds": 2, "sync.channels.swept": 2}
    assert farm.get_heads(0) == [decode_change_columns(second)["hash"]]


@pytest.fixture(scope="module")
def canned_metrics():
    """The metrics of the obs CLI's canned workload (a farm merge and a
    sync round trip on the CPU), as its JSON report carries them."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert obs_main(["--docs", "2", "--rounds", "2", "--ops", "4",
                         "--device", "cpu", "--json"]) == 0
    metrics.get_metrics().reset()
    return json.loads(out.getvalue())["metrics"]


@pytest.mark.parametrize("name", COUNTERS)
def test_the_obs_cli_shows_the_counter(canned_metrics, name):
    """The operator's view of each counter: the canned workload's metrics
    table counts it."""
    assert canned_metrics[name]["value"] > 0


# ---------------------------------------------------------------------- #
# the benchmark's readers, on a tiny copy of its tree

#: the end-to-end metrics an untraced run of each cell reports
END_TO_END = {
    "map-sync-128": {"setup_s", "merged_ops_per_s", "sync_lag_p95_ms",
                     "sync_bytes_per_change"},
    "counter-64a": {"setup_s", "merged_ops_per_s", "apply_p95_ms"},
    "map-ingest-1k": {"setup_s", "merged_ops_per_s", "apply_p95_ms"},
}
FARM_HOST = {"farm.decode_parse_us_per_row", "farm.prevalidate_us_per_row"}
SYNC_HOST = {"sync.plan_ms_per_sweep", "sync.bloom_ms_per_sweep",
             "sync.finish_ms_per_sweep", "sync.receive_ms_per_sweep"}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark's runner and a tiny copy of its tree, made as its own
    tests make one. A run takes one thread, as the runner pins it; the
    environment a run sets and the thread count are put back afterwards."""
    import torch

    saved, threads = dict(os.environ), torch.get_num_threads()
    torch.set_num_threads(1)
    conftest = _load("bench_conftest",
                     os.path.join(BENCH, "tests", "conftest.py"))
    root = conftest.make_tiny_tree(tmp_path_factory.mktemp("tiny"))
    yield _load("bench_run", os.path.join(BENCH, "run.py")), root, conftest
    torch.set_num_threads(threads)
    os.environ.clear()
    os.environ.update(saved)


@pytest.mark.parametrize("cell", sorted(END_TO_END))
def test_a_traced_cell_reports_the_new_host_metrics(bench, cell):
    run, root, conftest = bench
    traced, check, _ = run.run_cell(cell, SEED, 0.0, True, device="cpu",
                                    root=root, steps=conftest.TINY_STEPS)
    assert traced["correct"], check.notes
    want = FARM_HOST | (SYNC_HOST if cell == "map-sync-128" else set())
    got = set(traced["metrics"])
    assert want <= got, want - got
    assert all(traced["metrics"][m]["value"] >= 0 for m in want)
    if cell != "map-sync-128":
        assert not SYNC_HOST & got
    plain, _, _ = run.run_cell(cell, SEED, 0.0, False, device="cpu",
                               root=root, steps=conftest.TINY_STEPS)
    assert set(plain["metrics"]) == END_TO_END[cell]

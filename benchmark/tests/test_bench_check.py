"""The output check: sound CPU runs of every cell pass it, the control and
every planted fault fail it, and the result line is the contract's."""
import ast
import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH, CELLS, ROOT, TINY_STEPS

import control
import run
from harness import plugins

SEED = 2**32 + 99


def _run(root, cell, plant=None, trace=False, **kw):
    result, check, info = run.run_cell(cell, SEED, 0.0, trace, device="cpu",
                                       root=root, plant=plant,
                                       steps=TINY_STEPS, **kw)
    return result, check, info


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_a_cpu_farm(tiny_root, cell):
    result, check, info = _run(tiny_root, cell)
    assert result["correct"], check.notes
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert info["patches_checked"] > 0 and info["states_checked"] > 0
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contracts_keys(tiny_root, trace):
    result, _, _ = _run(tiny_root, "map-sync-128", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(result) == keys + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    names = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    assert set(result["metrics"]) <= names
    if not trace:
        assert {"setup_s", "merged_ops_per_s", "sync_lag_p95_ms",
                "sync_bytes_per_change"} == set(result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_the_records_are_off_the_collectors_heap():
    """A record is pickled when it is made: the collector tracks none,
    later changes to the patch do not reach it, and it reads back as the
    snapshot it was."""
    import gc

    from harness import cells

    props = {"f0": {"1@aa": {"type": "value", "value": "x"}}}
    clock = {"aa": 1}
    records = cells.Records()
    records.append(cells.Snapshot(0, 3, clock, ["h"], 1, 0, props, [5]))
    props["f0"]["1@aa"]["value"] = "changed"
    clock["aa"] = 2
    assert len(records) == 1
    assert not any(gc.is_tracked(blob) for blob in records._blobs)
    assert list(records) == [cells.Snapshot(
        0, 3, {"aa": 1}, ["h"], 1, 0,
        {"f0": {"1@aa": {"type": "value", "value": "x"}}}, [5])]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(tiny_root, cell):
    result, check, _ = _run(tiny_root, cell,
                            make_farms=control.control_farms(tiny_root),
                            driver_cls=control.control_driver(cell,
                                                              tiny_root))
    assert not result["correct"]
    assert check.state_mismatches > 0


def _wrap_apply(farms, edit_in=None, edit_out=None):
    for farm in farms:
        original = farm.apply_changes

        def apply(per_doc, *args, _original=original, **kw):
            if edit_in is not None:
                per_doc = edit_in(per_doc)
            out = _original(per_doc, *args, **kw)
            if edit_out is not None:
                edit_out(out)
            return out

        farm.apply_changes = apply


def plant_stale(farms, syncs):
    """A step that returns its state unchanged: nothing commits."""
    _wrap_apply(farms, edit_in=lambda per_doc: [[] for _ in per_doc])


def plant_half(farms, syncs):
    """Half of the batch left out: every other document's changes."""
    _wrap_apply(farms, edit_in=lambda per_doc: [
        bufs if d % 2 == 0 else [] for d, bufs in enumerate(per_doc)])


def plant_altered(farms, syncs):
    """An answer altered where it is produced: the first value a patch
    lists, a string with one more character, a counter plus one."""

    def edit(result):
        for patch in result:
            for ops in patch["diffs"]["props"].values():
                for op, diff in ops.items():
                    more = "!" if isinstance(diff["value"], str) else 1
                    ops[op] = dict(diff, value=diff["value"] + more)
                    return

    _wrap_apply(farms, edit_out=edit)


def plant_dropped_key(farms, syncs):
    """A patch that leaves out a touched key: the first key of the first
    patch of every call that lists one."""

    def edit(result):
        for patch in result:
            if patch is not None and patch["diffs"]["props"]:
                props = patch["diffs"]["props"]
                del props[next(iter(props))]
                return

    _wrap_apply(farms, edit_out=edit)


def _op_order(op):
    ctr, _, actor = op.partition("@")
    return int(ctr), actor


def plant_dropped_conflict(farms, syncs):
    """A patch that leaves out one value of a conflict: in every patch,
    the lowest op of the first key that lists two or more."""

    def edit(result):
        for patch in result:
            if patch is None:
                continue
            for ops in patch["diffs"]["props"].values():
                if len(ops) > 1:
                    del ops[min(ops, key=_op_order)]
                    break

    _wrap_apply(farms, edit_out=edit)


def plant_no_exchange(farms, syncs):
    """The exchange left out: the server's messages to replica 1 are
    dropped."""
    server = syncs[0]
    original = server.generate_messages
    docs = farms[0].num_docs

    def generate(channels, *args, **kw):
        out = original(channels, *args, **kw)
        return [(state, None) if len(channels) == len(out) and
                i < docs and len(channels) > docs else (state, msg)
                for i, (state, msg) in enumerate(out)]

    server.generate_messages = generate


FAULTS = [(cell, f) for cell in CELLS
          for f in (plant_stale, plant_half, plant_altered,
                    plant_dropped_key)]
FAULTS += [("map-sync-128", plant_no_exchange),
           ("map-sync-128", plant_dropped_conflict),
           ("map-ingest-1k", plant_dropped_conflict)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_planted_fault_fails_the_check(tiny_root, cell, fault,
                                         monkeypatch):
    monkeypatch.setattr(plugins.load(tiny_root, "loops", "sync"),
                        "MAX_SWEEPS", 8)
    result, check, _ = _run(tiny_root, cell, plant=fault)
    assert not result["correct"], result["checks"]


def test_a_run_that_outlasts_its_stream_stops(tiny_root):
    from harness.cells import StreamExhausted

    with pytest.raises(StreamExhausted):
        run.run_cell("counter-64a", SEED, 0.0, False, device="cpu",
                     root=tiny_root, steps=10**6)


FORBIDDEN_PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
import run
run.run_cell("map-sync-128", 5, 0.0, False, device="cpu", root={tiny!r},
             steps=2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_nor_the_jax_package(tiny_root):
    out = subprocess.run(
        [sys.executable, "-c", FORBIDDEN_PROBE.format(
            root=ROOT, bench=BENCH, tiny=tiny_root)],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": ""}).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert not loaded & set(run.FORBIDDEN)
    assert "automerge_tpu_torch" in loaded


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH, "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            roots = set(_imported_roots(os.path.join(ref_dir, name)))
            assert not roots & {"automerge_tpu_torch", "automerge_tpu",
                                "jax", "harness", "torch"}, name
    probe = ("import sys; sys.path.insert(0, %r); import reference; "
             "print(sorted(m for m in sys.modules if m.startswith("
             "('automerge', 'jax', 'torch'))))" % BENCH)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_command_prints_no_result_without_a_card(tiny_root):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "counter-64a",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tiny_root,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "correct" not in proc.stdout

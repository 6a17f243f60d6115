"""The port's perf ledger (automerge_tpu_torch/obs/ledger.py) and its CLI
modes, twins of tests/test_ledger.py: every case runs through both
packages' ledger modules and must give the same records, hashes, diffs
and renderings; the CLI twin runs ``python -m automerge_tpu_torch.obs
--ledger [--diff]``, which renders without the device layer."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from automerge_tpu.obs import ledger as jax_ledger
from automerge_tpu_torch.obs import ledger as port_ledger

ROOT = Path(__file__).resolve().parent.parent
LEDGERS = (jax_ledger, port_ledger)


def test_normalize_strips_numpy_scalars_and_arrays():
    record = {
        "a": np.int64(7),
        "b": np.float32(0.5),
        "c": np.arange(3, dtype=np.int64),
        "d": {"nested": (np.int32(1), 2)},
        "e": [True, None, "s"],
    }
    want, out = (m.normalize(record) for m in LEDGERS)
    assert out == want == {"a": 7, "b": 0.5, "c": [0, 1, 2],
                           "d": {"nested": [1, 2]}, "e": [True, None, "s"]}
    assert '"7"' not in json.dumps(out)
    assert type(out["a"]) is int


def test_normalize_stringifies_unknown_leaves():
    class Opaque:
        def __repr__(self):
            return "<opaque>"

    for m in LEDGERS:
        assert m.normalize({"x": Opaque()}) == {"x": "<opaque>"}


def test_config_hash_is_order_independent_and_type_normalized():
    h = port_ledger.config_hash
    assert h({"a": 1, "b": 2}) == h({"b": 2, "a": 1})
    assert h({"a": np.int64(1)}) == h({"a": 1})
    assert h({"a": 1}) != h({"a": 2})
    for config in ({"a": 1, "b": 2}, {"docs": np.int64(128)}, {}):
        assert h(config) == jax_ledger.config_hash(config)


def test_append_and_load_round_trip(tmp_path):
    files = {}
    for m in LEDGERS:
        path = tmp_path / f"{m.__name__}.jsonl"
        rec = m.append_record(path, {
            "kind": "quick",
            "config": {"docs": np.int64(128)},
            "ops_per_sec": np.float64(1234.5),
        })
        assert rec["config_hash"] == m.config_hash({"docs": 128})
        m.append_record(path, {"kind": "quick", "config": {"docs": 128},
                               "ops_per_sec": 1300})
        records = m.load_ledger(path)
        assert len(records) == 2
        assert records[0]["ops_per_sec"] == 1234.5
        assert records[0]["config_hash"] == records[1]["config_hash"]
        files[m] = path.read_bytes()
    assert files[port_ledger] == files[jax_ledger]


def test_load_skips_malformed_lines(tmp_path):
    path = tmp_path / "ledger.jsonl"
    path.write_text('{"kind": "quick"}\nnot json\n\n{"kind": "mesh"}\n')
    for m in LEDGERS:
        assert [r["kind"] for r in m.load_ledger(path)] == ["quick", "mesh"]
        assert m.load_ledger(tmp_path / "missing.jsonl") == []


@pytest.fixture
def two_records():
    a = {
        "kind": "quick", "config_hash": "abc", "ops_per_sec": 1000,
        "programs": {
            "paging.apply_ops": {"compiles": 1, "dispatches": 6},
            "kernel.bloom_build": {"compiles": 0, "dispatches": 6},
        },
        "pipe": {"0": {"bytes_out": 100, "bytes_in": 3000,
                       "frames_out": 1, "frames_in": 2}},
    }
    b = {
        "kind": "quick", "config_hash": "abc", "ops_per_sec": 1100,
        "programs": {
            "paging.apply_ops": {"compiles": 4, "dispatches": 6},
            "kernel.bloom_build": {"compiles": 0, "dispatches": 6},
        },
        "pipe": {"0": {"bytes_out": 100, "bytes_in": 3600,
                       "frames_out": 1, "frames_in": 2}},
    }
    return a, b


def test_diff_records_reports_deltas_and_drops_noise(two_records):
    a, b = two_records
    diff = port_ledger.diff_records(a, b)
    assert diff["comparable"] is True
    assert diff["ops_per_sec"]["delta"] == 100
    assert diff["ops_per_sec"]["ratio"] == pytest.approx(1.1)
    assert list(diff["programs"]) == ["paging.apply_ops"]
    assert diff["programs"]["paging.apply_ops"]["compiles"] == 3
    assert diff["pipe"]["0"]["bytes_in"] == 600
    assert diff["pipe"]["0"]["bytes_out"] == 0
    assert diff == jax_ledger.diff_records(a, b)


def test_diff_flags_incomparable_configs(two_records):
    a, b = two_records
    b = dict(b, config_hash="zzz")
    assert port_ledger.diff_records(a, b)["comparable"] is False
    assert "[configs differ]" in port_ledger.render_diff(a, b)
    assert port_ledger.render_diff(a, b) == jax_ledger.render_diff(a, b)


def test_render_trajectory_totals(two_records):
    a, b = two_records
    text = port_ledger.render_trajectory([a, b])
    lines = text.splitlines()
    assert len(lines) == 4  # header, rule, two rows
    assert "1,000" in lines[2] and "1,100" in lines[3]
    assert "3100" in lines[2]  # pipe bytes total of record 0
    assert port_ledger.render_trajectory([]) == "ledger is empty"
    assert text == jax_ledger.render_trajectory([a, b])


def _run_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.obs", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )


def test_cli_trajectory_diff_and_bounds(tmp_path, two_records):
    path = tmp_path / "ledger.jsonl"
    a, b = two_records
    port_ledger.append_record(path, a)
    port_ledger.append_record(path, b)

    out = _run_cli("--ledger", str(path))
    assert out.returncode == 0, out.stderr
    assert "quick" in out.stdout and "1,100" in out.stdout

    out = _run_cli("--ledger", str(path), "--diff", "-2", "-1")
    assert out.returncode == 0
    assert "paging.apply_ops: compiles +3" in out.stdout
    assert out.stdout.strip() == jax_ledger.render_diff(a, b)

    out = _run_cli("--ledger", str(path), "--diff", "0", "9")
    assert out.returncode == 1
    assert "out of range" in out.stderr

    out = _run_cli("--ledger", str(path), "--json")
    assert out.returncode == 0
    assert len(json.loads(out.stdout)) == 2

"""The port's obs CLI (``python -m automerge_tpu_torch.obs``), twins of
tests/test_obs_cli.py: the report contract (span tree, metrics table and,
new in the port, the program table), ``--flight`` and ``--watch`` against a
real tiny load-harness run, the shard table, and the exit codes. The
workload runs in process with ``--device cpu``; one subprocess keeps the
command-line contract. ``--device`` defaults to the card, and the
renderers load neither the farm nor torch.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from automerge_tpu_torch.obs.__main__ import main

REPO = Path(__file__).resolve().parent.parent


def _run_cli(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.obs", *args],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
        timeout=timeout,
    )


def test_obs_report_subprocess_contract():
    """The command-line shape succeeds and prints the span tree with
    percentiles, the metrics table and the program table."""
    proc = _run_cli(["--docs", "2", "--rounds", "1", "--ops", "4",
                     "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "== spans ==" in proc.stdout
    assert "== metrics ==" in proc.stdout
    assert "p50" in proc.stdout and "p99" in proc.stdout
    assert "engine.device.dispatches" in proc.stdout
    assert "== programs ==" in proc.stdout
    assert "kernel.bloom_build" in proc.stdout


def test_json_report_carries_the_program_table(capsys):
    assert main(["--docs", "2", "--rounds", "2", "--ops", "4",
                 "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [s["name"] for s in out["spans"]] == ["merge", "sync"]
    programs = out["programs"]
    for name in ("kernel.bloom_build", "kernel.bloom_query",
                 "paging.apply_ops", "sync.build_filters"):
        assert programs[name]["dispatches"] > 0, name
    # one program under two names: each launch is counted once, in the
    # kernel's metrics family
    assert programs["kernel.bloom_build"] == programs["sync.build_filters"]
    assert out["metrics"]["prof.program.kernel.bloom_build.dispatches"][
        "value"] == programs["kernel.bloom_build"]["dispatches"]
    assert "prof.program.sync.build_filters.dispatches" not in out["metrics"]
    assert out["metrics"]["prof.program.paging.apply_ops.dispatches"][
        "value"] == programs["paging.apply_ops"]["dispatches"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_device_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--docs", "1", "--rounds", "1"])


def test_renderers_load_neither_the_farm_nor_torch(tmp_path):
    """--ledger, --flight and --watch render in a process that never
    imports the device layer (and so never initialises CUDA)."""
    ledger = tmp_path / "ledger.jsonl"
    ledger.write_text('{"kind": "quick", "ops_per_sec": 1}\n')
    flight = tmp_path / "dump.jsonl"
    flight.write_text("")
    snaps = tmp_path / "snaps.jsonl"
    snaps.write_text(json.dumps({"t": 1.0, "metrics": {}, "tenants": {},
                                 "flight_tail": []}) + "\n")
    probe = (
        "import sys\n"
        "from automerge_tpu_torch.obs.__main__ import main\n"
        f"assert main(['--ledger', {str(ledger)!r}]) == 0\n"
        f"assert main(['--flight', {str(flight)!r}]) == 0\n"
        f"assert main(['--watch', {str(snaps)!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'torch'\n"
        "             or m.startswith('automerge_tpu_torch.tpu'))\n"
        "print('LOADED=' + ','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED=\n" in out.stdout, out.stdout


def test_flight_render_needs_no_workload(tmp_path):
    from automerge_tpu_torch.obs.flight import FlightRecorder

    rec = FlightRecorder(clock=lambda: 0.5)
    rec.enabled = True
    rec.record("watchdog.reset", epoch=7)
    rec.record("flight.trigger", reason="watchdog.reset")
    dump = tmp_path / "dump.jsonl"
    dump.write_text(rec.to_jsonl(), encoding="utf-8")
    assert main(["--flight", str(dump)]) == 0


@pytest.fixture(scope="module")
def snapshot_file(tmp_path_factory):
    """A telemetry snapshot file produced by a real tiny load-harness run
    of the port (simulated time; the --watch data source)."""
    from automerge_tpu_torch import TorchDocFarm
    from automerge_tpu_torch.serve.loadgen import LoadConfig, LoadGen

    path = tmp_path_factory.mktemp("watch") / "snaps.jsonl"
    farm = TorchDocFarm(4, capacity=64, device="cpu")
    gen = LoadGen(farm, LoadConfig(
        clients=12, docs=4, edits_per_client=1, ops_per_edit=2,
        spread=0.3, observability="full", snapshot_path=str(path),
        snapshot_interval=0.2,
    ))
    report = gen.run()
    assert report["converged"]
    return {"path": path, "report": report}


def test_watch_renders_latest_snapshot_headlessly(snapshot_file, capsys):
    assert main(["--watch", str(snapshot_file["path"])]) == 0
    out = capsys.readouterr().out
    assert "phase shares" in out
    assert "queue_wait" in out and "readback" in out and "ack" in out
    assert "tenants" in out
    assert "t0" in out  # a tenant row
    assert "flight tail" in out


def test_loadgen_report_and_snapshots_carry_slo_verdicts(snapshot_file,
                                                         capsys):
    report = snapshot_file["report"]
    assert report["slo"]["ok"] is True
    names = {v["objective"] for v in report["slo"]["verdicts"]}
    assert names == {
        "serve_latency", "serve_availability", "serve_convergence",
    }
    lines = [json.loads(ln)
             for ln in snapshot_file["path"].read_text().splitlines()]
    assert lines and all("slo" in rec for rec in lines)
    assert main(["--watch", str(snapshot_file["path"])]) == 0
    out = capsys.readouterr().out
    assert "-- SLOs --" in out
    assert "serve_latency" in out and "serve_convergence" in out


def test_watch_renders_mesh_shard_table(tmp_path, capsys):
    record = {
        "t": 1.0,
        "metrics": {
            "mesh.shard.0.docs": {"type": "counter", "value": 96},
            "mesh.shard.1.docs": {"type": "counter", "value": 160},
            "mesh.shard.0.dispatch_ms": {
                "type": "histogram", "count": 2, "sum": 12.5, "p99": 8.0,
            },
            "serve.flush.shard.1.docs": {"type": "counter", "value": 7},
            "mesh.shards": {"type": "gauge", "value": 2},
            "prof.program.kernel.bloom_query.dispatches":
                {"type": "counter", "value": 5},
        },
        "tenants": {},
        "flight_tail": [],
    }
    path = tmp_path / "snaps.jsonl"
    path.write_text(json.dumps(record) + "\n", encoding="utf-8")
    assert main(["--watch", str(path)]) == 0
    out = capsys.readouterr().out
    assert "-- shards --" in out
    assert "dispatch_ms" in out and "docs" in out
    assert "flush.docs" in out
    assert "96" in out and "160" in out
    assert "2 @ 12.5ms" in out
    rows = [ln for ln in out.splitlines() if ln.strip().startswith(("0 ", "1 "))]
    assert len(rows) == 2
    assert "-- programs (amprof) --" in out and "kernel.bloom_query" in out


def test_watch_snapshot_lines_are_self_contained(snapshot_file):
    lines = [
        json.loads(line)
        for line in snapshot_file["path"].read_text(
            encoding="utf-8").splitlines()
        if line.strip()
    ]
    assert len(lines) >= 2  # periodic + final
    last = lines[-1]
    assert "metrics" in last and "tenants" in last and "flight_tail" in last
    assert last["breakdown"]["requests"] > 0


def test_watch_missing_file_exits_nonzero():
    assert main(["--watch", "/nonexistent/snaps.jsonl"]) == 1

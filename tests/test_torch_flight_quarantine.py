"""The flight recorder under the farm's quarantine, the port against the
JAX package: twins of tests/test_flight.py's
``test_farm_quarantine_entry_records_and_dumps`` and its three
``poison_run`` cases (a chaos + poison ``LoadGen`` run that auto-dumps a
timeline holding the quarantine events, and the ``--flight`` CLI over
that dump). Each scenario makes the JAX test's assertions on one package
and records what it observed; ``twin_pkgs`` holds the port's record equal
to the JAX package's. Timelines are compared event by event (name,
fields, simulated time) without the compile-history events
(``engine.recompile``, ``prof.recompile.storm``): whether one is recorded
depends on which shapes earlier tests of the process compiled, so a dump of the bounded ring is compared on the events both
packages' rings still hold.
"""
import importlib
import json
import os

import pytest

from test_torch_api_doc import twin
from test_torch_faults_domain import Pkg, twin_pkgs


#: events whose presence depends on what earlier tests of the process
#: compiled, not on the run
COMPILE_EVENTS = ("engine.recompile", "prof.recompile.storm")


def _events(events):
    """A timeline as comparable data, minus the compile-history events."""
    return [(e["event"], e["fields"], e["t"]) for e in events
            if e["event"] not in COMPILE_EVENTS]


def _same_tail(a, b):
    """Two dumps of the bounded ring end at the same trigger, but compile
    events took more of one ring than of the other: the events both still
    hold (the common suffix) must be equal, and hold the quarantine."""
    a, b = _events(a), _events(b)
    n = min(len(a), len(b))
    assert a[-n:] == b[-n:]
    assert any(e[0] == "farm.quarantine.enter" for e in a[-n:])
    return a[-n:]


def test_farm_quarantine_entry_records_and_dumps(tmp_path, monkeypatch):
    def scenario(P, rec):
        fl = P.flight
        stream = importlib.import_module(f"{P.am.__name__}.obs.__main__")
        dump_dir = tmp_path / P.am.__name__
        dump_dir.mkdir()
        with fl.enabled_flight(dump_dir=str(dump_dir)) as recorder:
            recorder.clear()
            farm = P.farm(2, capacity=32, quarantine_threshold=1)
            good = stream._change_stream("aaaaaaaa", 1, 4)[0]
            bad = bytes(P.faults.bit_flipped(good))
            farm.apply_changes([[good], [bad]])
            events = recorder.snapshot()
        kinds = [e["event"] for e in events]
        assert "farm.quarantine.enter" in kinds
        enter = next(e for e in events if e["event"] == "farm.quarantine.enter")
        assert enter["fields"]["doc"] == 1
        assert enter["fields"]["kind"]
        assert recorder.dump_paths, "quarantine entry did not dump"
        with open(recorder.dump_paths[0], encoding="utf-8") as f:
            dumped = fl.load_jsonl(f.read())
        assert any(e["event"] == "farm.quarantine.enter" for e in dumped)
        with fl.enabled_flight():
            farm.release_quarantine()
            last = fl.get_flight().snapshot()[-1]
            assert last["event"] == "farm.quarantine.release"
        rec.value([(e["event"], e["fields"]) for e in events
                   if e["event"] not in COMPILE_EVENTS])
        rec.value([(e["event"], e["fields"]) for e in dumped
                   if e["event"] not in COMPILE_EVENTS])
        rec.value((last["event"], last["fields"]))

    twin_pkgs(scenario, monkeypatch)


@pytest.fixture(scope="module")
def poison_runs(tmp_path_factory):
    """The JAX test's chaos + poison LoadGen run through each package
    (twinned: both runs' reports, minus the dump paths and host-clock
    fields, equal; each pair of dumps equal on its common tail). Returns
    {package name: {"report", "farm", "P"}}."""
    runs = {}

    def scenario(P, rec):
        loadgen = importlib.import_module(f"{P.am.__name__}.serve.loadgen")
        tmp = tmp_path_factory.mktemp(P.am.__name__)
        farm = P.farm(8, capacity=128)
        report = loadgen.LoadGen(farm, loadgen.LoadConfig(
            clients=24, docs=8, edits_per_client=2, ops_per_edit=3,
            spread=0.5, chaos=0.15, poison=0.25, seed=5,
            observability="full", flight_dir=str(tmp),
        )).run()
        runs[P.am.__name__] = {"report": report, "farm": farm, "P": P}
        rec.value({k: v for k, v in report.items() if k not in (
            "flight_dumps", "breakdown", "dispatch_spans", "flight_events")})
        rec.value(sorted(farm.quarantine))
        rec.value(len(report["flight_dumps"]))

    with pytest.MonkeyPatch.context() as mp:
        twin(lambda am, rec: scenario(Pkg(am), rec), mp)
    dumps = []
    for name in PACKAGES:
        run = runs[name]
        for path in run["report"]["flight_dumps"]:
            with open(path, encoding="utf-8") as f:
                dumps.append((name, run["P"].flight.load_jsonl(f.read())))
    half = len(dumps) // 2
    for (_, a), (_, b) in zip(dumps[:half], dumps[half:]):
        _same_tail(a, b)
    return runs


PACKAGES = ("automerge_tpu", "automerge_tpu_torch")


@pytest.mark.parametrize("package", PACKAGES)
def test_poison_run_quarantines_and_dumps(poison_runs, package):
    report = poison_runs[package]["report"]
    assert report["quarantined_docs"] > 0
    assert report["flight_dumps"], "no flight dump despite quarantines"
    for path in report["flight_dumps"]:
        assert os.path.exists(path)
    want = poison_runs["automerge_tpu"]["report"]
    assert len(report["flight_dumps"]) == len(want["flight_dumps"])
    assert report["quarantined_docs"] == want["quarantined_docs"]


def test_poison_run_timeline_contains_the_quarantine_events(poison_runs):
    seen = []
    for package in PACKAGES:
        run = poison_runs[package]
        fl = run["P"].flight
        path = run["report"]["flight_dumps"][-1]
        with open(path, encoding="utf-8") as f:
            events = fl.load_jsonl(f.read())
        kinds = {e["event"] for e in events}
        assert "farm.quarantine.enter" in kinds
        assert "batcher.flush" in kinds
        assert "flight.trigger" in kinds
        seqs = [e["seq"] for e in events]
        assert seqs == sorted(seqs)
        quarantined_docs = {e["fields"]["doc"] for e in events
                            if e["event"] == "farm.quarantine.enter"}
        assert quarantined_docs & set(run["farm"].quarantine)
        table = fl.render_timeline(events)
        assert "farm.quarantine.enter" in table
        seen.append(events)
    _same_tail(*seen)


def test_flight_cli_renders_dump(poison_runs, capsys):
    out = []
    for package in PACKAGES:
        main = importlib.import_module(f"{package}.obs.__main__").main
        path = poison_runs[package]["report"]["flight_dumps"][-1]
        assert main(["--flight", path]) == 0
        text = capsys.readouterr().out
        assert "farm.quarantine.enter" in text
        assert "seq" in text.splitlines()[0]
        assert main(["--flight", path, "--json"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert any(e["event"] == "flight.trigger" for e in payload["events"])
        out.append(payload["events"])
    _same_tail(*out)

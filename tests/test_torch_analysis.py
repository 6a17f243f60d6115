"""The port's amlint (``automerge_tpu_torch.analysis``) over the port.

1. **Ratchet**: the full rule suite runs over ``automerge_tpu_torch`` and
   reports zero unsuppressed findings; the suppressed set is a stated set
   of rule IDs, each suppression under a justification.
2. **Torch meaning**: each rule that reads PyTorch where the JAX package
   reads JAX fires on its violating fixture under
   ``tests/torch_analysis_fixtures/``, is quiet on the clean one and
   silenced on the suppressed one; the AM701 fixtures also run, and the
   raw-length one trips the observatory's runtime storm detector.
3. **Contract**: the catalog keeps every JAX rule ID (AM204 and AM303 JAX
   only, never firing), the CLI's exit codes in process and in a
   subprocess, and importing the analyzer loads neither torch nor jax.

The unchanged-meaning rules are held against the JAX analyzer on the JAX
package's fixtures in tests/test_torch_analysis_parity.py."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from automerge_tpu.analysis import RULES as JAX_RULES
from automerge_tpu.analysis import run_analysis as jax_run
from automerge_tpu_torch.analysis import (JAX_ONLY, RULES, default_target,
                                          run_analysis)
from automerge_tpu_torch.analysis.__main__ import main as amlint_main
from automerge_tpu_torch.analysis.graph import module_name

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = default_target()
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
JAX_FIXTURES = Path(__file__).parent / "analysis_fixtures"

#: rules whose meaning here reads PyTorch (fixtures of their own)
TORCH_RULES = ("AM201", "AM202", "AM203", "AM301", "AM302", "AM306",
               "AM403", "AM701")

#: the rules the port suppresses in-tree, each site with a justification
SUPPRESSED = {"AM103", "AM105", "AM106", "AM107", "AM305", "AM306",
              "AM401", "AM402", "AM502", "AM504", "AM601"}


def test_port_is_clean():
    """The ratchet: the port stays free of unsuppressed findings."""
    assert PACKAGE == ROOT / "automerge_tpu_torch"
    findings = run_analysis([PACKAGE])
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)


def _directive_text(lines, line):
    """The amlint comment that governs `line` (1-based): trailing on the
    line itself, or the standalone comment block right above it."""
    if "amlint:" in lines[line - 1]:
        start = line - 1
    else:
        start = line - 2
        while start >= 0 and lines[start].strip().startswith("#") and \
                "amlint:" not in lines[start]:
            start -= 1
    assert start >= 0 and "amlint:" in lines[start], line
    block = [lines[start]]
    nxt = start + 1
    while nxt < len(lines) and lines[nxt].strip().startswith("#"):
        block.append(lines[nxt])
        nxt += 1
    return " ".join(block)


def test_port_suppressions_are_justified():
    """The suppressed findings are exactly the stated rule set, and every
    one sits under a directive that gives its reason after a dash."""
    everything = run_analysis([PACKAGE], include_suppressed=True)
    suppressed = [f for f in everything if f.suppressed]
    assert {f.rule_id for f in suppressed} == SUPPRESSED
    for f in suppressed:
        lines = Path(f.path).read_text(encoding="utf-8").splitlines()
        text = _directive_text(lines, f.line)
        reason = re.split(r"[—–]|\s-\s", text.split("amlint:", 1)[1], 1)
        assert len(reason) == 2 and len(reason[1].split()) >= 2, (
            f"{f.format()}: suppression without a justification: {text}")


def test_catalog_keeps_every_jax_rule_id():
    assert set(RULES) == set(JAX_RULES)
    assert {r: RULES[r][0] for r in RULES} == \
        {r: JAX_RULES[r][0] for r in JAX_RULES}
    assert set(JAX_ONLY) == {"AM204", "AM303"}
    for rule_id in JAX_ONLY:
        assert RULES[rule_id][1].startswith("JAX only")


def test_list_rules_marks_the_jax_only_rules(capsys):
    assert amlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in RULES:
        assert re.search(rf"^{rule_id}\s", out, re.M), rule_id
    for rule_id, reason in JAX_ONLY.items():
        block = out.split(rule_id, 1)[1].split("\nAM", 1)[0]
        assert "JAX only" in block and reason in block


@pytest.mark.parametrize("rule_id", TORCH_RULES)
def test_torch_fixture_triple(rule_id):
    stem = FIXTURES / rule_id.lower()
    violation = run_analysis([Path(f"{stem}_violation.py")])
    assert violation and {f.rule_id for f in violation} == {rule_id}, (
        [f.format() for f in violation])
    clean = run_analysis([Path(f"{stem}_clean.py")])
    assert clean == [], [f.format() for f in clean]
    path = Path(f"{stem}_suppressed.py")
    assert run_analysis([path]) == []
    hits = [f for f in run_analysis([path], include_suppressed=True)
            if f.rule_id == rule_id]
    assert hits and all(f.suppressed for f in hits)


def test_jax_only_rules_never_fire_on_their_jax_fixtures():
    """The JAX analyzer flags AM204 and AM303 on its violating fixtures;
    the port's reports neither, there or anywhere in the port."""
    for rule_id in JAX_ONLY:
        path = JAX_FIXTURES / f"{rule_id.lower()}_violation.py"
        assert any(f.rule_id == rule_id for f in jax_run([path]))
        assert not any(f.rule_id == rule_id for f in
                       run_analysis([path], include_suppressed=True))
    assert not any(f.rule_id in JAX_ONLY for f in
                   run_analysis([PACKAGE], include_suppressed=True))


STORM_PROBE = """
import importlib.util, json, sys
from automerge_tpu_torch.obs.flight import enabled_flight
from automerge_tpu_torch.obs.prof import enabled_observatory
out = {}
for stem in ("am701_violation", "am701_clean"):
    spec = importlib.util.spec_from_file_location(
        stem, f"tests/torch_analysis_fixtures/{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with enabled_observatory(), enabled_flight() as flight:
        mod.drive([[0] * n for n in (33, 57, 91, 123)])
        out[stem] = [e["fields"].get("program") for e in flight.snapshot()
                     if e["event"] == "prof.recompile.storm"]
print("STORMS=" + json.dumps(out))
"""


def test_am701_static_and_runtime_storm_parity():
    """The raw-length fixture trips ``prof.recompile.storm`` at run time
    (four lengths, four new shape buckets) and is flagged statically with
    its dataflow chain; the pow2-bucketed twin is quiet on both sides.
    The fixtures run in a subprocess: their programs must not join this
    process's observatory roster."""
    out = subprocess.run([sys.executable, "-c", STORM_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    storms = json.loads(out.stdout.split("STORMS=")[1])
    assert "fixture.shape.raw" in storms["am701_violation"]
    assert "fixture.shape.bucketed" not in storms["am701_clean"]
    raw = run_analysis([FIXTURES / "am701_violation.py"])
    assert any(f.rule_id == "AM701" and "[dataflow:" in f.message
               for f in raw)


def test_cli_exit_codes_in_process(tmp_path, capsys):
    assert amlint_main(["-q"]) == 0
    assert amlint_main(["-q", str(PACKAGE)]) == 0
    for rule_id in TORCH_RULES:
        path = FIXTURES / f"{rule_id.lower()}_violation.py"
        assert amlint_main(["-q", str(path)]) == 1, rule_id
    assert amlint_main(["--select", "AM999", str(PACKAGE)]) == 2
    assert amlint_main([str(tmp_path / "missing.py")]) == 2
    bad = tmp_path / "typo.py"
    bad.write_text("x = 1  # amlint: disable=AM998\n", encoding="utf-8")
    assert amlint_main([str(bad)]) == 2
    err = capsys.readouterr().err
    assert "Traceback" not in err and err.count("amlint: error:") == 3


def test_cli_subprocess_contract():
    """``python -m automerge_tpu_torch.analysis`` exits 0 on the port (its
    default target) and 1 on a violating fixture, with the JSON report
    naming the rule."""
    ok = subprocess.run([sys.executable, "-m", "automerge_tpu_torch.analysis"],
                        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert ok.stdout.strip().endswith("0 finding(s)")
    bad = subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.analysis", "--json",
         str(FIXTURES / "am202_violation.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert '"rule": "AM202"' in bad.stdout


IMPORT_PROBE = """
import sys
import automerge_tpu_torch.analysis
import automerge_tpu_torch.analysis.__main__ as cli
rc = cli.main(["-q", "automerge_tpu_torch/analysis"])
heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax")
               or m == "automerge_tpu" or m.startswith("automerge_tpu."))
print("RC=%d LOADED=%s" % (rc, ",".join(heavy)))
"""


def test_importing_the_analyzer_loads_neither_torch_nor_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RC=0 LOADED=\n" in out.stdout, out.stdout


def test_graph_names_modules_under_the_port_package():
    assert module_name(PACKAGE / "tpu" / "engine.py") == \
        "automerge_tpu_torch.tpu.engine"
    assert module_name(PACKAGE / "analysis" / "__init__.py") == \
        "automerge_tpu_torch.analysis"
    assert module_name(FIXTURES / "am201_violation.py") == "am201_violation"

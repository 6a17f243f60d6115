"""The port's amlint against the JAX package's on the JAX fixtures.

For every rule whose meaning is unchanged in the port (the packing and
hot-path rules, the metric catalog, worker telemetry, the taxonomy rules
AM401/AM402/AM404, the mesh and protocol rules and the durability rule),
both analyzers scan each of the rule's violating, clean and suppressed
fixtures under tests/analysis_fixtures/ (read only) and must report the
same findings of those rules: rule ID, line, column and suppressed flag."""
from pathlib import Path

import pytest

from automerge_tpu.analysis import run_analysis as jax_run
from automerge_tpu_torch.analysis import run_analysis as port_run

FIXTURES = Path(__file__).parent / "analysis_fixtures"

UNCHANGED = ("AM101", "AM102", "AM103", "AM104", "AM105", "AM106", "AM107",
             "AM304", "AM305", "AM401", "AM402", "AM404", "AM501", "AM502",
             "AM503", "AM504", "AM601")


def _key(findings):
    return sorted((f.rule_id, f.line, f.col, f.suppressed)
                  for f in findings if f.rule_id in UNCHANGED)


@pytest.mark.parametrize("rule_id", UNCHANGED)
def test_port_agrees_with_jax_on_the_jax_fixtures(rule_id):
    for kind in ("violation", "clean", "suppressed"):
        path = FIXTURES / f"{rule_id.lower()}_{kind}.py"
        want = _key(jax_run([path], include_suppressed=True))
        got = _key(port_run([path], include_suppressed=True))
        assert got == want, (path.name, got, want)
        if kind == "violation":
            assert any(r == rule_id and not s for r, _, _, s in got)
        if kind == "suppressed":
            assert any(r == rule_id and s for r, _, _, s in got)

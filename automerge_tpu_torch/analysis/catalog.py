"""AM304 — observability catalog consistency: code and README agree.

The README's "Metric catalog" / "Flight-recorder event catalog" tables,
and its table of the metrics only the port records, are the operator
contract: dashboards, alerts and the `--watch` CLI are built
against those names. The contract rots in both directions — a new
instrument lands in code without a catalog row (invisible to operators),
or a catalog row survives the removal of its instrument (alerting on a
metric that can never move). AM304 closes the loop:

- **forward**: every metric registered with a literal dotted name
  (``.counter("x.y")`` / ``.gauge`` / ``.histogram``) and every flight
  event recorded with a literal kind (``.record("x.y", ...)``) must
  appear in the README catalog. Dynamic names (f-strings like
  ``f"farm.quarantine.causes.{kind}"``) are exempt from the forward
  check; their static fragments participate in the reverse match.
- **reverse**: when the scan covers the whole package (detected by
  ``obs/metrics.py`` being among the scanned files), every catalog row
  must name something the code records — exactly (literal names) or by
  fragment (a ``<placeholder>`` row matches an f-string prefix, a
  ``{name}.hits``-style dynamic registration matches by suffix). Reverse
  findings anchor on the README row's line.

Scope: files under the ``automerge_tpu_torch`` package, plus any file carrying
the ``# amlint: metric-catalog`` marker (how the fixture triple opts in
— fixtures for other rules register toy metric names that must not
fire). The README is found by walking up from the scanned file; no
README within the tree means no findings (the rule degrades to a no-op
on extracted single files).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import PACKAGE, FileContext, Finding, static_str_parts

_REGISTER_ATTRS = {"counter", "gauge", "histogram"}
#: a catalog-relevant name: lowercase dotted, optional <placeholder> parts
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_<>]+)+$")
_TOKEN_RE = re.compile(r"`([^`]+)`")
_MARKER_RE = re.compile(r"#\s*amlint:\s*metric-catalog")
#: README section headings whose tables form the catalog; the last one
#: holds the instruments the JAX package does not record, so that its own
#: analyzer, which reads the same README, finds no stale row there
_CATALOG_HEADINGS = ("metric catalog", "event catalog",
                     "metrics only the port records")


# ---------------------------------------------------------------------- #
# README side

def find_readme(path: Path) -> Path | None:
    """Nearest README.md walking up from `path` (the repo-root README for
    package files and for the fixture tree)."""
    for parent in path.resolve().parents:
        candidate = parent / "README.md"
        if candidate.is_file():
            return candidate
    return None


def catalog_names(text: str) -> dict[str, int]:
    """{name: line} for every backticked metric/event name in the README's
    catalog tables. Rows use the ``\\`full.name\\` / \\`.suffix\\```
    shorthand — a leading-dot token replaces the previous full name's last
    component."""
    out: dict[str, int] = {}
    in_catalog = False
    last_full: str | None = None
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if stripped.startswith("#"):
            heading = stripped.lstrip("#").strip().lower()
            in_catalog = any(h in heading for h in _CATALOG_HEADINGS)
            last_full = None
            continue
        if not in_catalog or not stripped.startswith("|"):
            continue
        for token in _TOKEN_RE.findall(stripped):
            if "/" in token or " " in token or token.endswith(".py"):
                continue
            if token.startswith(".") and last_full is not None:
                name = last_full.rsplit(".", 1)[0] + token
            else:
                name = token
            if _NAME_RE.match(name):
                out.setdefault(name, lineno)
                last_full = name
    return out


def _matches(readme_name: str, literals: set[str],
             fragments: set[str]) -> bool:
    if readme_name in literals:
        return True
    # `<placeholder>` rows match up to the placeholder
    prefix = readme_name.split("<", 1)[0]
    if prefix != readme_name:
        return any(
            lit.startswith(prefix) for lit in literals
        ) or any(
            frag.startswith(prefix) or prefix.startswith(frag)
            for frag in fragments
        )
    # dynamic registrations (f-strings) match by their static fragments:
    # a prefix fragment ("farm.quarantine.causes.") or a suffix fragment
    # (".hits" from f"{name}.hits")
    return any(
        (readme_name.startswith(frag) or readme_name.endswith(frag))
        for frag in fragments
    )


# ---------------------------------------------------------------------- #
# code side

def _in_scope(ctx: FileContext) -> bool:
    if _MARKER_RE.search(ctx.source):
        return True
    return PACKAGE in ctx.path.parts


def _collect(ctx: FileContext) -> tuple[list[tuple[str, ast.AST]], set[str]]:
    """(literal (name, node) registrations, dynamic-name static fragments)
    for one file: ``.counter/.gauge/.histogram("a.b", ...)`` metric
    registrations and ``.record("a.b", ...)`` flight events."""
    literals: list[tuple[str, ast.AST]] = []
    fragments: set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in _REGISTER_ATTRS and node.func.attr != "record":
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            if _NAME_RE.match(first.value):
                literals.append((first.value, node))
        elif isinstance(first, ast.JoinedStr):
            frag = static_str_parts(first)
            if len(frag) >= 3:
                fragments.add(frag)
    return literals, fragments


# ---------------------------------------------------------------------- #

def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    all_literals: set[str] = set()
    all_fragments: set[str] = set()
    readme: Path | None = None
    full_package_scan = False

    for ctx in ctxs:
        if ctx.path.name == "metrics.py" and ctx.path.parent.name == "obs":
            full_package_scan = True
        if not _in_scope(ctx):
            continue
        literals, fragments = _collect(ctx)
        all_fragments |= fragments
        if not literals:
            continue
        ctx_readme = find_readme(ctx.path)
        if ctx_readme is None:
            continue
        readme = readme or ctx_readme
        catalog = catalog_names(ctx_readme.read_text(encoding="utf-8"))
        for name, node in literals:
            all_literals.add(name)
            if name not in catalog:
                findings.append(ctx.finding(
                    "AM304", node,
                    f"metric/event name `{name}` is recorded here but "
                    "missing from the README catalog — add a catalog row "
                    "(or rename to a cataloged name)",
                ))

    if full_package_scan and readme is not None:
        text = readme.read_text(encoding="utf-8")
        for name, lineno in sorted(catalog_names(text).items()):
            if not _matches(name, all_literals, all_fragments):
                findings.append(Finding(
                    "AM304", str(readme), lineno, 0,
                    f"catalog row `{name}` names no metric/event recorded "
                    "anywhere in the package — remove the stale row (or "
                    "restore the instrument)",
                ))
    return findings

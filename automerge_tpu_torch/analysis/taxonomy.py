"""AM401/AM402/AM403/AM404 — data-plane hygiene: classifiable errors,
injectable time, non-blocking serve loops, taxonomy-only wire codecs.

The fault-isolation layer (tpu/farm.py) routes per-document failures by
taxonomy class (automerge_tpu_torch/errors.py): ``DecodeError`` means re-request
the bytes, ``CausalityError`` means distrust the peer, ``PackingLimitError``
means shed/split — and the obs quarantine counters are dimensioned by
``error_kind``. A bare ``ValueError``/``TypeError`` raised anywhere on the
data plane collapses into the ``other`` bucket and strips the isolation
layer of that signal, so the data-plane modules (codecs, columnar, opset,
sync, farm, rga, transcode, engines, sync drivers) must raise taxonomy
errors.

Scope: modules whose filename stem is in ``DATA_PLANE_STEMS``, plus any
file carrying an ``# amlint: error-taxonomy`` marker (how the test fixtures
opt in). The frontend and other API-surface modules are deliberately out of
scope — their errors face the local programmer, not untrusted traffic.

Deliberate bare raises (argument-type validation, API-usage errors,
internal invariants that indicate a bug rather than bad input) stay bare
with a justified ``# amlint: disable=AM401`` suppression.

AM402 guards the *time* axis of the same determinism story: the sync
supervision layer (sync_session.py) has retransmission timeouts, backoff
jitter and a watchdog — the first time-based control flow in the stack.
A direct ``time.time()``/``time.sleep()``/``random.random()`` call in a
sync data-plane module makes that control flow unreplayable (the chaos
soak suite cannot reproduce a failure schedule) and couples tests to wall
clocks. Those modules (``SYNC_DATA_PLANE_STEMS``, plus files marked
``# amlint: sync-data-plane``) must take an injected clock callable and a
``random.Random`` instance; constructing an RNG (``random.Random(seed)``,
``random.SystemRandom()``) is allowed — that *is* the injection point —
and the one real-time default carries a justified suppression.

AM403 guards the serving front door (automerge_tpu_torch/serve): its core runs
inside an event loop (asyncio or a simulated-time harness), where ONE
blocking call stalls every client channel at once. ``time.sleep`` (yield
with ``await asyncio.sleep`` or let the harness advance the clock), bare
``socket`` construction (asyncio owns the transports), and synchronous
device readbacks (``torch.cuda.synchronize``, a tensor's ``.cpu()``/
``.numpy()``/``.item()``, and the JAX spellings ``jax.device_get``/
``block_until_ready`` — the batcher's single flush dispatch is the only place device latency may be paid, with a
justified suppression) are all banned in serve modules (any file under a
``serve/`` directory, plus files marked ``# amlint: serve-event-loop``).

AM404 tightens AM401 for the sync v2 wire codec (``sync_v2.py``,
``tpu/fingerprint.py``, plus files carrying the ``v2-wire-codec`` marker):
the session layer's negotiated-fallback dispatch catches exactly
``SyncProtocolError`` — a v2 codec path that raises ANY class outside
``automerge_tpu_torch.errors`` (``RuntimeError``, ``KeyError``, a homegrown
exception) would sail past the fallback handler and kill the channel
instead of downgrading it to v1. So in v2 wire-codec scope every ``raise``
of an exception *class* must name something imported from
``automerge_tpu_torch.errors`` — not just "no bare ValueError" (AM401) but
"nothing outside the taxonomy at all". Re-raising a caught variable is
fine; deliberate internal-invariant raises carry a justified
``# amlint: disable=AM404`` suppression.

AM403 is *transitively* enforced: beyond the direct per-file walk, the
call graph (graph.py) BFS-reaches every function a serve-scope function
can call — across files, through from-imports and inferable method
receivers, with bounded depth — and flags blocking calls found in those
helpers too, printing the discovery chain (``[reachable via
batcher.flush -> engine.drain -> ...]``). A helper that blocks is exactly
as fatal to the event loop as blocking inline; the suppression (or the
fix) belongs at the blocking call site, which is where the finding lands.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import FileContext, Finding, dotted_name
from .graph import format_chain

#: data-plane module stems the rule applies to (serve/ modules face the
#: same untrusted traffic the farm does: admission decisions and shed
#: accounting key off error_kind too)
DATA_PLANE_STEMS = frozenset({
    "codecs", "columnar", "opset", "sync", "sync_v2", "farm", "rga",
    "sync_farm", "sync_batch", "sync_session", "fingerprint", "transcode",
    "engine", "text_engine", "server", "batcher", "loadgen", "meshfarm",
})

_MARKER_RE = re.compile(r"#\s*amlint:\s*error-taxonomy")

#: the stdlib classes whose bare raise loses the error_kind dimension
_BARE = {"ValueError", "TypeError"}

#: sync data-plane module stems AM402 applies to (the modules whose
#: control flow the chaos suite must be able to replay deterministically;
#: the serve layer runs whole fleets in simulated time, so it is held to
#: the same injectable-clock discipline)
SYNC_DATA_PLANE_STEMS = frozenset({
    "sync", "sync_v2", "sync_session", "sync_farm", "sync_batch",
    "fingerprint", "server", "batcher", "loadgen",
})

#: v2 wire-codec module stems AM404 applies to (the modules whose raises
#: the session fallback dispatch must be able to classify)
V2_WIRE_CODEC_STEMS = frozenset({"sync_v2", "fingerprint"})

_V2_MARKER_RE = re.compile(r"#\s*amlint:\s*v2-wire-codec")

_SYNC_MARKER_RE = re.compile(r"#\s*amlint:\s*sync-data-plane")

_SERVE_MARKER_RE = re.compile(r"#\s*amlint:\s*serve-event-loop")

#: calls that block the serving event loop (AM403): sleeps, bare socket
#: construction/dialing, and synchronous device readbacks. Matched on the
#: dotted prefix (``socket.``) or the exact name; ``synchronize`` and the
#: tensor readbacks ``.cpu()``/``.numpy()``/``.item()`` are also caught as
#: method/attr tails because the tensor they block on can be any local
#: name (``block_until_ready``/``device_get`` stay: the JAX spellings).
_BLOCKING_CALLS = frozenset({"time.sleep", "jax.device_get",
                             "torch.cuda.synchronize"})
_BLOCKING_PREFIXES = ("socket.",)
_BLOCKING_ATTRS = frozenset({"block_until_ready", "device_get",
                             "synchronize", "cpu", "numpy", "item"})

#: wall-clock reads and sleeps that make supervised control flow
#: unreplayable (call sites must take an injected clock instead)
_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.sleep", "time.monotonic",
    "time.monotonic_ns", "time.perf_counter", "time.perf_counter_ns",
})

#: random.* attributes that are NOT the module-global RNG: constructing an
#: instance is the injection pattern the rule demands
_RNG_CONSTRUCTORS = frozenset({"Random", "SystemRandom"})


def _in_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in DATA_PLANE_STEMS
        or _MARKER_RE.search(ctx.source) is not None
    )


def _in_sync_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in SYNC_DATA_PLANE_STEMS
        or _SYNC_MARKER_RE.search(ctx.source) is not None
    )


def _in_serve_scope(ctx: FileContext) -> bool:
    return (
        "serve" in Path(ctx.path).parts
        or _SERVE_MARKER_RE.search(ctx.source) is not None
    )


def _in_v2_codec_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in V2_WIRE_CODEC_STEMS
        or _V2_MARKER_RE.search(ctx.source) is not None
    )


def _taxonomy_imports(tree: ast.Module) -> set[str]:
    """Local names bound by ``from automerge_tpu_torch.errors import ...`` (or the
    relative ``from .errors import ...`` / ``from ..errors import ...``
    spellings) — the only exception classes AM404 permits a v2 wire-codec
    module to raise."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.module is None:
            continue
        if node.module != "errors" and not node.module.endswith(".errors"):
            continue
        if node.module == "errors" and node.level == 0:
            continue  # an unrelated top-level `errors` package
        for alias in node.names:
            names.add(alias.asname or alias.name)
    return names


def _check_am404(ctx: FileContext, findings: list[Finding]) -> None:
    taxonomy = _taxonomy_imports(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        if not isinstance(exc, ast.Name):
            continue
        # Only exception *classes* are policed; re-raising a caught
        # lowercase variable (`raise exc`) is the wrap-and-rethrow idiom
        # the taxonomy itself uses.
        if not exc.id.endswith(("Error", "Exception")):
            continue
        if exc.id in taxonomy:
            continue
        findings.append(ctx.finding(
            "AM404", node,
            f"{exc.id} raised in a v2 wire-codec module: the session "
            "layer's negotiated fallback catches exactly the taxonomy "
            "(SyncProtocolError and friends from automerge_tpu_torch.errors) — "
            "any other class sails past the fallback dispatch and kills "
            "the channel instead of downgrading it to v1; raise a "
            "taxonomy error, or justify-suppress a deliberate "
            "internal-invariant raise",
        ))


def _time_imports(tree: ast.Module) -> set[str]:
    """Local names bound by ``from time import ...``/``from random import
    ...`` to the banned callables (so aliased direct calls are caught)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.module not in (
            "time", "random"
        ):
            continue
        for alias in node.names:
            if node.module == "time":
                if f"time.{alias.name}" in _CLOCK_CALLS:
                    names.add(alias.asname or alias.name)
            elif alias.name not in _RNG_CONSTRUCTORS:
                names.add(alias.asname or alias.name)
    return names


def _check_am402(ctx: FileContext, findings: list[Finding]) -> None:
    aliased = _time_imports(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        banned = (
            name in _CLOCK_CALLS
            or (
                name.startswith("random.")
                and name.split(".", 1)[1] not in _RNG_CONSTRUCTORS
            )
            or name in aliased
        )
        if banned:
            findings.append(ctx.finding(
                "AM402", node,
                f"direct {name}() call in a sync data-plane module: "
                "retransmission timeouts, backoff jitter and watchdog "
                "decisions must be driven by an injected clock callable "
                "and random.Random instance so the chaos suite can replay "
                "them deterministically; suppress with a justification at "
                "the single real-time default",
            ))


def _sleep_aliases(tree: ast.Module) -> set[str]:
    """Local names bound to ``time.sleep`` via ``from time import ...``."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.module != "time":
            continue
        for alias in node.names:
            if alias.name == "sleep":
                names.add(alias.asname or alias.name)
    return names


def _blocking_name(name: str, sleep_names: set[str]) -> bool:
    tail = name.rsplit(".", 1)[-1]
    return (
        name in _BLOCKING_CALLS
        or name.startswith(_BLOCKING_PREFIXES)
        or tail in _BLOCKING_ATTRS
        or name in sleep_names
    )


def _call_name(node: ast.Call) -> str | None:
    """The dotted name of a call, or ``<expr>.attr`` for a method called
    on an expression (``t.sum().item()``): the tail is what blocks."""
    name = dotted_name(node.func)
    if name is None and isinstance(node.func, ast.Attribute):
        return f"<expr>.{node.func.attr}"
    return name


def _check_am403(ctx: FileContext, findings: list[Finding]) -> None:
    sleep_names = _sleep_aliases(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name is None:
            continue
        if _blocking_name(name, sleep_names):
            findings.append(ctx.finding(
                "AM403", node,
                f"blocking {name}() call in serve event-loop code: one "
                "blocked call stalls every client channel at once — yield "
                "with `await asyncio.sleep`, let the injected clock/harness "
                "advance time, hand transports to asyncio, and pay device "
                "readback latency only at the batcher's flush dispatch "
                "(suppress there with a justification)",
            ))


def _check_am403_transitive(ctxs: list[FileContext], graph,
                            findings: list[Finding]) -> None:
    """Blocking calls in helpers the serve layer reaches through the call
    graph. Serve-scope files themselves are owned by the direct walk — the
    transitive pass only reports in files *outside* serve scope, so no call
    site is ever double-flagged."""
    if graph is None:
        return
    roots = []
    serve_ctx_ids: set[int] = set()
    for ctx in ctxs:
        if not _in_serve_scope(ctx):
            continue
        serve_ctx_ids.add(id(ctx))
        mod = graph.module_for(ctx)
        if mod is not None:
            roots.extend(mod.functions.values())
    if not roots:
        return
    sleep_cache: dict[int, set[str]] = {}
    emitted: set[tuple[str, int, int]] = set()
    for fi, chain in graph.reachable(roots).values():
        if id(fi.ctx) in serve_ctx_ids:
            continue
        if id(fi.ctx) not in sleep_cache:
            sleep_cache[id(fi.ctx)] = _sleep_aliases(fi.ctx.tree)
        sleep_names = sleep_cache[id(fi.ctx)]
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name is None or not _blocking_name(name, sleep_names):
                continue
            key = (str(fi.ctx.path), node.lineno, node.col_offset)
            if key in emitted:
                continue
            emitted.add(key)
            findings.append(fi.ctx.finding(
                "AM403", node,
                f"blocking {name}() call reachable from serve event-loop "
                "code: a helper that blocks stalls every client channel "
                "exactly like blocking inline — yield, take an injected "
                "clock, or justify-suppress at this call site"
                + format_chain(chain),
            ))


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    _check_am403_transitive(ctxs, graph, findings)
    for ctx in ctxs:
        if _in_sync_scope(ctx):
            _check_am402(ctx, findings)
        if _in_serve_scope(ctx):
            _check_am403(ctx, findings)
        if _in_v2_codec_scope(ctx):
            _check_am404(ctx, findings)
        if not _in_scope(ctx):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Name) and exc.id in _BARE:
                findings.append(ctx.finding(
                    "AM401", node,
                    f"bare {exc.id} raised in a data-plane module: raise a "
                    "taxonomy error from automerge_tpu_torch.errors (DecodeError/"
                    "ChecksumError/CausalityError/PackingLimitError/"
                    "SyncProtocolError/...) so the fault-isolation layer "
                    "and the error_kind obs dimension can classify it; "
                    "suppress with a justification where a bare raise is "
                    "deliberate",
                ))
    return findings

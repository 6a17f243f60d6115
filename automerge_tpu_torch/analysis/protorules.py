"""AM503 — pipe-protocol conformance between controller and workers.

The mesh pipe protocol (parallel/workers.py) is stringly typed by
construction: the controller sends ``(op, payload)`` frames and the
worker answers ``(status, payload, metrics_delta, flight_events)``
4-tuples. Nothing at runtime checks that both ends agree — a renamed op
surfaces as a worker ``ValueError`` mid-delivery, a dropped tuple element
as an unpack crash on the controller, and a misspelled response field as
a ``KeyError`` deep in the fan-in loop. With the shared-memory data plane
coming (ROADMAP item 2), protocol drift gets strictly more expensive to
catch at runtime, so this rule checks the contract at lint time:

1. **op coverage, both directions** — every op literal the controller
   sends (``handle.request("op", ...)``, ``handle.call("op", ...)``, or a
   raw ``self.conn.send(("op", payload))`` frame) has a matching worker
   handler (an ``op == "..."`` comparison in the dispatch ladder), and
   every handled op is sent by somebody (dead handlers are drift too);
2. **frame arity at every construction site** — worker responses
   (``conn.send((...))`` on the child's bare ``conn``) must be 4-tuples,
   controller requests (``self.conn.send((...))``) must be 2-tuples, and
   tuple-unpacks of ``_recv()``/``recv()`` results must bind exactly 4
   (respectively 2) names;
3. **field conformance** — every literal key the controller reads off a
   response dict (``resp["wall_s"]``, ``resp.get("phases")``) is a key
   some worker-side producer writes (subscript stores on ``resp`` plus
   the dict literals of wire builders like ``tpu.farm.result_to_wire``,
   resolved through the call graph).

Scope: modules whose stem is in ``PROTOCOL_STEMS`` (``workers``,
``meshfarm``) plus files marked ``# amlint: pipe-protocol`` (the fixture
hook). The dispatch-ladder convention is a variable literally named
``op`` compared against string constants, and response dicts are
variables named ``resp`` — the in-tree protocol spelling. The field
check only runs when every ``resp = <call>()`` producer resolved through
the graph (a partial scan that cannot see the wire builder stays silent
rather than guessing).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import FileContext, Finding, dotted_name

#: modules that speak the controller/worker pipe protocol
PROTOCOL_STEMS = frozenset({"workers", "meshfarm"})

_MARKER_RE = re.compile(r"#\s*amlint:\s*pipe-protocol\b")

#: request/response frame arities — the (op, payload) and
#: (status, payload, metrics_delta, flight_events) contracts
REQUEST_ARITY = 2
RESPONSE_ARITY = 4

#: call leaves that bind a response on the controller side (reads, not
#: writes — they never mark the producer set incomplete)
_READ_SIDE_LEAVES = frozenset({"call", "collect", "recv"})

#: max producer-call recursion when collecting write keys (resp =
#: _do_apply(...) -> resp = result_to_wire(...) -> dict literal)
_PRODUCER_DEPTH = 3


def _in_scope(ctx: FileContext) -> bool:
    return (
        Path(ctx.path).stem in PROTOCOL_STEMS
        or _MARKER_RE.search(ctx.source) is not None
    )


def _str_const(node: ast.AST | None) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _Protocol:
    """Everything collected across the in-scope files of one scan."""

    def __init__(self):
        #: op -> [(ctx, node)] send sites / handler compare sites
        self.sent: dict[str, list] = {}
        self.handled: dict[str, list] = {}
        self.reads: list[tuple[FileContext, ast.AST, str]] = []
        self.writes: set[str] = set()
        self.write_sources = 0
        self.unresolved_producer = False
        self.findings: list[Finding] = []


def _function_write_keys(fn: ast.AST, graph, ctx: FileContext,
                         depth: int, proto: _Protocol) -> set[str]:
    """Literal dict keys a producer function contributes to a response:
    dict-literal keys plus string subscript-store keys, following
    ``resp = other_builder(...)`` producer calls through the graph."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for key in node.keys:
                k = _str_const(key)
                if k is not None:
                    out.add(k)
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Store
        ):
            k = _str_const(node.slice)
            if k is not None:
                out.add(k)
        elif depth > 0 and isinstance(node, ast.Assign) and len(
            node.targets
        ) == 1 and isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "resp" and isinstance(
                    node.value, ast.Call):
            out |= _producer_keys(node.value, graph, ctx, depth - 1, proto)
    return out


def _producer_keys(call: ast.Call, graph, ctx: FileContext, depth: int,
                   proto: _Protocol) -> set[str]:
    """Write keys contributed by one ``resp = f(...)`` producer call."""
    leaf = (dotted_name(call.func) or "").rsplit(".", 1)[-1]
    if leaf in _READ_SIDE_LEAVES:
        return set()
    target = None
    if graph is not None:
        mod = graph.module_for(ctx)
        if mod is not None:
            enclosing = None
            parent = getattr(call, "_amlint_parent", None)
            while parent is not None:
                if isinstance(parent, ast.ClassDef):
                    enclosing = parent.name
                    break
                parent = getattr(parent, "_amlint_parent", None)
            target = graph.resolve_call(mod, call.func, enclosing)
    if target is None:
        proto.unresolved_producer = True
        return set()
    proto.write_sources += 1
    return _function_write_keys(target.node, graph, target.ctx, depth, proto)


def _collect(ctx: FileContext, graph, proto: _Protocol) -> None:
    for node in ast.walk(ctx.tree):
        # --- sent ops + frame arity ----------------------------------- #
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            leaf = node.func.attr
            if leaf in ("request", "call") and node.args:
                op = _str_const(node.args[0])
                if op is not None:
                    proto.sent.setdefault(op, []).append((ctx, node))
            elif leaf == "send" and node.args and isinstance(
                node.args[0], ast.Tuple
            ):
                frame = node.args[0]
                op = _str_const(frame.elts[0]) if frame.elts else None
                receiver = dotted_name(node.func.value) or ""
                if receiver == "conn":
                    # child side: response frames off the bare pipe end
                    if len(frame.elts) != RESPONSE_ARITY:
                        proto.findings.append(ctx.finding(
                            "AM503", node,
                            f"worker response frame built with "
                            f"{len(frame.elts)} element(s): the pipe "
                            f"contract is the {RESPONSE_ARITY}-tuple "
                            "(status, payload, metrics_delta, "
                            "flight_events) at every construction site "
                            "— the controller's collect() unpack crashes "
                            "on anything else",
                        ))
                elif receiver.endswith(".conn"):
                    # controller side: request frames
                    if len(frame.elts) != REQUEST_ARITY:
                        proto.findings.append(ctx.finding(
                            "AM503", node,
                            f"controller request frame built with "
                            f"{len(frame.elts)} element(s): the pipe "
                            f"contract is the {REQUEST_ARITY}-tuple "
                            "(op, payload) — the worker loop's unpack "
                            "crashes on anything else",
                        ))
                    if op is not None:
                        proto.sent.setdefault(op, []).append((ctx, node))
        # --- handled ops ---------------------------------------------- #
        if isinstance(node, ast.Compare) and isinstance(
            node.left, ast.Name
        ) and node.left.id == "op" and len(node.ops) == 1 and isinstance(
            node.ops[0], (ast.Eq, ast.NotEq)
        ):
            op = _str_const(node.comparators[0])
            if op is not None and isinstance(node.ops[0], ast.Eq):
                proto.handled.setdefault(op, []).append((ctx, node))
        # --- unpack arities ------------------------------------------- #
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Tuple) and isinstance(
                    node.value, ast.Call):
            leaf = (dotted_name(node.value.func) or "").rsplit(".", 1)[-1]
            width = len(node.targets[0].elts)
            if leaf == "_recv" and width != RESPONSE_ARITY:
                proto.findings.append(ctx.finding(
                    "AM503", node,
                    f"response unpack binds {width} name(s): worker "
                    f"frames are {RESPONSE_ARITY}-tuples (status, "
                    "payload, metrics_delta, flight_events)",
                ))
            elif leaf == "recv" and width != REQUEST_ARITY:
                proto.findings.append(ctx.finding(
                    "AM503", node,
                    f"request unpack binds {width} name(s): controller "
                    f"frames are {REQUEST_ARITY}-tuples (op, payload)",
                ))
        # --- response-field reads and writes -------------------------- #
        if isinstance(node, ast.Subscript) and isinstance(
            node.value, ast.Name
        ) and node.value.id == "resp":
            key = _str_const(node.slice)
            if key is not None:
                if isinstance(node.ctx, ast.Store):
                    proto.writes.add(key)
                    proto.write_sources += 1
                else:
                    proto.reads.append((ctx, node, key))
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr == "get" and isinstance(
            node.func.value, ast.Name
        ) and node.func.value.id == "resp" and node.args:
            key = _str_const(node.args[0])
            if key is not None:
                proto.reads.append((ctx, node, key))
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "resp":
            if isinstance(node.value, ast.Dict):
                for key in node.value.keys:
                    k = _str_const(key)
                    if k is not None:
                        proto.writes.add(k)
                proto.write_sources += 1
            elif isinstance(node.value, ast.Call):
                proto.writes |= _producer_keys(
                    node.value, graph, ctx, _PRODUCER_DEPTH, proto
                )


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    proto = _Protocol()
    scoped = [ctx for ctx in ctxs if _in_scope(ctx)]
    for ctx in scoped:
        _collect(ctx, graph, proto)

    # direction 1: every sent op has a handler (only checkable when the
    # handler side is in the scan)
    if proto.handled:
        for op, sites in sorted(proto.sent.items()):
            if op in proto.handled:
                continue
            for ctx, node in sites:
                proto.findings.append(ctx.finding(
                    "AM503", node,
                    f"controller sends frame type {op!r} but no worker "
                    "handler matches it (no `op == ...` arm in the "
                    "dispatch ladder): the worker will raise mid-delivery",
                ))
    # direction 2: every handler is reachable from a send site
    if proto.sent:
        for op, sites in sorted(proto.handled.items()):
            if op in proto.sent:
                continue
            for ctx, node in sites:
                proto.findings.append(ctx.finding(
                    "AM503", node,
                    f"worker handles frame type {op!r} but nothing sends "
                    "it: a dead handler is protocol drift — delete it or "
                    "wire up the sender",
                ))
    # direction 3: fields read by the receiver are fields written by the
    # sender — skipped when a producer call could not be resolved (a
    # partial scan must not guess at the write set)
    if proto.write_sources and not proto.unresolved_producer:
        for ctx, node, key in proto.reads:
            if key not in proto.writes:
                proto.findings.append(ctx.finding(
                    "AM503", node,
                    f"response field {key!r} is read but no worker-side "
                    "producer writes it (known fields: "
                    f"{sorted(proto.writes)}): this is a KeyError waiting "
                    "in the fan-in loop",
                ))
    return proto.findings

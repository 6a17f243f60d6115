"""AM701 — shape-stability: no unbucketed dynamic lengths at a dispatch.

The port's observatory (obs/prof.py) counts every new shape bucket a
device program sees as a compile (the JAX package's XLA compile per
argument-shape signature): the caching allocator sizes new blocks, and a
program whose leading dimension is a raw ``len(batch)`` sees a new bucket
for every batch size — the recompile storm the runtime detector
(``prof.recompile.storm``) can only report after the fact. Every in-tree
dispatch path rounds lengths onto a power-of-two grid first (``_pow2`` in
tpu/engine.py and tpu/sync_farm.py, ``_next_pow2`` in tpu/text_engine.py),
capping the bucket count at log2(maxlen) per program.

This rule is the static twin of the storm detector: it flags a
``profiled_program`` dispatch site (a direct call, or the engine's
``_dispatch(program, ...)`` funnel) when an argument's dataflow path from
a dynamic length (``len()``, ``.shape``, a dynamically bounded slice)
reaches the dispatch with **no pow2/bucket helper on the path**
(dataflow.py holds the taint engine). The diagnostic prints the dataflow
chain, mirroring the ``[reachable via ...]`` chains of the call-graph
rules.

Dispatch callables are discovered structurally, package-wide:

- top-level defs decorated ``@profiled_program("name")`` (the label is
  the registered program name) or with a torch compiler decorator;
- module/function-level bindings ``x = profiled_program("name")(f)`` and
  ``x = torch.compile(f)``;
- from-imports and module-alias attribute calls the call graph resolves
  to either of the above — the dispatch site and the program definition
  are usually in different modules;
- ``_dispatch(prog, ...)`` where ``prog`` resolves to one of the above.

Suppress a deliberately shape-dynamic dispatch with
``# amlint: disable=AM701`` and a justification.
"""
from __future__ import annotations

import ast

from .core import FileContext, Finding, dotted_name
from .dataflow import ShapeFlow
from .tracer import _decorator_statics, _is_jit_like

__all__ = ["check"]


def _program_label(fn: ast.AST) -> str | None:
    """The registered program name if ``fn`` is a dispatch-decorated
    device program."""
    for dec in fn.decorator_list:
        traced, _nums, _names = _decorator_statics(dec)
        if not traced:
            continue
        if isinstance(dec, ast.Call):
            leaf = (dotted_name(dec.func) or "").rsplit(".", 1)[-1]
            if leaf == "profiled_program" and dec.args and isinstance(
                dec.args[0], ast.Constant
            ) and isinstance(dec.args[0].value, str):
                return dec.args[0].value
        return fn.name
    return None


def _binding_label(value: ast.expr) -> str | None:
    """Program label when ``value`` is a dispatch factory expression:
    ``torch.compile(f)`` or ``profiled_program("name")(f)``."""
    if not isinstance(value, ast.Call):
        return None
    if _is_jit_like(value.func) and (
            dotted_name(value.func) or "").rsplit(".", 1)[-1] != \
            "profiled_program":
        name = dotted_name(value.func) or "torch.compile"
        if value.args and isinstance(value.args[0], ast.Name):
            return value.args[0].id
        return name
    if isinstance(value.func, ast.Call):
        leaf = (dotted_name(value.func.func) or "").rsplit(".", 1)[-1]
        if leaf == "profiled_program":
            inner = value.func
            if inner.args and isinstance(inner.args[0], ast.Constant) and \
                    isinstance(inner.args[0].value, str):
                return inner.args[0].value
            return "profiled_program"
    return None


def _module_dispatch(tree: ast.Module) -> dict[str, str]:
    """{local name: program label} for one module's dispatch callables."""
    out: dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            label = _program_label(stmt)
            if label is not None:
                out[stmt.name] = label
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            label = _binding_label(stmt.value)
            if label is not None:
                out[stmt.targets[0].id] = label
    return out


def _local_dispatch(fn: ast.AST) -> dict[str, str]:
    """Function-local ``prog = profiled_program("name")(f)``-style
    bindings."""
    out: dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            label = _binding_label(node.value)
            if label is not None:
                out[node.targets[0].id] = label
    return out


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings: list[Finding] = []
    # pass 1: every module's dispatch names, keyed by module name so
    # from-imports and module aliases resolve cross-file
    dispatch_by_module: dict[str, dict[str, str]] = {}
    infos = []
    for ctx in ctxs:
        info = graph.module_for(ctx) if graph is not None else None
        infos.append((ctx, info))
        table = _module_dispatch(ctx.tree)
        if info is not None:
            dispatch_by_module[info.name] = table
        elif table:
            dispatch_by_module[ctx.path.stem] = table

    # pass 2: length-taint every function against the resolved sinks
    for ctx, info in infos:
        module_table = dispatch_by_module.get(
            info.name if info is not None else ctx.path.stem, {}
        )

        def resolver(call: ast.Call, *, _info=info, _table=module_table,
                     _local=None):
            func = call.func
            leaf = (dotted_name(func) or "").rsplit(".", 1)[-1]
            if leaf == "_dispatch" and call.args:
                # the engine's funnel: its first argument is the program
                return resolver(ast.Call(func=call.args[0], args=[],
                                         keywords=[]), _local=_local)
            if isinstance(func, ast.Name):
                if _local and func.id in _local:
                    return _local[func.id]
                if func.id in _table:
                    return _table[func.id]
                if _info is not None:
                    imported = _info.from_imports.get(func.id)
                    if imported is not None:
                        target = dispatch_by_module.get(imported[0], {})
                        if imported[1] in target:
                            return target[imported[1]]
                return None
            name = dotted_name(func)
            if name and _info is not None and "." in name:
                root, leaf = name.split(".")[0], name.split(".")[-1]
                target_mod = _info.import_aliases.get(root)
                if target_mod is not None:
                    target = dispatch_by_module.get(target_mod, {})
                    if leaf in target:
                        return target[leaf]
            return None

        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            local = _local_dispatch(node)
            # the dispatch defs themselves are sinks, not sites: skip the
            # decorated body (its params are tracer-checked by AM2xx)
            if _program_label(node) is not None:
                continue

            def dispatch(call, _local=local, _resolver=resolver):
                return _resolver(call, _local=_local)

            def report(call, program, chain, _ctx=ctx):
                findings.append(_ctx.finding(
                    "AM701", call,
                    f"dispatch of `{program}` fed a tensor-shape argument "
                    "derived from an unbucketed dynamic length — every new "
                    "length is a new shape bucket, counted as a compile "
                    "(the runtime twin is prof.recompile.storm); route the "
                    "length through a pow2/bucket helper before building "
                    f"the tensor [dataflow: {' -> '.join(chain)}]",
                ))

            ShapeFlow(node, dispatch, report).run()
    return findings

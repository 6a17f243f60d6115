"""Whole-program import/call-graph engine for amlint.

Reachability-flavoured rules (AM2xx "no hidden sync in a device
program", AM403 "no blocking calls in serve event-loop code", AM502
"workers never import the controller") cannot work off *direct* calls
and *direct* imports inside one file alone: that misses exactly the bugs
the rules exist for: a blocking ``torch.cuda.synchronize`` two frames below a serve
entry point, a worker module that reaches the controller through an
innocent-looking helper import. This module gives every rule the same
three whole-scan facts:

- **module summaries** (:class:`ModuleInfo`): per scanned file, the
  dotted module name, its top-level functions and class methods, its
  import aliases (``import x.y as z``) and from-imports (``from .a
  import b`` — including function-level imports, which the worker spawn
  path uses deliberately), with relative imports resolved against the
  module's package;
- **call resolution** (:meth:`CallGraph.resolve_call`): a call
  expression resolved to the function definition it statically targets —
  plain names through module functions and from-imports, dotted names
  through module aliases, ``self.meth()`` through the enclosing class,
  ``ClassName.meth``/``ClassName()`` through same-scan classes, and
  local variables whose class is inferable from a one-function
  ``x = ClassName(...)`` assignment. Anything the resolver cannot prove
  (attributes of parameters, ``self.farm.apply_changes``) stays
  unresolved — reachability stops at the honest static boundary instead
  of guessing;
- **transitive reachability** (:meth:`CallGraph.reachable`): BFS from a
  root set with a bounded call depth (``MAX_CALL_DEPTH``), returning the
  shortest discovery chain per reached function so rule diagnostics can
  print the actual ``[reachable via a -> b -> c]`` path;
- **module-import closure** (:meth:`CallGraph.import_closure`): the
  same idea one level up — which modules a module drags in transitively,
  with the chain of module names and the anchoring first-hop import
  statement (what AM502/AM305 flag).

The graph is built only from the files handed to ``run_analysis`` — a
single-fixture scan degrades gracefully to per-module behaviour (no
cross-file edges exist), which keeps the fixture triples hermetic.
Stdlib-only, like everything else in the analysis package.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from .core import PACKAGE, FileContext, dotted_name

#: bound on transitive call-chain depth: deep enough to cross a few
#: helper layers, shallow enough that one unresolved facade does not
#: drag half the package into every rule's scope
MAX_CALL_DEPTH = 6

#: bound on transitive module-import chains (AM502/AM305)
MAX_IMPORT_DEPTH = 8


def module_name(path: Path) -> str:
    """Dotted module name for a scanned file: package files become
    ``automerge_tpu_torch.x.y``; anything outside the package (fixtures,
    scratch files) is just its stem, so cross-file resolution only ever
    links files that genuinely share the package namespace."""
    parts = list(path.parts)
    if PACKAGE not in parts:
        return path.stem
    idx = len(parts) - 1 - parts[::-1].index(PACKAGE)
    rel = parts[idx:-1] + [path.stem]
    if path.stem == "__init__":
        rel = parts[idx:-1]
    return ".".join(rel)


@dataclasses.dataclass
class FuncInfo:
    """One statically known function: a top-level def or a class method."""

    module: str
    qualname: str  # "f" or "Class.f"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    ctx: FileContext

    @property
    def key(self) -> tuple[str, str]:
        return (self.module, self.qualname)

    @property
    def label(self) -> str:
        """Human chain label: module-qualified outside the defining file."""
        tail = self.module.rsplit(".", 1)[-1]
        return f"{tail}.{self.qualname}"


class ModuleInfo:
    """Per-module summary the resolver queries."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.name = module_name(ctx.path)
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        #: local alias -> dotted module path (``import x.y as z``)
        self.import_aliases: dict[str, str] = {}
        #: local name -> (dotted module path, attr) for from-imports;
        #: attr may itself be a submodule — decided at resolve time
        self.from_imports: dict[str, tuple[str, str]] = {}
        #: every dotted module path this module imports, mapped to the
        #: first import statement that pulls it in (the finding anchor)
        self.imported_modules: dict[str, ast.AST] = {}
        self._summarize()

    # ------------------------------------------------------------------ #

    def _resolve_relative(self, module: str | None, level: int) -> str:
        if level == 0:
            return module or ""
        base = self.name.split(".")
        # a module's package is its dotted name minus the last component;
        # each additional level strips one more
        base = base[: max(len(base) - level, 0)]
        if module:
            base = base + module.split(".")
        return ".".join(base)

    def _summarize(self) -> None:
        tree = self.ctx.tree
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[stmt.name] = FuncInfo(
                    self.name, stmt.name, stmt, self.ctx
                )
            elif isinstance(stmt, ast.ClassDef):
                self.classes[stmt.name] = stmt
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        qual = f"{stmt.name}.{sub.name}"
                        self.functions[qual] = FuncInfo(
                            self.name, qual, sub, self.ctx
                        )
        # imports anywhere in the file: the worker spawn path imports
        # inside functions on purpose, and those edges are the ones
        # AM502's transitive check exists for
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_aliases[alias.asname or
                                        alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0]
                    )
                    if alias.asname:
                        self.import_aliases[alias.asname] = alias.name
                    self.imported_modules.setdefault(alias.name, node)
            elif isinstance(node, ast.ImportFrom):
                target = self._resolve_relative(node.module, node.level)
                if target:
                    self.imported_modules.setdefault(target, node)
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = (
                        target, alias.name
                    )
                    # `from pkg import submodule` also imports the module
                    sub = f"{target}.{alias.name}" if target else alias.name
                    self.imported_modules.setdefault(sub, node)


class CallGraph:
    """The whole-scan graph every reachability rule queries."""

    def __init__(self, ctxs: list[FileContext]):
        self.modules: dict[str, ModuleInfo] = {}
        self.by_ctx: dict[int, ModuleInfo] = {}
        for ctx in ctxs:
            try:
                mod = ModuleInfo(ctx)
            except RecursionError:  # pragma: no cover - absurd nesting
                continue
            # first file wins on a name collision (standalone fixtures
            # sharing a stem): deterministic because ctxs arrive sorted
            self.modules.setdefault(mod.name, mod)
            self.by_ctx[id(ctx)] = mod
        self._callee_cache: dict[tuple[str, str], list] = {}

    # ------------------------------------------------------------------ #
    # resolution

    def module_for(self, ctx: FileContext) -> ModuleInfo | None:
        return self.by_ctx.get(id(ctx))

    def function(self, module: str, qualname: str) -> FuncInfo | None:
        mod = self.modules.get(module)
        return mod.functions.get(qualname) if mod else None

    def _module_target(self, mod: ModuleInfo, root: str) -> str | None:
        """The dotted module path a local name refers to, if it names a
        module in this scan (``import x.y as z`` or ``from pkg import
        sub`` where ``pkg.sub`` is a scanned module)."""
        target = mod.import_aliases.get(root)
        if target and target in self.modules:
            return target
        fi = mod.from_imports.get(root)
        if fi:
            candidate = f"{fi[0]}.{fi[1]}" if fi[0] else fi[1]
            if candidate in self.modules:
                return candidate
        return None

    def resolve_call(
        self,
        mod: ModuleInfo,
        func: ast.expr,
        enclosing_class: str | None = None,
        local_types: dict[str, str] | None = None,
    ) -> FuncInfo | None:
        """The function definition a call expression statically targets,
        or None when the receiver is not provable from this scan."""
        if isinstance(func, ast.Name):
            fi = mod.functions.get(func.id)
            if fi is not None:
                return fi
            # constructing a same-scan class reaches its __init__
            if func.id in mod.classes:
                return mod.functions.get(f"{func.id}.__init__")
            imported = mod.from_imports.get(func.id)
            if imported is not None:
                target_mod, attr = imported
                target = self.modules.get(target_mod)
                if target is not None:
                    hit = target.functions.get(attr)
                    if hit is not None:
                        return hit
                    if attr in target.classes:
                        return target.functions.get(f"{attr}.__init__")
            return None
        name = dotted_name(func)
        if name is None or "." not in name:
            return None
        parts = name.split(".")
        root, leaf = parts[0], parts[-1]
        if root == "self" and enclosing_class is not None and len(parts) == 2:
            return mod.functions.get(f"{enclosing_class}.{leaf}")
        if len(parts) == 2:
            if root in mod.classes:
                return mod.functions.get(f"{root}.{leaf}")
            if local_types and root in local_types:
                cls = local_types[root]
                hit = self.function_in_any(cls, leaf, mod)
                if hit is not None:
                    return hit
        # module-alias attribute: `transcode.gate_verdicts(...)`
        target_mod = self._module_target(mod, root)
        if target_mod is not None:
            # honour one submodule hop: `pkg.mod.fn`
            for depth in range(len(parts) - 1, 0, -1):
                candidate = ".".join(
                    [target_mod] + parts[1:depth]
                ) if depth > 1 else target_mod
                target = self.modules.get(candidate)
                if target is not None:
                    hit = target.functions.get(parts[depth])
                    if hit is not None and depth == len(parts) - 1:
                        return hit
        return None

    def function_in_any(self, cls: str, meth: str,
                        prefer: ModuleInfo) -> FuncInfo | None:
        """``Class.meth`` looked up in ``prefer`` first, then in the
        module the class was from-imported from."""
        hit = prefer.functions.get(f"{cls}.{meth}")
        if hit is not None:
            return hit
        imported = prefer.from_imports.get(cls)
        if imported is not None:
            target = self.modules.get(imported[0])
            if target is not None:
                return target.functions.get(f"{imported[1]}.{meth}")
        return None

    @staticmethod
    def local_class_types(mod: ModuleInfo, fn: ast.AST) -> dict[str, str]:
        """{local var: class name} for one-function ``x = ClassName(...)``
        assignments — the 'method receivers where inferable' contract."""
        out: dict[str, str] = {}
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            value = node.value
            if not isinstance(value, ast.Call):
                continue
            cname = dotted_name(value.func)
            if cname is None:
                continue
            leaf = cname.split(".")[-1]
            if leaf in mod.classes or (
                leaf in mod.from_imports and leaf[:1].isupper()
            ):
                out[target.id] = leaf
        return out

    # ------------------------------------------------------------------ #
    # call reachability

    def callees(self, fi: FuncInfo) -> list[tuple[FuncInfo, ast.AST]]:
        """Resolved (callee, call node) pairs inside one function."""
        cached = self._callee_cache.get(fi.key)
        if cached is not None:
            return cached
        mod = self.by_ctx.get(id(fi.ctx))
        out: list[tuple[FuncInfo, ast.AST]] = []
        if mod is not None:
            enclosing = fi.qualname.split(".")[0] if "." in fi.qualname else None
            local_types = self.local_class_types(mod, fi.node)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                hit = self.resolve_call(mod, node.func, enclosing, local_types)
                if hit is not None and hit.key != fi.key:
                    out.append((hit, node))
        self._callee_cache[fi.key] = out
        return out

    def reachable(
        self, roots: list[FuncInfo], max_depth: int = MAX_CALL_DEPTH
    ) -> dict[tuple[str, str], tuple[FuncInfo, tuple[str, ...]]]:
        """Every function reachable from ``roots`` within ``max_depth``
        calls: ``{key: (FuncInfo, chain)}`` where ``chain`` is the
        shortest discovery path of human labels, root first. Roots are
        included with a single-element chain."""
        out: dict[tuple[str, str], tuple[FuncInfo, tuple[str, ...]]] = {}
        frontier: list[tuple[FuncInfo, tuple[str, ...]]] = []
        for root in roots:
            if root.key not in out:
                chain = (root.label,)
                out[root.key] = (root, chain)
                frontier.append((root, chain))
        depth = 0
        while frontier and depth < max_depth:
            depth += 1
            next_frontier: list[tuple[FuncInfo, tuple[str, ...]]] = []
            for fi, chain in frontier:
                for callee, _node in self.callees(fi):
                    if callee.key in out:
                        continue
                    sub = chain + (callee.label,)
                    out[callee.key] = (callee, sub)
                    next_frontier.append((callee, sub))
            frontier = next_frontier
        return out

    # ------------------------------------------------------------------ #
    # module-import reachability

    def import_closure(
        self, start: str, max_depth: int = MAX_IMPORT_DEPTH
    ) -> dict[str, tuple[tuple[str, ...], ast.AST]]:
        """Modules transitively imported by ``start`` (scanned modules
        only): ``{module: (chain of module names from start, first-hop
        import node in start)}``. The anchor node is where the offending
        edge enters the flagged module — that line owns the fix (or the
        justified suppression)."""
        start_mod = self.modules.get(start)
        if start_mod is None:
            return {}
        out: dict[str, tuple[tuple[str, ...], ast.AST]] = {}
        frontier: list[tuple[str, tuple[str, ...], ast.AST]] = []
        for target, node in start_mod.imported_modules.items():
            if target in self.modules and target != start:
                if target not in out:
                    out[target] = ((start, target), node)
                    frontier.append((target, (start, target), node))
        depth = 1
        while frontier and depth < max_depth:
            depth += 1
            next_frontier = []
            for modname, chain, anchor in frontier:
                mod = self.modules[modname]
                for target in mod.imported_modules:
                    if target in self.modules and target not in out \
                            and target != start:
                        sub = chain + (target,)
                        out[target] = (sub, anchor)
                        next_frontier.append((target, sub, anchor))
            frontier = next_frontier
        return out

    def importers_closure(self, targets: set[str]) -> set[str]:
        """Every scanned module that transitively imports one of
        ``targets`` (used by the CLI's ``--changed`` fallback logic)."""
        importers: dict[str, set[str]] = {name: set() for name in self.modules}
        for name, mod in self.modules.items():
            for target in mod.imported_modules:
                if target in importers:
                    importers[target].add(name)
        out: set[str] = set()
        frontier = [t for t in targets if t in importers]
        while frontier:
            cur = frontier.pop()
            for importer in importers.get(cur, ()):
                if importer not in out and importer not in targets:
                    out.add(importer)
                    frontier.append(importer)
        return out


def format_chain(chain: tuple[str, ...]) -> str:
    """The diagnostic suffix every reachability rule appends: the actual
    call path from the rule's root to the finding site."""
    return " [reachable via " + " -> ".join(chain) + "]"

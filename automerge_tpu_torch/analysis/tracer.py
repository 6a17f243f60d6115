"""AM2xx — device-program safety rules (the JAX package's tracer rules).

In the JAX package these rules guard traced code, where a Python branch on
a tracer raises or bakes one execution into the program. PyTorch runs
eagerly, so nothing is traced; the same constructs inside a *device
program* (a function registered with ``@profiled_program``, the kernel
wrappers ``kernel.*`` among them) are hidden syncs instead: ``if t:``,
``bool(t)``, ``t.item()``, ``t.cpu()``, ``np.asarray(t)`` on a tensor that
lives on the card wait for the card's queue to drain and copy the value
back, in the middle of a program the host is supposed to enqueue and
leave. The checker builds a per-module view of device code:

- **roots**: functions decorated ``@profiled_program(...)`` (and
  ``torch.compile``/``torch.jit.script``/``torch.vmap`` decorators), plus
  functions *referenced* as arguments of those combinators, or bound by
  ``x = profiled_program("name")(f)``. Parameters annotated ``int``,
  ``float``, ``bool`` or ``str`` are host values and stay static;
- **taint**: inside a device program, parameters are tensors; taint
  propagates through expressions and assignments, and is *blocked* by the
  static accessors (``.shape``, ``.dtype``, ``.device``, ``.ndim``,
  ``len()``, ``.size()``, ``.numel()``, ``.data_ptr()``, ...) — shape and
  placement math is host-side and branching on it is legal;
- **interprocedural**: a call from device code taints the callee's
  parameters positionally, so shared helpers are checked under the taint
  they actually receive. Resolution is whole-scan (graph.py): direct
  same-module calls, from-imported helpers in other scanned modules, and
  ``Class.meth``/module-alias attribute targets all propagate taint, with
  the discovery chain carried along so every diagnostic prints the actual
  ``[reachable via root -> helper -> ...]`` path from its root.

Rules:
- AM201: ``if``/``while``/``assert``/``and``/``or``/ternary/``for`` over a
  tensor inside a device program (an implicit ``bool()`` or iteration: a
  sync per use).
- AM202: host escapes — ``np.*`` calls, ``int()``/``float()``/``bool()``,
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` — applied to a tensor
  inside a device program.
- AM203: ``torch.tensor/as_tensor/zeros/ones/full/empty/arange`` without
  ``dtype=`` (or the numpy forms ``np.array/zeros/ones/full/empty/arange``
  without a dtype) in modules that import torch: default dtypes differ
  (int64 vs float32, numpy's platform int), which corrupts packed int64
  opids — device-adjacent code must pin every dtype.
- AM204 has no meaning here (``core.JAX_ONLY``): a device program runs its
  Python on every call, so a host-state mutation in it is not a stale
  trace-time effect. It never fires.
"""
from __future__ import annotations

import ast

from .core import FileContext, Finding, dotted_name
from .graph import format_chain

#: decorators that make a device program: the observatory's wrapper
#: (bare or called with the program name) and torch's compilers
_JIT_DECORATORS = {"profiled_program", "compile", "script", "vmap"}
#: calls whose function arguments run as device code
_COMBINATORS = {"compile", "script", "vmap"}
_TORCH_ROOTS = {"torch", "func", "jit"}
#: attributes that read host metadata of a tensor, never its data
_SHAPE_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "requires_grad", "names"}
#: tensor methods that return host metadata (no sync)
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "ndimension",
                   "data_ptr", "get_device", "is_contiguous",
                   "element_size", "stride", "storage_offset",
                   "is_floating_point"}
_STATIC_CALLS = {"len", "range", "isinstance", "type", "enumerate", "zip"}
_COERCIONS = {"int", "float", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: parameter annotations that mark a host value
_HOST_ANNOTATIONS = {"int", "float", "bool", "str"}
#: constructors AM203 holds to an explicit dtype: torch's take it by
#: keyword only; numpy's also at this positional index
_DTYPE_CTORS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2, "array": 1,
                "arange": 3, "tensor": None, "as_tensor": None}
_NUMPY_DTYPE_CTORS = {"zeros", "ones", "empty", "full", "array", "arange"}


def _np_aliases(tree: ast.Module) -> set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "numpy":
                    out.add(alias.asname or "numpy")
    return out


def _torch_aliases(tree: ast.Module) -> set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch":
                    out.add(alias.asname or "torch")
    return out


def _import_aliases(tree: ast.Module) -> set[str]:
    """Every top-level name bound by an import (module aliases and
    from-imported names): functional APIs like jnp.append are not captured
    host state."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                out.add(alias.asname or alias.name)
    return out


def _imports_torch(tree: ast.Module) -> bool:
    """Whether the module imports torch: the device-adjacent modules."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module and (node.module == "torch"
                                or node.module.startswith("torch.")):
                return True
    return False


def _is_combinator_call(func: ast.expr) -> bool:
    name = dotted_name(func)
    if name is None:
        return False
    parts = name.split(".")
    if parts[-1] not in _COMBINATORS:
        return False
    return (len(parts) == 1 and parts[0] == "vmap") or any(
        p in _TORCH_ROOTS for p in parts[:-1])


def _is_jit_like(node: ast.expr) -> bool:
    """``profiled_program`` (bare or module-qualified), or torch's
    ``compile``/``jit.script``/``vmap``."""
    name = dotted_name(node)
    if name is None:
        return False
    parts = name.split(".")
    if parts[-1] == "profiled_program":
        return True
    return parts[-1] in _JIT_DECORATORS and (
        (len(parts) == 1 and parts[0] == "vmap")
        or any(p in _TORCH_ROOTS for p in parts[:-1])
    )


def _const_strings(node: ast.expr) -> set[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = set()
        for elt in node.elts:
            out |= _const_strings(elt)
        return out
    return set()


def _const_ints(node: ast.expr) -> set[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = set()
        for elt in node.elts:
            out |= _const_ints(elt)
        return out
    return set()


def _decorator_statics(dec: ast.expr):
    """(is_device_program, static_argnums, static_argnames) for a decorator
    node: ``@profiled_program("name")``, ``@torch.compile(...)`` and the
    like (``static_argnums``/``static_argnames`` are read where given)."""
    if _is_jit_like(dec):
        return True, set(), set()
    if isinstance(dec, ast.Call):
        func_name = dotted_name(dec.func)
        target_is_jit = False
        if func_name and func_name.split(".")[-1] == "partial" and dec.args:
            target_is_jit = _is_jit_like(dec.args[0])
        elif _is_jit_like(dec.func):
            target_is_jit = True
        if target_is_jit:
            nums: set[int] = set()
            names: set[str] = set()
            for kw in dec.keywords:
                if kw.arg == "static_argnums":
                    nums |= _const_ints(kw.value)
                elif kw.arg == "static_argnames":
                    names |= _const_strings(kw.value)
            return True, nums, names
    return False, set(), set()


def _host_params(fn) -> set[str]:
    """Parameters annotated with a host scalar type (``int``, ``float``,
    ``bool``, ``str``): host values, never tensors."""
    args = fn.args
    out = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if isinstance(ann, ast.Name) and ann.id in _HOST_ANNOTATIONS:
            out.add(a.arg)
        elif isinstance(ann, ast.Constant) and ann.value in _HOST_ANNOTATIONS:
            out.add(a.arg)
    return out


def _binding_refs(tree: ast.Module, funcs: dict) -> list:
    """Module functions bound as device programs by a call:
    ``x = profiled_program("name")(f)`` / ``torch.compile(...)(f)``."""
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)
                and _is_jit_like(node.func.func)):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Name) and arg.id in funcs:
                out.append(funcs[arg.id])
    return out


def _param_names(fn) -> list[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args]
    names += [a.arg for a in args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _assigned_names(fn) -> set[str]:
    """Every name bound anywhere inside the function body (its locals)."""
    out: set[str] = set(_param_names(fn))
    for node in ast.walk(fn):
        if isinstance(node, (ast.Name,)) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node is not fn:
                out.add(node.name)
        elif isinstance(node, ast.comprehension):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    out.add(sub.id)
    return out


class _Coordinator:
    """Whole-scan driver: one checker per file, one shared worklist of
    ``(checker, fn, tainted params, discovery chain)`` items, so taint
    crossing a module boundary lands in the right file's checker with the
    chain that got it there."""

    def __init__(self, ctxs: list[FileContext], graph=None,
                 checker_cls=None):
        self.graph = graph
        cls = checker_cls or _ModuleChecker
        self.checkers: dict[int, _ModuleChecker] = {
            id(ctx): cls(ctx, self) for ctx in ctxs
        }
        self.worklist: list[tuple] = []

    def enqueue(self, checker, fn, tainted: frozenset,
                chain: tuple[str, ...]) -> None:
        self.worklist.append((checker, fn, tainted, chain))

    def enqueue_info(self, fi, tainted: frozenset,
                     chain: tuple[str, ...]) -> None:
        """Cross-module hop: route a graph-resolved FuncInfo to the
        checker that owns its file, extending the chain."""
        checker = self.checkers.get(id(fi.ctx))
        if checker is not None:
            self.worklist.append(
                (checker, fi.node, tainted, chain + (fi.label,))
            )

    def run(self) -> list[Finding]:
        for checker in self.checkers.values():
            checker.seed()
        while self.worklist:
            checker, fn, tainted, chain = self.worklist.pop()
            key = (id(fn), tainted)
            if key in checker._done:
                continue
            checker._done.add(key)
            checker._analyze_function(fn, tainted, chain)
        findings: list[Finding] = []
        for checker in self.checkers.values():
            findings.extend(checker.findings)
        return findings


class _ModuleChecker:
    def __init__(self, ctx: FileContext, coordinator: _Coordinator = None):
        self.ctx = ctx
        self.coordinator = coordinator
        self.tree = ctx.tree
        self.np_aliases = _np_aliases(ctx.tree)
        self.torch_aliases = _torch_aliases(ctx.tree)
        self.import_aliases = _import_aliases(ctx.tree)
        self.findings: list[Finding] = []
        self._emitted: set[tuple[str, int, int]] = set()
        self.module_funcs = {
            n.name: n
            for n in self.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # (func name, frozenset of tainted params) already analyzed
        self._done: set[tuple[int, frozenset]] = set()
        self.traced_names: set[str] = set()
        #: chain of the function currently under analysis — every finding
        #: it emits prints the path from its trace root
        self._current_chain: tuple[str, ...] = ()

    # ------------------------------------------------------------------ #

    def seed(self) -> None:
        """Discovers this module's trace roots and enqueues them on the
        coordinator with single-element chains."""
        co = self.coordinator

        for fn in self.module_funcs.values():
            for dec in fn.decorator_list:
                traced, nums, names = _decorator_statics(dec)
                if traced:
                    params = _param_names(fn)
                    host = _host_params(fn)
                    tainted = frozenset(
                        p for i, p in enumerate(params)
                        if i not in nums and p not in names and p not in host
                    )
                    co.enqueue(self, fn, tainted, (fn.name,))
                    self.traced_names.add(fn.name)
                    break

        for fn in _binding_refs(self.tree, self.module_funcs):
            host = _host_params(fn)
            tainted = frozenset(p for p in _param_names(fn) if p not in host)
            co.enqueue(self, fn, tainted, (fn.name,))
            self.traced_names.add(fn.name)

        # module functions referenced as combinator arguments anywhere
        for fn, exempt_names, exempt_count in self._combinator_refs(self.tree):
            params = _param_names(fn)
            tainted = frozenset(
                p for i, p in enumerate(params)
                if i >= exempt_count and p not in exempt_names
            )
            co.enqueue(self, fn, tainted, (fn.name,))
            self.traced_names.add(fn.name)

        # nested defs passed to combinators inside otherwise-host functions
        # (e.g. `return torch.compile(impl)` in a factory) are roots too
        module_fn_nodes = set(map(id, self.module_funcs.values()))
        for fn in self.module_funcs.values():
            nested = {
                n.name: n for n in ast.walk(fn)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n is not fn
            }
            if not nested:
                continue
            for sub, exempt_names, exempt_count in self._combinator_refs(fn, nested):
                if id(sub) in module_fn_nodes:
                    continue  # already handled by the module-wide scan
                params = _param_names(sub)
                tainted = frozenset(
                    p for i, p in enumerate(params)
                    if i >= exempt_count and p not in exempt_names
                )
                co.enqueue(self, sub, tainted, (sub.name,))

    def resolve_cross(self, call: ast.Call):
        """Graph resolution for calls the per-module lookup missed:
        from-imported helpers, module-alias attributes, same-scan class
        methods. Returns a FuncInfo or None."""
        co = self.coordinator
        if co is None or co.graph is None:
            return None
        mod = co.graph.module_for(self.ctx)
        if mod is None:
            return None
        return co.graph.resolve_call(mod, call.func)

    def _combinator_refs(self, scope: ast.AST, local_funcs=None):
        """(function node, partial-bound kwnames, partial-bound positional
        count) for every module/nested function referenced as an argument
        of a tracing combinator within `scope`."""
        funcs = dict(self.module_funcs)
        if local_funcs:
            funcs.update(local_funcs)
        refs = []
        for node in ast.walk(scope):
            if not (isinstance(node, ast.Call) and _is_combinator_call(node.func)):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in funcs:
                    refs.append((funcs[arg.id], set(), 0))
                elif isinstance(arg, ast.Call):
                    fname = dotted_name(arg.func)
                    if (
                        fname
                        and fname.split(".")[-1] == "partial"
                        and arg.args
                        and isinstance(arg.args[0], ast.Name)
                        and arg.args[0].id in funcs
                    ):
                        bound = {kw.arg for kw in arg.keywords if kw.arg}
                        refs.append(
                            (funcs[arg.args[0].id], bound, len(arg.args) - 1)
                        )
        return refs

    # ------------------------------------------------------------------ #

    def _emit(self, rule_id: str, node: ast.AST, message: str) -> None:
        key = (rule_id, getattr(node, "lineno", 1), getattr(node, "col_offset", 0))
        if key not in self._emitted:
            self._emitted.add(key)
            if self._current_chain:
                message += format_chain(self._current_chain)
            self.findings.append(self.ctx.finding(rule_id, node, message))

    def _analyze_function(self, fn, tainted: frozenset,
                          chain: tuple[str, ...]) -> None:
        locals_ = _assigned_names(fn)
        nested = {
            n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not fn
        }
        env = set(tainted)
        self._current_chain = chain
        state = _FnState(self, fn, locals_, nested, chain)
        # pass 1: propagate taint (loops make later lines feed earlier ones);
        # pass 2: report with the stable env
        state.walk_block(fn.body, env, report=False)
        self._current_chain = chain  # a recursed nested def may have moved it
        state.walk_block(fn.body, env, report=True)

        # nested functions referenced in combinators run as device code
        # with the enclosing env visible as closure state
        for sub, exempt_names, exempt_count in self._combinator_refs(fn, nested):
            if sub is fn:
                continue
            params = _param_names(sub)
            sub_tainted = frozenset(
                p for i, p in enumerate(params)
                if i >= exempt_count and p not in exempt_names
            ) | frozenset(n for n in env if n not in _assigned_names(sub))
            key = (id(sub), sub_tainted)
            if key not in self._done:
                self._done.add(key)
                self._analyze_function(sub, sub_tainted, chain + (sub.name,))
        self._current_chain = ()


class _FnState:
    """Per-function walk: statement-ordered taint propagation + findings."""

    def __init__(self, mod: _ModuleChecker, fn, locals_, nested, chain):
        self.mod = mod
        self.fn = fn
        self.locals = locals_
        self.nested = nested
        self.chain = chain
        self.report = False

    # ------------------------------ statements ------------------------ #

    def walk_block(self, stmts, env: set, report: bool) -> None:
        self.report = report
        for stmt in stmts:
            self.walk_stmt(stmt, env)

    def walk_stmt(self, stmt, env: set) -> None:
        mod = self.mod
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs handled by the module checker
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            t = self.taint(value, env) if value is not None else False
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for target in targets:
                if isinstance(stmt, ast.AugAssign):
                    t = t or self.taint(target, env)
                self._bind(target, t, env)
        elif isinstance(stmt, ast.If):
            if self.taint(stmt.test, env) and self.report:
                mod._emit("AM201", stmt,
                          "Python-level `if` on a tensor inside a device "
                          f"program ({self.fn.name}): a hidden sync on the "
                          "card; use torch.where or decide on the host")
            for s in stmt.body + stmt.orelse:
                self.walk_stmt(s, env)
        elif isinstance(stmt, ast.While):
            if self.taint(stmt.test, env) and self.report:
                mod._emit("AM201", stmt,
                          "Python-level `while` on a tensor inside a device "
                          f"program ({self.fn.name}): a hidden sync per "
                          "iteration; bound the loop by shapes")
            for s in stmt.body + stmt.orelse:
                self.walk_stmt(s, env)
        elif isinstance(stmt, ast.Assert):
            if self.taint(stmt.test, env) and self.report:
                mod._emit("AM201", stmt,
                          "assert on a tensor inside a device program "
                          f"({self.fn.name}): a hidden sync; validate on the "
                          "host before the dispatch")
        elif isinstance(stmt, ast.For):
            if self.taint(stmt.iter, env) and self.report:
                mod._emit("AM201", stmt,
                          "Python `for` over a tensor inside a device "
                          f"program ({self.fn.name}): a sync and a launch "
                          "per element; use a batched op")
            self._bind(stmt.target, self.taint(stmt.iter, env), env)
            for s in stmt.body + stmt.orelse:
                self.walk_stmt(s, env)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self.taint(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, False, env)
            for s in stmt.body:
                self.walk_stmt(s, env)
        elif isinstance(stmt, ast.Try):
            for s in stmt.body + stmt.orelse + stmt.finalbody:
                self.walk_stmt(s, env)
            for handler in stmt.handlers:
                for s in handler.body:
                    self.walk_stmt(s, env)
        # global/nonlocal: AM204 has no meaning here (core.JAX_ONLY)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.taint(stmt.value, env)
        elif isinstance(stmt, ast.Expr):
            self.taint(stmt.value, env)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.taint(stmt.exc, env)
        # Import/Pass/Break/Continue/Delete: nothing to do

    def _bind(self, target, tainted: bool, env: set) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                env.add(target.id)
            else:
                env.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tainted, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted, env)
        # Attribute and subscript stores are allowed: in-place writes are
        # how a device program fills its outputs (AM204 is JAX only)

    # ------------------------------ expressions ------------------------ #

    def taint(self, node, env: set) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in env
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                self.taint(node.value, env)
                return False
            return self.taint(node.value, env)
        if isinstance(node, ast.Subscript):
            base = node.value
            base_t = self.taint(base, env)
            idx_t = self.taint(node.slice, env)
            return base_t or idx_t
        if isinstance(node, ast.Call):
            return self._call_taint(node, env)
        if isinstance(node, ast.BoolOp):
            parts = [self.taint(v, env) for v in node.values]
            if any(parts) and self.report:
                self.mod._emit(
                    "AM201", node,
                    "`and`/`or` coerces a tensor to bool inside a device "
                    f"program ({self.fn.name}): a hidden sync; use "
                    "torch.logical_and/or or &,|",
                )
            return any(parts)
        if isinstance(node, ast.IfExp):
            t = self.taint(node.test, env)
            if t and self.report:
                self.mod._emit(
                    "AM201", node,
                    "conditional expression on a tensor inside a device "
                    f"program ({self.fn.name}): a hidden sync; use "
                    "torch.where",
                )
            return t or self.taint(node.body, env) or self.taint(node.orelse, env)
        if isinstance(node, (ast.BinOp,)):
            return self.taint(node.left, env) | self.taint(node.right, env)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand, env)
        if isinstance(node, ast.Compare):
            t = self.taint(node.left, env)
            for comp in node.comparators:
                t |= self.taint(comp, env)
            return t
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            # every element is walked (no short circuit): each may hold a
            # finding of its own
            return any([self.taint(e, env) for e in node.elts])
        if isinstance(node, ast.Dict):
            return any([
                self.taint(x, env) for x in (node.keys + node.values) if x
            ])
        if isinstance(node, ast.Starred):
            return self.taint(node.value, env)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for sub in ast.iter_child_nodes(node):
                self.taint(sub, env)
            return False
        if isinstance(node, ast.Slice):
            return any(
                self.taint(x, env)
                for x in (node.lower, node.upper, node.step) if x
            )
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            t = False
            inner = set(env)
            for gen in node.generators:
                it = self.taint(gen.iter, inner)
                t |= it
                self._bind(gen.target, it, inner)
                for cond in gen.ifs:
                    if self.taint(cond, inner) and self.report:
                        self.mod._emit(
                            "AM201", cond,
                            "comprehension filter on a tensor inside a "
                            f"device program ({self.fn.name}): a hidden "
                            "sync per element",
                        )
            if isinstance(node, ast.DictComp):
                t |= self.taint(node.key, inner) | self.taint(node.value, inner)
            else:
                t |= self.taint(node.elt, inner)
            return t
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.taint(node.value, env)
        if isinstance(node, ast.Yield):
            return self.taint(node.value, env) if node.value else False
        return False

    def _call_taint(self, node: ast.Call, env: set) -> bool:
        mod = self.mod
        fname = dotted_name(node.func)
        arg_taints = [self.taint(a, env) for a in node.args]
        kw_taints = [self.taint(kw.value, env) for kw in node.keywords]
        args_tainted = any(arg_taints) or any(kw_taints)

        if fname in _STATIC_CALLS:
            return False
        last = fname.split(".")[-1] if fname else None
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _STATIC_METHODS
                or node.func.attr.endswith("_launch")):
            # host metadata of a tensor, or a kernel launcher's host
            # error code
            self.taint(node.func.value, env)
            return False

        # host coercions of tensors
        if fname in _COERCIONS:
            if args_tainted and self.report:
                mod._emit("AM202", node,
                          f"`{fname}()` forces a tensor to a host scalar "
                          f"inside a device program ({self.fn.name}): a "
                          "hidden sync")
            return False
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_METHODS
            and self.taint(node.func.value, env)
        ):
            if self.report:
                mod._emit("AM202", node,
                          f"`.{node.func.attr}()` copies a tensor to the "
                          f"host inside a device program ({self.fn.name}): "
                          "a hidden sync")
            return False
        # numpy on tensors
        if fname:
            root = fname.split(".")[0]
            if root in mod.np_aliases and args_tainted:
                if self.report:
                    mod._emit("AM202", node,
                              f"`{fname}` applies host numpy to a tensor "
                              f"inside a device program ({self.fn.name}): a "
                              "hidden sync and copy; use torch")
                return True
        # call into another function: propagate taint positionally.
        # Same-module defs resolve directly; everything else (from-imports,
        # module aliases, same-scan class methods) goes through the graph.
        callee = None
        if isinstance(node.func, ast.Name):
            callee = self.nested.get(node.func.id) or mod.module_funcs.get(
                node.func.id
            )
        cross = None
        if callee is None and args_tainted:
            cross = mod.resolve_cross(node)
        target = callee if callee is not None else (
            cross.node if cross is not None else None
        )
        if target is not None and target is not self.fn:
            params = _param_names(target)
            tainted_params = frozenset(
                params[i] for i, t in enumerate(arg_taints)
                if t and i < len(params)
            ) | frozenset(
                kw.arg for kw, t in zip(node.keywords, kw_taints)
                if t and kw.arg
            )
            if tainted_params:
                if callee is not None:
                    mod.coordinator.enqueue(
                        mod, callee, tainted_params,
                        self.chain + (callee.name,)
                    )
                else:
                    mod.coordinator.enqueue_info(
                        cross, tainted_params, self.chain
                    )

        func_taint = False
        if isinstance(node.func, ast.Attribute):
            func_taint = self.taint(node.func.value, env)
        return args_tainted or func_taint


# ---------------------------------------------------------------------- #
# AM203 — dtype-less tensor/array construction (module-wide scan)

def _check_dtypes(ctx: FileContext) -> list[Finding]:
    if not _imports_torch(ctx.tree):
        return []
    torch_like = _torch_aliases(ctx.tree) | {"torch"}
    np_like = _np_aliases(ctx.tree)
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func)
        if fname is None or "." not in fname:
            continue
        root, last = fname.split(".")[0], fname.split(".")[-1]
        if last not in _DTYPE_CTORS or fname.count(".") != 1:
            continue
        has_kw = any(kw.arg == "dtype" for kw in node.keywords)
        if root in torch_like:
            has_dtype = has_kw
        elif root in np_like and last in _NUMPY_DTYPE_CTORS:
            has_dtype = has_kw or len(node.args) > _DTYPE_CTORS[last]
        else:
            continue
        if not has_dtype:
            findings.append(ctx.finding(
                "AM203", node,
                f"`{fname}` without an explicit dtype: default dtypes vary "
                "(torch's int64/float32 defaults, numpy's platform int), "
                "which corrupts packed int64 opids on the device path — "
                "pin the dtype",
            ))
    return findings


def check(ctxs: list[FileContext], graph=None) -> list[Finding]:
    findings = _Coordinator(ctxs, graph).run()
    for ctx in ctxs:
        findings += _check_dtypes(ctx)
    return findings

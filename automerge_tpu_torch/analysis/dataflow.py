"""Dynamic-length dataflow for the AM70x shape-stability family.

The runtime observatory (obs/prof.py) can only report a recompile storm
*after* the fact: ``prof.recompile.storm`` fires when one program sees 4
compiles (new shape buckets) inside 10 seconds. The static twin
asks the question before any dispatch happens: does an array argument's
shape derive from an **unbucketed dynamic length**?

The engine below runs per function and tracks, statement-ordered with a
two-pass fixpoint (so loop-carried flows converge), which local names are
*length-tainted*:

- **sources**: ``len(x)``, ``.shape`` / ``.shape[i]`` reads — the host
  integers that vary call-to-call;
- **propagation**: arithmetic, ``max``/``min``, tuple/list packing,
  subscripts of tainted containers; slicing with a tainted bound produces
  a tainted *array* (its leading dimension now varies), and array
  constructors (``zeros``/``ones``/``empty``/``full``/``arange``/
  ``concatenate``/``pad``...) called with a tainted shape argument produce
  tainted arrays;
- **sanitizers**: any call whose leaf name mentions ``pow2`` or ``bucket``
  (the in-tree helpers are ``_pow2``/``_next_pow2``/``bucket_index``)
  returns a *clean* value whatever its arguments — rounding a length to a
  power-of-two bucket is exactly the discipline that caps the compile
  count at log2(maxlen) per program;
- **sinks**: calls to known dispatch callables (discovered by
  shaperules.py: ``@profiled_program``-decorated defs, ``x =
  profiled_program("name")(f)`` bindings, from-imports the call graph
  resolves to either, and the engine's ``_dispatch(prog, ...)`` funnel).
  A tainted argument at a sink is the finding.

Taint values carry a provenance chain (``len(rows) @ line 12 -> cols @
line 14``) so the diagnostic shows the actual dataflow path, mirroring the
``[reachable via ...]`` chains the call-graph rules print.
"""
from __future__ import annotations

import ast

from .core import dotted_name

#: array constructors whose result's shape is its (possibly tainted)
#: arguments — the hop from a dynamic *integer* to a dynamic *array shape*
_ARRAY_CTORS = frozenset({
    "zeros", "ones", "empty", "full", "array", "arange", "linspace",
    "concatenate", "stack", "pad", "tile", "repeat", "broadcast_to",
    "reshape", "resize",
    # torch's spellings
    "tensor", "as_tensor", "from_numpy", "cat", "new_zeros", "new_full",
    "new_empty", "expand", "view",
})

#: provenance chains are capped: past this depth the path is noise
_MAX_CHAIN = 6


def is_sanitizer(name: str | None) -> bool:
    """A call that rounds a dynamic length onto a static bucket grid."""
    if not name:
        return False
    leaf = name.rsplit(".", 1)[-1].lower()
    return "pow2" in leaf or "bucket" in leaf


class ShapeFlow:
    """Length-taint walk over one function body.

    ``dispatch`` maps a *call* AST node predicate onto a program label:
    ``dispatch(call_node) -> str | None`` (None = not a dispatch).
    ``report(call_node, program, chain)`` receives each sink hit; it is
    only invoked on the second (reporting) pass.
    """

    def __init__(self, fn: ast.AST, dispatch, report):
        self.fn = fn
        self.dispatch = dispatch
        self.report = report
        self.env: dict[str, tuple[str, ...]] = {}
        self.reporting = False

    def run(self) -> None:
        body = getattr(self.fn, "body", None) or []
        self.reporting = False
        for stmt in body:
            self._stmt(stmt)
        self.reporting = True
        for stmt in body:
            self._stmt(stmt)

    # ------------------------------ statements ------------------------ #

    def _stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs get their own ShapeFlow
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(stmt, "value", None)
            chain = self._expr(value) if value is not None else None
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for target in targets:
                if isinstance(stmt, ast.AugAssign) and chain is None:
                    chain = self._expr(target)
                self._bind(target, chain, stmt.lineno)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.For):
            # iterating a container does not make the element a length
            self._expr(stmt.iter)
            self._bind(stmt.target, None, stmt.lineno)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, None, stmt.lineno)
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for s in stmt.body + stmt.orelse + stmt.finalbody:
                self._stmt(s)
            for handler in stmt.handlers:
                for s in handler.body:
                    self._stmt(s)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if getattr(stmt, "value", None) is not None:
                self._expr(stmt.value)
            return
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._expr(stmt.exc)
            return
        # Import/Pass/Break/Continue/Delete/Global: nothing flows

    def _bind(self, target: ast.AST, chain, lineno: int) -> None:
        if isinstance(target, ast.Name):
            if chain is not None:
                step = f"{target.id} @ line {lineno}"
                self.env[target.id] = self._extend(chain, step)
            else:
                self.env.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, chain, lineno)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, chain, lineno)
        # attribute/subscript stores: out of scope for a per-function walk

    @staticmethod
    def _extend(chain: tuple[str, ...], step: str) -> tuple[str, ...]:
        if chain and chain[-1] == step:
            return chain
        if len(chain) >= _MAX_CHAIN:
            return chain
        return chain + (step,)

    # ------------------------------ expressions ------------------------ #

    def _expr(self, node: ast.AST | None) -> tuple[str, ...] | None:
        """Returns the provenance chain if this expression is
        length-tainted, else None. Walks every subexpression so sinks
        nested anywhere (``outs.append(prog(x))``) are still seen."""
        if node is None or isinstance(node, ast.Constant):
            return None
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value)
            if node.attr == "shape":
                src = ast.unparse(node) if hasattr(ast, "unparse") else ".shape"
                return (f"{src} @ line {node.lineno}",)
            return base
        if isinstance(node, ast.Subscript):
            base = self._expr(node.value)
            idx = self._expr(node.slice)
            if isinstance(node.slice, ast.Slice):
                bounds = [b for b in (node.slice.lower, node.slice.upper,
                                      node.slice.step) if b is not None]
                for b in bounds:
                    t = self._expr(b)
                    if t is not None:
                        # a slice bounded by a dynamic length yields an
                        # array whose leading dim varies per call
                        return self._extend(
                            t, f"slice @ line {node.lineno}"
                        )
                return base
            return base or idx
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            return self._expr(node.left) or self._expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.BoolOp):
            out = None
            for v in node.values:
                out = out or self._expr(v)
            return out
        if isinstance(node, ast.Compare):
            self._expr(node.left)
            for comp in node.comparators:
                self._expr(comp)
            return None  # a comparison result is a bool, not a length
        if isinstance(node, ast.IfExp):
            self._expr(node.test)
            return self._expr(node.body) or self._expr(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            out = None
            for elt in node.elts:
                out = out or self._expr(elt)
            return out
        if isinstance(node, ast.Dict):
            out = None
            for x in node.keys + node.values:
                if x is not None:
                    out = out or self._expr(x)
            return out
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for sub in ast.iter_child_nodes(node):
                self._expr(sub)
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self._expr(gen.iter)
                for cond in gen.ifs:
                    self._expr(cond)
            if isinstance(node, ast.DictComp):
                self._expr(node.key)
                self._expr(node.value)
            else:
                self._expr(node.elt)
            return None
        if isinstance(node, ast.Slice):
            for x in (node.lower, node.upper, node.step):
                if x is not None:
                    self._expr(x)
            return None
        if isinstance(node, (ast.Await, ast.Yield, ast.YieldFrom)):
            value = getattr(node, "value", None)
            return self._expr(value) if value is not None else None
        return None

    def _call(self, node: ast.Call) -> tuple[str, ...] | None:
        name = dotted_name(node.func)
        leaf = name.rsplit(".", 1)[-1] if name else None

        arg_chains = [self._expr(a) for a in node.args]
        kw_chains = [self._expr(kw.value) for kw in node.keywords]
        tainted = next(
            (c for c in arg_chains + kw_chains if c is not None), None
        )

        # sink: a program dispatch fed a length-tainted argument
        program = self.dispatch(node)
        if program is not None:
            if tainted is not None and self.reporting:
                self.report(node, program, tainted)
            return None

        # sanitizer: bucketing helpers return statically stable lengths
        if is_sanitizer(name):
            return None

        # source: len() of anything is a per-call dynamic length
        if leaf == "len" and name == "len":
            src = ast.unparse(node) if hasattr(ast, "unparse") else "len(...)"
            return (f"{src} @ line {node.lineno}",)

        # array constructors: dynamic length becomes dynamic shape
        if leaf in _ARRAY_CTORS and tainted is not None:
            return self._extend(
                tainted, f"{name}(...) @ line {node.lineno}"
            )

        # max/min/abs/sum and plain arithmetic helpers propagate
        if leaf in ("max", "min", "abs", "sum", "int") and tainted is not None:
            return tainted

        # method on a tainted receiver stays tainted (n.bit_length(), ...)
        if isinstance(node.func, ast.Attribute):
            recv = self._expr(node.func.value)
            if recv is not None:
                return recv
        return None

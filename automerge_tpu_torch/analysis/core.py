"""amlint core: file model, suppression parsing, findings, const evaluation.

The port's copy of the JAX package's analyzer (``automerge_tpu/analysis``),
keyed on this package: it knows the port's invariants (the merge-key bit
layout, the hidden syncs a device program must not take, the host/device
module split) and enforces them over the AST. Everything here is
stdlib-only — importing the analysis package must never pull in torch or
jax, so the lint gate runs in any environment (CI, pre-commit, a bare
host) without device initialisation.

Suppression syntax (checked by tests/test_torch_analysis.py):

    x = (ctr << 20) | actor  # amlint: disable=AM102
    # amlint: disable=AM103 — value payloads are never packed into keys
    self.values = _Interner()
    # amlint: disable-file=AM203

A trailing comment suppresses its own line; a standalone comment suppresses
the next code line; ``disable-file`` suppresses a rule for the whole file.
``# amlint: host-only`` marks a module as host-only for AM301.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

#: the package whose modules the package-keyed rules read (graph module
#: names, the host-only layer, the metric catalog's scope)
PACKAGE = "automerge_tpu_torch"

#: rule id -> (family, one-line summary). The single catalog the CLI,
#: README and tests key off. The IDs are the JAX package's; where a rule
#: names a JAX construct, the summary gives its meaning here.
RULES: dict[str, tuple[str, str]] = {
    "AM000": ("core", "file could not be parsed (syntax/tokenize error)"),
    "AM101": ("packing", "bit-layout constants are inconsistent with the "
                         "canonical merge-key layout (slot<<44 | ctr<<20 | actor)"),
    "AM102": ("packing", "magic shift/mask literal duplicates a canonical "
                         "bit-layout constant (use ACTOR_BITS/_OP_BITS/...)"),
    "AM103": ("packing", "_Interner constructed without a max_size packing cap"),
    "AM104": ("packing", "packing-limit diagnostic names the wrong range "
                         "(merge-key vs rank-kernel)"),
    "AM105": ("hotpath", "per-row Python in a profiled hot phase: "
                         "sort(key=lambda ...) or int()/bool() coercion "
                         "over range-indexed rows (use column ops and a "
                         "precomputed sort-key column)"),
    "AM106": ("hotpath", "per-byte Python decode loop in a decode hot-path "
                         "module (vectorize: continuation-bit mask + "
                         "prefix scan, record-level run expansion)"),
    "AM107": ("hotpath", "per-change/per-op Python loop in a gate/transcode "
                         "hot path (compute gate verdicts and op columns "
                         "with batched column programs; scalar-oracle "
                         "loops carry justified suppressions)"),
    "AM201": ("tracer", "Python-level control flow on a tensor inside a "
                        "device program (@profiled_program) or a kernel "
                        "wrapper: a hidden sync on the card"),
    "AM202": ("tracer", "host call (.item()/.tolist()/.cpu()/.numpy(), "
                        "int()/float()/bool(), np.*) on a tensor inside a "
                        "device program or a kernel wrapper: a hidden sync "
                        "on the card"),
    "AM203": ("tracer", "dtype-less torch.tensor/as_tensor/zeros/ones/full/"
                        "empty/arange (or the numpy form) in a "
                        "device-adjacent module"),
    "AM204": ("tracer", "JAX only: mutation of captured host state inside "
                        "jit/pallas-traced code"),
    "AM301": ("boundary", "host-only module imports the device layer "
                          "(torch, automerge_tpu_torch.tpu)"),
    "AM302": ("boundary", "hidden host synchronisation (torch.cuda."
                          "synchronize, .cpu()/.numpy()/.item(), ...) inside "
                          "a device PhaseProfile phase"),
    "AM303": ("boundary", "JAX only: metric/span recording call inside "
                          "jit/vmap/Pallas-reachable code"),
    "AM304": ("boundary", "metric/event name recorded in code is missing "
                          "from the README catalog, or a catalog row names "
                          "nothing the code records (the observability "
                          "contract must stay exact in both directions)"),
    "AM305": ("boundary", "worker-executed module reaches the telemetry "
                          "exposition/fan-in layer (get_flight, obs.export: "
                          "render_exposition/serve_exposition/"
                          "snapshot_record/SnapshotWriter) — worker "
                          "telemetry leaves the process only through the "
                          "shipping buffer: pipe deltas, shipped flight "
                          "tails and the black-box file"),
    "AM306": ("boundary", "a kernels.load(...) library's *_launch symbol "
                          "called outside a kernel.* profiled_program "
                          "wrapper (the launch bypasses the observatory; "
                          "justify exceptions with `# amlint: "
                          "unprofiled-jit`)"),
    "AM401": ("taxonomy","bare ValueError/TypeError raised in a data-plane "
                          "module (raise a classifiable taxonomy error from "
                          "automerge_tpu_torch.errors)"),
    "AM402": ("taxonomy", "direct wall-clock/sleep/global-RNG call "
                          "(time.time/time.sleep/random.*) in a sync "
                          "data-plane module (inject a clock/RNG instead)"),
    "AM403": ("serve", "blocking call (time.sleep, bare socket, synchronous "
                       "device readbacks: torch.cuda.synchronize, .cpu()/"
                       ".numpy()/.item()) in serve/ event-loop code (the "
                       "loop must stay non-blocking; justify "
                       "dispatch-point suppressions)"),
    "AM404": ("taxonomy", "non-taxonomy exception class raised in a sync v2 "
                          "wire-codec module (sync_v2/tpu.fingerprint or "
                          "`# amlint: v2-wire-codec`) — the session layer's "
                          "negotiated fallback catches exactly the "
                          "automerge_tpu_torch.errors taxonomy, so any other "
                          "class "
                          "kills the channel instead of downgrading it to v1"),
    "AM501": ("mesh", "dense per-doc `for ... in range(...)` statement loop "
                      "in a mesh routing/merge-result path (build sparse "
                      "active lists with comprehensions or vectorize with "
                      "numpy)"),
    "AM502": ("mesh", "worker-executed module imports the mesh controller "
                      "layer (meshfarm/serve) or touches a process-global "
                      "registry accessor (get_metrics/get_flight/...) — "
                      "workers speak the pipe protocol and record into "
                      "explicitly shipped sinks"),
    "AM503": ("protocol", "controller/worker pipe frames drift: an op is "
                          "sent without a worker handler (or handled but "
                          "never sent), a response/request tuple is built "
                          "or unpacked at the wrong arity (responses are "
                          "(status, payload, metrics_delta, flight_events) "
                          "4-tuples, requests (op, payload) 2-tuples), or "
                          "a response field is read that no worker-side "
                          "producer writes"),
    "AM504": ("protocol", "pickle.dumps/pickle.dump in an shm data-plane "
                          "module (parallel/shm.py or `# amlint: "
                          "mesh-data-plane`) — bulk column payloads ride "
                          "the shared-memory rings struct-framed, never "
                          "pickle; the pickle parity-oracle transport is "
                          "the one justified suppression"),
    "AM601": ("store", "bare write-mode open()/os.write in a durability-"
                       "plane module (store/ or `# amlint: durability-"
                       "plane`) — durable bytes go through "
                       "store.atomic.atomic_write or the WAL's checksummed "
                       "appender so recovery can prove the commit point; "
                       "justify raw handles with a suppression"),
    "AM701": ("shape", "profiled_program/_dispatch site fed a tensor whose "
                       "shape derives from an unbucketed dynamic length "
                       "(len()/.shape/dynamic slice with no pow2/bucket "
                       "helper on the dataflow path) — the static twin of "
                       "the observatory's prof.recompile.storm: every new "
                       "shape bucket counts as a compile"),
}

#: rules that keep their ID in the catalog but have no meaning here, with
#: the reason: eager PyTorch reruns Python on every call, so nothing runs
#: once at trace time and goes stale. They never fire.
JAX_ONLY: dict[str, str] = {
    "AM204": "eager PyTorch reruns Python on every call: a host-state "
             "mutation in a device program runs per call, not once at "
             "trace time",
    "AM303": "eager PyTorch reruns Python on every call: a metric recorded "
             "in a device program counts every call, not the trace",
}

_SUPPRESS_RE = re.compile(
    r"#\s*amlint:\s*(disable|disable-file)\s*=\s*([A-Z0-9,\s]+)"
)


class UsageError(Exception):
    """Operator error (unknown rule id, unreadable path): the CLI prints
    one line and exits 2 — never a traceback, never conflated with the
    exit-1 'findings exist' outcome."""
_HOST_ONLY_RE = re.compile(r"#\s*amlint:\s*host-only")
_HOT_PATH_RE = re.compile(r"#\s*amlint:\s*hot-path")
#: justified observatory bypass: suppresses AM306 on its line (trailing)
#: or the next code line (standalone), like a disable=AM306
_UNPROFILED_JIT_RE = re.compile(r"#\s*amlint:\s*unprofiled-jit\b")


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    rule_id: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}{tag}"


class FileContext:
    """One parsed source file plus its amlint comment directives."""

    def __init__(self, path: Path, display: str):
        self.path = path
        self.display = display
        self.source = path.read_text(encoding="utf-8")
        self.tree = ast.parse(self.source, filename=str(path))
        # parent links for rules that need enclosing-statement context
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._amlint_parent = node  # type: ignore[attr-defined]
        self.line_suppress: dict[int, set[str]] = {}
        self.file_suppress: set[str] = set()
        self.host_only_marker = False
        self.hot_path_marker = False
        #: (line, id) pairs for disable directives naming ids not in RULES
        #: — a typo'd suppression silently un-suppresses, so the CLI treats
        #: these as usage errors (exit 2)
        self.unknown_suppressions: list[tuple[int, str]] = []
        self._parse_comments()

    # ------------------------------------------------------------------ #

    def _parse_comments(self) -> None:
        code_lines: set[int] = set()
        comments: list[tuple[int, bool, str]] = []  # (line, standalone, text)
        line_has_code: dict[int, bool] = {}
        reader = io.StringIO(self.source).readline
        for tok in tokenize.generate_tokens(reader):
            if tok.type == tokenize.COMMENT:
                standalone = not line_has_code.get(tok.start[0], False)
                comments.append((tok.start[0], standalone, tok.string))
            elif tok.type not in (
                tokenize.NL,
                tokenize.NEWLINE,
                tokenize.INDENT,
                tokenize.DEDENT,
                tokenize.ENDMARKER,
                tokenize.ENCODING,
            ):
                line_has_code[tok.start[0]] = True
                code_lines.add(tok.start[0])

        sorted_code = sorted(code_lines)
        for line, standalone, text in comments:
            if _HOST_ONLY_RE.search(text):
                self.host_only_marker = True
            if _HOT_PATH_RE.search(text):
                self.hot_path_marker = True
            m = _SUPPRESS_RE.search(text)
            ids: set[str] = set()
            kind = None
            if m:
                ids = {p.strip() for p in m.group(2).split(",") if p.strip()}
                kind = m.group(1)
                for rid in sorted(ids):
                    if rid not in RULES:
                        self.unknown_suppressions.append((line, rid))
            if _UNPROFILED_JIT_RE.search(text):
                ids.add("AM306")
                kind = kind or "disable"
            if not ids:
                continue
            if kind == "disable-file":
                self.file_suppress |= ids
            elif standalone:
                target = next((c for c in sorted_code if c > line), None)
                if target is not None:
                    self.line_suppress.setdefault(target, set()).update(ids)
            else:
                self.line_suppress.setdefault(line, set()).update(ids)

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        if rule_id in self.file_suppress:
            return True
        return rule_id in self.line_suppress.get(line, set())

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule_id,
            self.display,
            line,
            col,
            message,
            suppressed=self.is_suppressed(rule_id, line),
        )


# ---------------------------------------------------------------------- #
# constant evaluation (packing-layout extraction)

class NotConst(Exception):
    """Expression is not statically evaluable to an int."""


_BIN_OPS = {
    ast.LShift: lambda a, b: a << b,
    ast.RShift: lambda a, b: a >> b,
    ast.BitOr: lambda a, b: a | b,
    ast.BitAnd: lambda a, b: a & b,
    ast.BitXor: lambda a, b: a ^ b,
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Pow: lambda a, b: a ** b,
}

_IINFO = {
    "int8": (-(1 << 7), (1 << 7) - 1),
    "int16": (-(1 << 15), (1 << 15) - 1),
    "int32": (-(1 << 31), (1 << 31) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1),
    "uint8": (0, (1 << 8) - 1),
    "uint16": (0, (1 << 16) - 1),
    "uint32": (0, (1 << 32) - 1),
    "uint64": (0, (1 << 64) - 1),
}


def eval_const(node: ast.AST, env: dict[str, int]) -> int:
    """Evaluates a module-level constant expression: int literals, names of
    previously evaluated constants, bitwise/arithmetic operators, and the
    ``torch.iinfo(torch.int32).max`` / ``np.iinfo`` idiom."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(node.value, int):
            raise NotConst(node)
        return node.value
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise NotConst(node)
    if isinstance(node, ast.BinOp):
        fn = _BIN_OPS.get(type(node.op))
        if fn is None:
            raise NotConst(node)
        return fn(eval_const(node.left, env), eval_const(node.right, env))
    if isinstance(node, ast.UnaryOp):
        v = eval_const(node.operand, env)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.Invert):
            return ~v
        if isinstance(node.op, ast.UAdd):
            return v
        raise NotConst(node)
    if isinstance(node, ast.Attribute) and node.attr in ("max", "min"):
        # torch.iinfo(torch.int32).max / np.iinfo(np.int64).min
        call = node.value
        if (
            isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "iinfo"
            and len(call.args) == 1
            and isinstance(call.args[0], ast.Attribute)
            and call.args[0].attr in _IINFO
        ):
            lo, hi = _IINFO[call.args[0].attr]
            return hi if node.attr == "max" else lo
    raise NotConst(node)


def module_constants(tree: ast.Module) -> dict[str, tuple[int, int]]:
    """Extracts statically evaluable module-level int constants.

    Returns {name: (value, lineno)}; assignments that cannot be evaluated
    are skipped (the env still accumulates, so later constants may refer to
    earlier ones)."""
    env: dict[str, int] = {}
    out: dict[str, tuple[int, int]] = {}
    for stmt in tree.body:
        targets: list[ast.expr] = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        for target in targets:
            if not isinstance(target, ast.Name):
                continue
            try:
                v = eval_const(value, env)
            except NotConst:
                continue
            env[target.id] = v
            out[target.id] = (v, stmt.lineno)
    return out


# ---------------------------------------------------------------------- #
# helpers shared by the rule modules

def dotted_name(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def static_str_parts(node: ast.AST) -> str:
    """Concatenation of every statically known string fragment in an
    expression (Constant strings and the literal parts of f-strings)."""
    parts: list[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            parts.append(sub.value)
    return "".join(parts)


def collect_files(paths: list[Path]) -> list[tuple[Path, str]]:
    """Expands files/directories into (path, display) pairs, sorted for
    deterministic reports. Hidden dirs and __pycache__ are skipped."""
    seen: dict[Path, str] = {}
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            seen[p.resolve()] = str(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if any(
                    part.startswith(".") or part == "__pycache__"
                    for part in f.parts
                ):
                    continue
                seen[f.resolve()] = str(f)
    return sorted(seen.items(), key=lambda kv: kv[1])

"""amprof — the device-program observatory and memory sampler.

The port's own copy of the JAX package's ``obs/prof.py``. Three pieces
live here:

- :class:`ProfiledProgram` / :class:`Observatory` — every device program
  of the tpu layer, and each CUDA kernel wrapper, registers under a stable
  name (``tpu/jitprof.py``'s ``profiled_program``; the JAX program's name
  where there is one). Each dispatch through a profiled program records
  per-program dispatch counts, dispatch-latency histograms, compile counts
  and compile wall time, plus the shape-bucket signature that triggered
  each compile. Recompile flight events carry program identity, and a
  storm detector (>= ``storm_compiles`` compiles of ONE program inside
  ``storm_window_s``) emits ``prof.recompile.storm`` with the offending
  bucket sequence.

  What a "compile" is here: PyTorch runs these programs eagerly, with no
  tracing cache to probe, so a compile is the first dispatch of a program
  at a shape bucket it has not dispatched before (``shape_bucket``: the
  sorted shapes of its tensor arguments). A JAX recompile is exactly such
  a new bucket, and the engine's pow2 widths exist to bound their count,
  so a storm keeps its meaning of shape churn. ``cache_size()`` is the
  count of buckets seen. The buckets are computed only on the
  instrumented path (observatory or metrics on); like a jit cache they
  survive ``reset()``. Building a CUDA source with ``nvcc``
  (``kernels.py``) is not a compile of a program. Dispatch latency is
  on the host clock: for a program on the card it is the time to enqueue
  its work, as no dispatch synchronises.
- :class:`Sampler` — point-in-time snapshots of slab pages
  (allocated/free/occupancy/fragmentation), DecodeCache pinned bytes and
  cached ``_ChangeCols`` column bytes, exported as ``prof.mem.*`` gauges.
  Everything is cast to plain ``int``/``float`` before it enters a
  sample dict (np.int64 stringifies under ``json.dumps(default=str)``).
- the module-level observatory singleton (:func:`get_observatory`),
  disabled by default with the same one-attribute hot-path guard as the
  metrics registry: a dispatch through a disabled observatory costs one
  attribute read and a branch.

Like the rest of obs/, this module is import-light: no torch, no tpu
imports (it inspects engine/farm objects duck-typed and reaches this
package's codecs via ``sys.modules`` so importing obs never initialises
the device layer).
"""
# amlint: host-only
from __future__ import annotations

import sys
import time
from collections import deque

from .flight import get_flight
from .metrics import get_metrics

#: compiles of one program inside the window that constitute a storm
STORM_COMPILES = 4
#: storm detector window (seconds, on the injected clock)
STORM_WINDOW_S = 10.0
#: shape buckets retained per program (newest last)
RECENT_BUCKETS = 8
#: the module whose DecodeCache the Sampler reads (this package's own)
CODECS_MODULE = "automerge_tpu_torch.codecs"


def shape_bucket(args, kwargs):
    """The shape signature of a call: sorted, deduplicated shape tuples of
    every array-like leaf in ``(args, kwargs)`` (tensors, ``torch.Size``
    shapes read as tuples). Stdlib-only (NamedTuples like SlabState
    traverse as tuples), so the observatory never imports torch."""
    shapes = set()
    stack = [args, kwargs]
    while stack:
        node = stack.pop()
        shape = getattr(node, "shape", None)
        if shape is not None:
            shapes.add(tuple(int(d) for d in shape))
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    return sorted(shapes)


class ProfiledProgram:
    """One named device program plus its dispatch/compile tallies.

    Calling the wrapper with the observatory disabled falls straight
    through to the function (one attribute read, one branch).
    ``call_profiled`` is the instrumented path used by both the wrapper
    itself and ``engine._dispatch`` (which layers the engine-wide
    hit/recompile counters on top of the returned growth)."""

    __slots__ = ("name", "fn", "_obs", "compiles", "dispatches",
                 "compile_s", "dispatch_s", "recent_buckets",
                 "_storm_times", "_m", "_seen")

    def __init__(self, name, fn, observatory):
        self.name = name
        self.fn = fn
        self._obs = observatory
        self.compiles = 0
        self.dispatches = 0
        self.compile_s = 0.0
        self.dispatch_s = 0.0
        self.recent_buckets = deque(maxlen=RECENT_BUCKETS)
        self._storm_times = deque()
        self._m = None
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        if not self._obs.enabled:
            return self.fn(*args, **kwargs)
        out, _grew, _dt = self.call_profiled(args, kwargs)
        return out

    def cache_size(self) -> int:
        """Shape buckets this program has dispatched on the instrumented
        path (the torch meaning of a jit cache entry)."""
        return len(self._seen)

    def _instruments(self):
        m = self._m
        if m is None:
            reg = self._obs.registry
            name = self.name
            m = (
                reg.counter(f"prof.program.{name}.compiles",
                            "first dispatches at a new shape bucket"),
                reg.counter(f"prof.program.{name}.dispatches",
                            "dispatches through this program"),
                reg.histogram(f"prof.program.{name}.compile_ms",
                              "wall time of dispatches that compiled"),
                reg.histogram(f"prof.program.{name}.dispatch_ms",
                              "per-dispatch wall time"),
            )
            self._m = m
        return m

    def call_profiled(self, args, kwargs):
        """Dispatches with full accounting; returns ``(out, grew, dt)``
        where ``grew`` is 1 when the call's shape bucket is new to this
        program (a compile), else 0, and ``dt`` the dispatch wall time on
        the observatory clock."""
        obs = self._obs
        clock = obs.clock
        bucket = shape_bucket(args, kwargs)
        t0 = clock()
        out = self.fn(*args, **kwargs)
        dt = clock() - t0
        key = tuple(bucket)
        grew = 0 if key in self._seen else 1
        if grew:
            self._seen.add(key)
            after = len(self._seen)
            self.recent_buckets.append(bucket)
            flight = obs.flight
            if flight.enabled:
                flight.record(
                    "engine.recompile",
                    program=self.name,
                    fn=getattr(self.fn, "__name__", self.name),
                    shapes=bucket,
                    cache_size=after,
                )
            obs._note_compiles(self, grew)
        if obs.enabled:
            self.dispatches += 1
            self.dispatch_s += dt
            m_compiles, m_dispatches, m_compile_ms, m_dispatch_ms = (
                self._instruments())
            m_dispatches.inc()
            m_dispatch_ms.observe(dt * 1000.0)
            if grew > 0:
                self.compiles += grew
                self.compile_s += dt
                m_compiles.inc(grew)
                m_compile_ms.observe(dt * 1000.0)
        return out, grew, dt

    def stats(self) -> dict:
        return {
            "compiles": int(self.compiles),
            "dispatches": int(self.dispatches),
            "compile_ms": round(self.compile_s * 1000.0, 3),
            "dispatch_ms": round(self.dispatch_s * 1000.0, 3),
            "cache_size": self.cache_size(),
            "buckets": [
                [list(shape) for shape in bucket]
                for bucket in self.recent_buckets
            ],
        }

    def reset(self) -> None:
        """Zeroes the tallies; the buckets seen stay, as a jit cache
        outlives a reset of the JAX package's tallies."""
        self.compiles = 0
        self.dispatches = 0
        self.compile_s = 0.0
        self.dispatch_s = 0.0
        self.recent_buckets.clear()
        self._storm_times.clear()


class Observatory:
    """Registry of named :class:`ProfiledProgram` wrappers plus the
    recompile-storm detector. Disabled by default; enabling is a single
    flag flip (programs read it per dispatch)."""

    def __init__(self, registry=None, flight=None, clock=None,
                 storm_compiles: int = STORM_COMPILES,
                 storm_window_s: float = STORM_WINDOW_S):
        self.enabled = False
        self.registry = registry if registry is not None else get_metrics()
        self.flight = flight if flight is not None else get_flight()
        self.clock = clock if clock is not None else time.monotonic
        self.storm_compiles = storm_compiles
        self.storm_window_s = storm_window_s
        self._programs: dict = {}

    def register(self, name: str, fn) -> ProfiledProgram:
        """Wraps ``fn`` as a named profiled program. Re-registering a name
        (module reload) rebinds the callable but keeps the tallies."""
        prog = self._programs.get(name)
        if prog is None:
            prog = ProfiledProgram(name, fn, self)
            self._programs[name] = prog
        else:
            prog.fn = fn
        return prog

    def alias(self, name: str, prog: ProfiledProgram) -> ProfiledProgram:
        """Binds a second name to a registered program: the table lists
        its tallies under both names, each dispatch is counted once, and
        its metrics family keeps the program's own name."""
        self._programs[name] = prog
        return prog

    def program(self, name: str):
        return self._programs.get(name)

    def programs(self) -> dict:
        return dict(self._programs)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        for prog in self._programs.values():
            prog.reset()

    def table(self) -> dict:
        """``{program name: stats dict}`` for every registered program
        that has been dispatched at least once (plain ints/floats)."""
        return {
            name: prog.stats()
            for name, prog in sorted(self._programs.items())
            if prog.dispatches or prog.compiles
        }

    def _note_compiles(self, prog: ProfiledProgram, grew: int) -> None:
        """Feeds the storm detector: ``grew`` compiles of ``prog`` landed
        now. Fires ``prof.recompile.storm`` once per storm, then re-arms."""
        now = self.clock()
        times = prog._storm_times
        for _ in range(grew):
            times.append(now)
        horizon = now - self.storm_window_s
        while times and times[0] < horizon:
            times.popleft()
        if len(times) >= self.storm_compiles:
            flight = self.flight
            if flight.enabled:
                flight.record(
                    "prof.recompile.storm",
                    program=prog.name,
                    compiles=len(times),
                    window_s=self.storm_window_s,
                    buckets=[
                        [list(shape) for shape in bucket]
                        for bucket in prog.recent_buckets
                    ],
                )
            times.clear()


_GLOBAL = Observatory()


def get_observatory() -> Observatory:
    """The process-wide observatory (one per process; workers ship their
    per-program counters through the existing metrics-delta pipe)."""
    return _GLOBAL


class enabled_observatory:
    """Context manager: enables the observatory (and restores the prior
    state on exit). Program tallies are NOT reset — call
    ``get_observatory().reset()`` for a clean slate."""

    def __init__(self, observatory: Observatory | None = None):
        self._obs = observatory if observatory is not None else _GLOBAL
        self._was = False

    def __enter__(self) -> Observatory:
        self._was = self._obs.enabled
        self._obs.enable()
        return self._obs

    def __exit__(self, *exc) -> None:
        self._obs.enabled = self._was


def _longest_free_run(free_pages) -> int:
    """Longest run of consecutive page ids in the free list (the largest
    allocation the slab can satisfy contiguously)."""
    if not free_pages:
        return 0
    ids = sorted(set(int(p) for p in free_pages))
    best = run = 1
    for prev, cur in zip(ids, ids[1:]):
        run = run + 1 if cur == prev + 1 else 1
        if run > best:
            best = run
    return best


class Sampler:
    """Point-in-time memory/occupancy snapshots of a farm or engine.

    ``sample(farm=...)`` (or ``engine=...``) duck-types its way around the
    device layer: slab pages come from ``engine.pages`` (a PageAllocator),
    row occupancy from ``engine.lengths``, cached change columns from
    ``farm._cols_cache`` (entries with an ``.arr`` ndarray), and
    DecodeCache pinned bytes from ``automerge_tpu_torch.codecs`` IF that module
    is already imported (``sys.modules`` probe — sampling never imports
    the device layer). Every value is cast to plain int/float before it
    enters the sample dict or a gauge, so samples survive
    ``json.dumps`` without np.int64 stringification."""

    def __init__(self, registry=None, clock=None, keep: int = 256):
        self.registry = registry if registry is not None else get_metrics()
        self.clock = clock if clock is not None else time.monotonic
        self.samples = deque(maxlen=keep)
        reg = self.registry
        self._g_allocated = reg.gauge(
            "prof.mem.pages.allocated", "slab pages owned by documents")
        self._g_free = reg.gauge(
            "prof.mem.pages.free", "slab pages on the free list")
        self._g_occupancy = reg.gauge(
            "prof.mem.pages.occupancy",
            "live rows / allocated page capacity")
        self._g_fragmentation = reg.gauge(
            "prof.mem.pages.fragmentation",
            "1 - longest contiguous free run / free pages")
        self._g_decode_bytes = reg.gauge(
            "prof.mem.decode_cache.bytes",
            "chunk bytes pinned across DecodeCache instances")
        self._g_cols_bytes = reg.gauge(
            "prof.mem.change_cols.bytes",
            "ndarray bytes held by cached change columns")
        self._g_cols_entries = reg.gauge(
            "prof.mem.change_cols.entries",
            "cached change-column entries (incl. uncacheable sentinels)")

    def sample(self, farm=None, engine=None) -> dict:
        """Takes one snapshot, updates the ``prof.mem.*`` gauges, appends
        to the bounded ring, and returns the sample dict."""
        if engine is None and farm is not None:
            engine = getattr(farm, "engine", None)
        out = {"t": float(self.clock())}

        pages = getattr(engine, "pages", None)
        if pages is not None:
            allocated = int(pages.allocated)
            free = int(pages.free_count)
            page_size = int(pages.page_size)
            rows = 0
            lengths = getattr(engine, "lengths", None)
            if lengths is not None:
                rows = int(sum(int(n) for n in lengths))
            capacity = allocated * page_size
            occupancy = (rows / capacity) if capacity else 0.0
            run = _longest_free_run(getattr(pages, "_free", ()))
            fragmentation = (1.0 - run / free) if free else 0.0
            out.update(
                pages_allocated=allocated,
                pages_free=free,
                page_size=page_size,
                rows=rows,
                occupancy=round(occupancy, 4),
                fragmentation=round(fragmentation, 4),
            )
            self._g_allocated.set(allocated)
            self._g_free.set(free)
            self._g_occupancy.set(occupancy)
            self._g_fragmentation.set(fragmentation)

        # this package's codecs, never the JAX package's: both may be
        # loaded in one process, each with its own DecodeCache
        codecs = sys.modules.get(CODECS_MODULE)
        if codecs is not None:
            decode_bytes = int(sum(
                int(v) for v in codecs.DecodeCache._name_bytes.values()))
            out["decode_cache_bytes"] = decode_bytes
            self._g_decode_bytes.set(decode_bytes)

        cols_cache = getattr(farm, "_cols_cache", None)
        if cols_cache is not None:
            cols_bytes = 0
            entries = 0
            for value in cols_cache.values():
                entries += 1
                arr = getattr(value, "arr", None)
                if arr is None:
                    continue
                cols_bytes += int(arr.nbytes)
                cached_sort = getattr(value, "_sorted", None)
                if cached_sort is not None:
                    cols_bytes += int(sum(
                        int(col.nbytes) for col in cached_sort
                        if hasattr(col, "nbytes")))
            out["change_cols_bytes"] = int(cols_bytes)
            out["change_cols_entries"] = int(entries)
            self._g_cols_bytes.set(cols_bytes)
            self._g_cols_entries.set(entries)

        self.samples.append(out)
        return out

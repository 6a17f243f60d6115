"""The traced run's instruments, all in the benchmark's own files:

- `annotated_profile`: the program's ``PhaseProfile`` with each phase
  also entered as a ``torch.profiler.record_function`` range, so the
  device trace can say what the host was doing in each idle gap (the
  driver names its calls into the program alike);
- `BloomLaunches`: records the shapes and counts of every Bloom kernel
  launch while on, for the roofline readers;
- `DeviceTrace`: one ``torch.profiler`` window over a few whole steps,
  exported as a Chrome trace under ``TMPDIR`` and reduced to the device's
  busy time, the time of each device operation, the device time and
  launches under each host range, and the longest idle gaps.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

from .roofline import build_bound_ms, query_bound_ms

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that launch device work, tied to it by their correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_MARK = "bench.traced_window"
#: what an idle gap, or device work, outside every range is charged to
HARNESS = "harness"


def annotated_profile():
    """A fresh enabled ``PhaseProfile`` whose phases are also profiler
    ranges named ``farm.<phase>``."""
    import torch

    from automerge_tpu_torch.profiling import PhaseProfile

    class AnnotatedProfile(PhaseProfile):
        __slots__ = ()

        @contextlib.contextmanager
        def span(self, name):
            with torch.profiler.record_function(f"farm.{name}"):
                with PhaseProfile.span(self, name) as node:
                    yield node

        phase = span

    return AnnotatedProfile()


class BloomLaunches:
    """While `on`, records every ``bloom_build`` and ``bloom_query``
    launch: (shape, counts tensor), bounded after the traced window."""

    def __init__(self):
        self.on = False
        self.build = []
        self.query = []

    @contextlib.contextmanager
    def installed(self):
        from automerge_tpu_torch.tpu import bloom_kernels as bk

        build_fn, query_fn = bk.bloom_build.fn, bk.bloom_query.fn

        def build(xyz, counts, num_words):
            if self.on:
                self.build.append((xyz.shape[0], xyz.shape[1], num_words,
                                   counts))
            return build_fn(xyz, counts, num_words)

        def query(words, modulo, counts, q):
            if self.on:
                self.query.append((q.shape[0], words.shape[1], q.shape[1],
                                   counts))
            return query_fn(words, modulo, counts, q)

        bk.bloom_build.fn, bk.bloom_query.fn = build, query
        try:
            yield self
        finally:
            bk.bloom_build.fn, bk.bloom_query.fn = build_fn, query_fn

    def bounds_ms(self):
        """{"build": least ms summed, "query": ...}, None where no launch
        was recorded."""
        out = {"build": None, "query": None}
        if self.build:
            out["build"] = sum(build_bound_ms(b, e, w, c.cpu().tolist())
                               for b, e, w, c in self.build)
        if self.query:
            out["query"] = sum(query_bound_ms(b, w, n, c.cpu().tolist())
                               for b, w, n, c in self.query)
        return out


def _union(intervals):
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _innermost(ranges, points):
    """{key: name of the innermost range that holds the time} for
    `points`, [(time, key)], against `ranges`, [(start, end, name)] of
    one thread; None where no range holds it. Ranges of one thread nest:
    the innermost open one is the last opened that has not ended."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _by_range(events, device, host):
    """({range: device seconds}, {range: device operations}) of the
    device operations `device`, [(correlation id, seconds)], each charged
    to the innermost of the `host` ranges, {thread: [(start, end,
    name)]}, that holds the host call which launched it (`HARNESS` where
    none does, or where the launch is not in the trace)."""
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")),
                                  float(e["ts"]))
    points = {}
    for corr, _ in device:
        if corr in launches:
            thread, ts = launches[corr]
            points.setdefault(thread, []).append((ts, corr))
    where = {}
    for thread, pts in points.items():
        where.update(_innermost(host.get(thread, []), pts))
    seconds, count = {}, {}
    for corr, s in device:
        name = where.get(corr) or HARNESS
        seconds[name] = seconds.get(name, 0.0) + s
        count[name] = count.get(name, 0) + 1
    return seconds, count


def reduce_trace(path):
    """The Chrome trace at `path` reduced to {"window_s", "busy_s",
    "ops": {name: seconds}, "gaps": [(what the host did, seconds)],
    "ops_by_range": {range: seconds}, "launches_by_range": {range:
    operations}}, all within the `WINDOW_MARK` range. A device operation
    is charged to the innermost ``user_annotation`` range that holds the
    host call which launched it (tied by the trace's correlation id)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    mark = [e for e in events if e.get("name") == WINDOW_MARK
            and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the traced window's range is not in the trace")
    w0 = float(mark[0]["ts"])
    w1 = w0 + float(mark[0]["dur"])
    dev, ops = [], {}
    host = []
    correlated, threads = [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s0, e0 = max(s, w0), min(s + dur, w1)
            if e0 > s0:
                dev.append((s0, e0))
                ops[e["name"]] = ops.get(e["name"], 0.0) + (e0 - s0) * 1e-6
                correlated.append(((e.get("args") or {}).get("correlation"),
                                   (e0 - s0) * 1e-6))
        elif cat == "user_annotation" and e["name"] != WINDOW_MARK:
            host.append((s, s + dur, e["name"]))
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(
                (s, s + dur, e["name"]))
    dev.sort()
    gaps, cursor = [], w0
    for s, e in dev:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        what = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else HARNESS
        named.append((what, (g1 - g0) * 1e-6))
    ops_by_range, launches_by_range = _by_range(events, correlated, threads)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": _union(dev) * 1e-6,
            "ops": ops, "gaps": named, "ops_by_range": ops_by_range,
            "launches_by_range": launches_by_range}


class DeviceTrace:
    """One profiler window over whole steps of a driver; `reduce` reads
    it once the measured window has closed."""

    def __init__(self):
        self.result = None
        self._prof = None
        self._bloom = None
        self._rows = None

    def run(self, driver, seconds, bloom: BloomLaunches, on_card=True):
        """Runs whole steps of `driver` under the profiler until `seconds`
        have passed since the profiler started (one step at least). Off
        the card (the CPU tests) it traces the host alone. The driver's
        ``tracing`` is true while it runs (a loop's tallies of the traced
        steps read it), and the result keeps the rows the traced steps
        committed (``rows``)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        rows = driver.rows
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW_MARK):
                bloom.on = driver.tracing = True
                try:
                    while True:
                        driver.step()
                        if time.perf_counter() - t0 >= seconds:
                            break
                finally:
                    bloom.on = driver.tracing = False
                if on_card:
                    torch.cuda.synchronize()
        self._prof, self._bloom = prof, bloom
        self._rows = driver.rows - rows

    def reduce(self):
        """Exports the trace under ``TMPDIR``, reduces it (`reduce_trace`)
        and bounds the recorded Bloom launches; then deletes the file."""
        if self._prof is None:
            return
        out_dir = tempfile.mkdtemp(prefix="am-bench-trace-")
        path = os.path.join(out_dir, "trace.json")
        try:
            self._prof.export_chrome_trace(path)
            self.result = reduce_trace(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
            os.rmdir(out_dir)
        self.result["bloom_bounds_ms"] = self._bloom.bounds_ms()
        self.result["bloom_launches"] = {"build": len(self._bloom.build),
                                         "query": len(self._bloom.query)}
        self.result["rows"] = self._rows
        self._prof = None

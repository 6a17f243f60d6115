"""amscope live telemetry: text exposition, periodic JSONL snapshots, and
the breakdown math the bench/CLI render.

Three consumers, one data model:

- **Pull-based exposition** (``render_exposition``): the process-wide
  metrics registry and the per-tenant accounting table flattened into a
  Prometheus-style ``text/plain`` page — counters and gauges as plain
  samples, histograms as count/sum/quantile samples with bucket
  exemplars emitted as ``# EXEMPLAR`` comment lines. The asyncio serving
  adapter mounts it on a telemetry port (``serve_exposition``); any
  scraper (or ``curl``) can poll a live server without touching the
  serving data path.
- **Periodic JSONL snapshots** (``SnapshotWriter``): one self-contained
  JSON line per interval — metrics, tenant table, flight-recorder tail —
  appended to a file by ``serve_forever`` or the load harness.
  ``python -m automerge_tpu.obs --watch <file>`` renders the latest line
  as a live top-style view.
- **Phase-share math** (``request_breakdown``): turns the
  ``serve.request.*`` / ``serve.phase.*`` histograms into per-request
  mean milliseconds and normalized phase shares (queue-wait / dispatch /
  readback / assembly / ack), the figure BENCH/SERVE artifacts record so
  the e2e ceiling's location is in the history, not in a lost terminal.

Lifecycle marks use the injected (possibly simulated) clock while farm
phases use the host clock; under a ``ManualClock`` harness the shares are
therefore dominated by the simulated window price — exactly what a client
feels — with the host-side dispatch phases reported alongside.

This is the port's own copy of the JAX package's ``obs/export.py``, over the
port's own metrics registry, flight recorder and tracer: nothing it
registers touches the JAX package's process-wide state.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import json
import time

from .flight import get_flight
from .metrics import get_metrics
from .scope import get_amscope

#: serve.phase.* histogram suffix -> breakdown key
_PHASE_KEYS = {
    "serve.phase.decode_ms": "decode",
    "serve.phase.gate_verdicts_ms": "gate_verdicts",
    "serve.phase.transcode_columns_ms": "transcode_columns",
    "serve.phase.gate_transcode_ms": "gate_transcode",
    "serve.phase.pack_ms": "pack",
    "serve.phase.device_dispatch_ms": "device_dispatch",
    "serve.phase.readback_ms": "readback",
    "serve.phase.assembly_ms": "assembly",
    "serve.phase.generate_ms": "generate",
}


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    return "".join(out)


def render_exposition(registry=None, scope=None, slo=None) -> str:
    """The pull-based text page: metrics + per-tenant samples. ``slo``
    (a verdict list from ``obs.slo.SLOEngine.evaluate``) adds one
    ``# SLO`` comment line per objective window — the ``slo.*`` gauges
    the engine exports appear as ordinary samples regardless."""
    registry = registry if registry is not None else get_metrics()
    scope = scope if scope is not None else get_amscope()
    lines: list[str] = []
    for v in slo or ():
        for w in v["windows"]:
            burn = w["burn_rate"]
            lines.append(
                f"# SLO {_sanitize(v['objective'])} target={v['target']:.6g}"
                f" window={w['window_s']:.6g}s"
                f" burn={'-' if burn is None else f'{burn:.6g}'}"
                f" {'ok' if v['ok'] else 'BREACH'}"
            )
    for name, snap in registry.as_dict().items():
        n = _sanitize(name)
        if snap["type"] == "histogram":
            lines.append(f"# TYPE {n} summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                if snap[key] is not None:
                    lines.append(f'{n}{{quantile="{q}"}} {snap[key]:.6g}')
            lines.append(f"{n}_count {snap['count']}")
            lines.append(f"{n}_sum {snap['sum']:.6g}")
            for bucket, exemplar in snap.get("exemplars", {}).items():
                lines.append(f"# EXEMPLAR {n} bucket={bucket} trace={exemplar}")
        else:
            lines.append(f"# TYPE {n} {snap['type']}")
            lines.append(f"{n} {snap['value']:.6g}"
                         if isinstance(snap["value"], float)
                         else f"{n} {snap['value']}")
    for tenant, stats in scope.tenant_stats().items():
        t = _sanitize(tenant)
        for field in ("requests", "changes", "bytes_in", "shed",
                      "backpressure", "rejected"):
            lines.append(f'am_tenant_{field}{{tenant="{t}"}} {stats[field]}')
    return "\n".join(lines) + "\n"


def request_breakdown(metrics_snapshot: dict) -> dict:
    """Per-request phase breakdown from a ``registry.as_dict()`` snapshot.

    Returns ``{"requests": N, "mean_ms": {...}, "shares": {...},
    "p99_exemplar": {...}}``. Shares are normalized over queue_wait /
    dispatch / readback / assembly / ack, where ``dispatch`` is the
    request-measured flush->commit segment minus the host-measured
    readback and assembly phases (floored at zero), so the five shares
    partition the request's journey without double counting."""

    def hist(name):
        return metrics_snapshot.get(name, {})

    requests = hist("serve.request.e2e_ms").get("count", 0)
    if not requests:
        return {"requests": 0, "mean_ms": {}, "shares": {}}
    queue = hist("serve.request.queue_wait_ms").get("sum", 0.0)
    dispatch_total = hist("serve.request.dispatch_ms").get("sum", 0.0)
    ack = hist("serve.request.ack_ms").get("sum", 0.0)
    phases = {
        key: hist(name).get("sum", 0.0) for name, key in _PHASE_KEYS.items()
    }
    readback = phases.get("readback", 0.0)
    assembly = phases.get("assembly", 0.0)
    # dispatch = the merge-side share: the request-measured flush->commit
    # segment net of the host-measured readback/assembly phases. Under a
    # simulated clock that segment is ~0 while the host phases are real —
    # fall back to the host-measured dispatch-side phases so the share
    # still names where the dispatch time went.
    host_dispatch = sum(
        phases.get(k, 0.0)
        for k in ("decode", "gate_verdicts", "transcode_columns",
                  "gate_transcode", "pack", "device_dispatch")
    )
    dispatch = max(dispatch_total - readback - assembly, host_dispatch)
    parts = {
        "queue_wait": queue,
        "dispatch": dispatch,
        "readback": readback,
        "assembly": assembly,
        "ack": ack,
    }
    total = sum(parts.values()) or 1.0
    out = {
        "requests": requests,
        "mean_ms": {
            k: round(v / requests, 4) for k, v in parts.items()
        },
        "shares": {k: round(v / total, 4) for k, v in parts.items()},
        "phase_mean_ms": {
            k: round(v / requests, 4) for k, v in phases.items() if v
        },
    }
    p99 = hist("serve.request.e2e_ms")
    exemplars = p99.get("exemplars", {})
    if exemplars:
        out["p99_exemplar"] = {
            "trace_id": _p99_exemplar(p99),
            "p99_ms": p99.get("p99"),
        }
    return out


def _p99_exemplar(snap: dict):
    """The exemplar of the p99 bucket from a histogram *snapshot* (the
    live-object path is ``Histogram.exemplar_for(0.99)``)."""
    buckets = snap.get("exemplars", {})
    if not buckets:
        return None
    # snapshots carry no per-bucket counts; the p99 value maps back to its
    # bucket via the shared log2 grid
    from .spans import bucket_index

    p99 = snap.get("p99")
    if p99 is None:
        return None
    # p99 is a bucket UPPER bound; the observation lives one bucket down
    b = max(bucket_index(p99) - 1, 0)
    if str(b) in buckets:
        return buckets[str(b)]
    lower = [int(k) for k in buckets if int(k) <= b]
    return buckets[str(max(lower))] if lower else buckets[sorted(buckets)[0]]


def shard_table(metrics_snapshot: dict) -> dict:
    """Per-shard rollup of the mesh's shard-labelled instrument families
    (``mesh.shard.<s>.*``, ``mesh.pipe.<s>.*``, ``mesh.shm.<s>.*`` and
    ``serve.flush.shard.<s>.docs``) from a ``registry.as_dict()``
    snapshot: ``{shard: {suffix: value}}``, shards in ascending order.
    Histograms collapse to their count/sum/p99 (the figures the mesh
    bench reports per shard); counters and gauges pass their value
    through. The serving-side family keeps a ``flush.`` prefix so
    ``serve.flush.shard.<s>.docs`` never shadows the mesh's
    ``mesh.shard.<s>.docs``, and the transport families keep their
    ``pipe.``/``shm.`` prefixes for the same reason
    (``mesh.pipe.<s>.bytes_out`` lands as ``pipe.bytes_out``,
    ``mesh.shm.<s>.bytes_out`` as ``shm.bytes_out`` — the two-transport
    data plane's byte counters stay side by side per shard)."""
    import re

    pattern = re.compile(
        r"^(mesh|serve\.flush)\.(shard|pipe|shm)\.(\d+)\.(.+)$"
    )
    table: dict[int, dict] = {}
    for name, snap in metrics_snapshot.items():
        m = pattern.match(name)
        if m is None:
            continue
        if snap.get("type") == "histogram":
            cell = {
                "count": snap.get("count", 0),
                "sum": round(snap.get("sum", 0.0), 4),
                "p99": snap.get("p99"),
            }
        else:
            cell = snap.get("value")
        suffix = m.group(4)
        if m.group(1) == "serve.flush":
            suffix = f"flush.{suffix}"
        elif m.group(2) in ("pipe", "shm"):
            suffix = f"{m.group(2)}.{suffix}"
        table.setdefault(int(m.group(3)), {})[suffix] = cell
    return {s: table[s] for s in sorted(table)}


def program_table(metrics_snapshot: dict) -> dict:
    """Per-program rollup of the amprof observatory's instrument family
    (``prof.program.<name>.{compiles,dispatches,compile_ms,dispatch_ms}``)
    from a ``registry.as_dict()`` snapshot: ``{program: {suffix: value}}``,
    programs in name order. Histogram suffixes collapse to their sum (the
    total wall ms the ``--watch`` programs panel shows)."""
    import re

    pattern = re.compile(
        r"^prof\.program\.(.+)\.(compiles|dispatches|compile_ms|dispatch_ms)$"
    )
    table: dict[str, dict] = {}
    for name, snap in metrics_snapshot.items():
        m = pattern.match(name)
        if m is None:
            continue
        if snap.get("type") == "histogram":
            cell = round(snap.get("sum", 0.0), 3)
        else:
            cell = snap.get("value")
        table.setdefault(m.group(1), {})[m.group(2)] = cell
    return {p: table[p] for p in sorted(table)}


def snapshot_record(t: float | None = None, registry=None, scope=None,
                    flight=None, tail: int = 16, slo=None) -> dict:
    """One self-contained telemetry snapshot (a JSONL line's payload).
    ``slo`` verdicts (when an engine is wired) ride along for the
    ``--watch`` SLO panel."""
    registry = registry if registry is not None else get_metrics()
    scope = scope if scope is not None else get_amscope()
    flight = flight if flight is not None else get_flight()
    metrics = registry.as_dict()
    record = {
        "t": time.time() if t is None else t,
        "metrics": metrics,
        "tenants": scope.tenant_stats(),
        "breakdown": request_breakdown(metrics),
        "flight_tail": flight.tail(tail),
    }
    if slo is not None:
        record["slo"] = slo
    return record


class SnapshotWriter:
    """Appends periodic JSONL snapshots to a file. Clock-injected so the
    load harness snapshots on simulated time; ``serve_forever`` drives it
    from its flusher task on the real clock. An attached ``slo_engine``
    is evaluated (and its ``slo.*`` gauges exported) at every write, so
    each snapshot line carries the verdicts as of that tick."""

    def __init__(self, path: str, interval: float = 5.0, clock=None,
                 slo_engine=None):
        self.path = path
        self.interval = interval
        self.clock = clock if clock is not None else time.monotonic
        self.slo_engine = slo_engine
        self._last: float | None = None

    def maybe_write(self, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        if self._last is not None and now - self._last < self.interval:
            return False
        self.write(now)
        return True

    def write(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        self._last = now
        verdicts = (
            self.slo_engine.export(now=now)
            if self.slo_engine is not None else None
        )
        record = snapshot_record(t=now, slo=verdicts)
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record, sort_keys=True, default=str) + "\n")


async def serve_exposition(host: str = "127.0.0.1", port: int = 0,
                           registry=None, scope=None):
    """Binds ``render_exposition`` to a minimal HTTP listener (one page,
    any path). Returns the asyncio server; close() to stop. This is the
    serving adapter's telemetry side-car — scraping it never enters the
    serving event loop's data path."""
    import asyncio

    async def _handle(reader: "asyncio.StreamReader",
                      writer: "asyncio.StreamWriter") -> None:
        try:
            # drain the request head (we serve one page whatever the path)
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
            body = render_exposition(registry, scope).encode("utf-8")
            writer.write(
                b"HTTP/1.0 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"\r\n" + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(_handle, host, port)

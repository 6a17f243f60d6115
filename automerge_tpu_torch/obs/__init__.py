"""Observability layer of the port: the metrics registry, span trees (with
their JSON-lines export), the flight recorder, amscope request-flow
tracing (``scope``), SLO burn rates (``slo``), live telemetry export
(``export``), the amprof device-program observatory and memory sampler
(``prof``), and the perf ledger (``ledger``).

The port's own copies of the JAX package's ``obs/`` modules, with their
own process-wide registry, recorder, tracer and observatory. The mesh
workers' black-box files come with the port of ``parallel/``.
``python -m automerge_tpu_torch.obs`` runs a canned farm merge and sync
round trip on the card and prints the span tree, the metrics table and
the program table; it also renders a dumped trace, a flight dump, a
telemetry snapshot or a ledger without touching the device layer.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import contextlib

from .flight import FlightRecorder, enabled_flight, get_flight
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    enabled_metrics,
    get_metrics,
)
from .prof import (
    Observatory,
    ProfiledProgram,
    Sampler,
    enabled_observatory,
    get_observatory,
)
from .scope import (
    Amscope,
    DispatchSpan,
    RequestScope,
    enabled_amscope,
    get_amscope,
)
from .slo import (
    Objective,
    SLOEngine,
    availability_objective,
    latency_objective,
    ratio_objective,
    verdicts_ok,
)
from .spans import SpanNode, Trace, get_trace, use_trace

__all__ = [
    "Amscope",
    "Counter",
    "DispatchSpan",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Objective",
    "Observatory",
    "ProfiledProgram",
    "RequestScope",
    "SLOEngine",
    "Sampler",
    "SpanNode",
    "Trace",
    "availability_objective",
    "enabled_amscope",
    "enabled_flight",
    "enabled_metrics",
    "enabled_observability",
    "enabled_observatory",
    "get_amscope",
    "get_flight",
    "get_metrics",
    "get_observatory",
    "get_trace",
    "latency_objective",
    "ratio_objective",
    "use_trace",
    "verdicts_ok",
]


@contextlib.contextmanager
def enabled_observability(flight_dir: str | None = None):
    """Enables the whole observability stack — metrics registry, amscope
    request tracing, the flight recorder and the amprof observatory —
    for the dynamic extent, restoring every previous enabled state on
    exit."""
    with enabled_metrics(), enabled_amscope(), enabled_flight(
        dump_dir=flight_dir
    ), enabled_observatory():
        yield

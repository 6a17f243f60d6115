"""amslo: declared service-level objectives evaluated as multi-window
burn rates over the amtrace metrics registry.

ROADMAP item 5 says amserve "has never faced a wall clock": the stack had
latency histograms and shed counters but no notion of *how good is good
enough*. This module closes that gap with the classic SRE shape — an
objective declares a compliance target against an error budget, the
engine samples cumulative good/total counts on an **injected clock**
(`time.monotonic` in real serving, the simulated `ManualClock` in the
load harness — both work identically), and evaluation reports, per
objective, the overall compliance plus a **burn rate** for each
configured window: how many times faster than sustainable the error
budget is being spent. A burn rate of 1.0 exactly exhausts the budget
over the objective's horizon; the multi-window rule (all windows burning
simultaneously) separates a real sustained regression from a one-tick
blip, which a single window cannot.

Three objective kinds cover the serving story:

- ``latency``: fraction of observations at or under ``budget_ms`` in a
  histogram (bucketed compliance on the shared log2 grid) must meet
  ``target`` — e.g. "99% of requests under 250 ms";
- ``availability``: ``good / (good + bad)`` over counters — e.g.
  admission accepts vs backpressure rejections;
- ``ratio``: a gauge read directly as the compliance value — e.g. the
  converged-client ratio the load harness publishes at the end of a run.

Verdicts are exported three ways: as ``slo.*`` gauges in the registry
(so the Prometheus exposition and snapshot stream carry them), as
structured dicts in bench/loadgen reports (the ``--serve`` / ``--mesh``
verdict gates), and as a panel in the ``--watch`` view. The metric-name
catalog for the ``slo.*`` family lives in the README Observability
section (amlint AM304 checks both directions).

This is the port's own copy of the JAX package's ``obs/slo.py``, over the
port's own metrics registry, flight recorder and tracer: nothing it
registers touches the JAX package's process-wide state.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import time
from dataclasses import dataclass

from .metrics import MetricsRegistry, get_metrics
from .spans import bucket_bounds

#: default burn-rate windows (seconds): a fast window to catch cliffs and
#: a slow one to confirm the budget is really being spent
DEFAULT_WINDOWS = (60.0, 300.0)
#: bounded sample history per objective
MAX_SAMPLES = 512


@dataclass(frozen=True)
class Objective:
    """One declared SLO. ``target`` is the compliance floor in [0, 1].

    ``metric`` names the good-signal instrument (histogram for latency,
    counter for availability, gauge for ratio); ``bad_metrics`` are the
    failure counters an availability objective folds into its
    denominator; ``budget_ms`` is the latency budget on the histogram's
    value axis."""

    name: str
    kind: str  # "latency" | "availability" | "ratio"
    metric: str
    target: float = 0.99
    budget_ms: float | None = None
    bad_metrics: tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind not in ("latency", "availability", "ratio"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "latency" and self.budget_ms is None:
            raise ValueError(f"latency objective {self.name!r} needs budget_ms")
        if not 0.0 < self.target <= 1.0:
            raise ValueError(f"target must be in (0, 1], got {self.target}")


def latency_objective(name: str, metric: str, budget_ms: float,
                      target: float = 0.99) -> Objective:
    return Objective(name, "latency", metric, target, budget_ms=budget_ms)


def availability_objective(name: str, good: str, bad: tuple[str, ...],
                           target: float = 0.999) -> Objective:
    return Objective(name, "availability", good, target,
                     bad_metrics=tuple(bad))


def ratio_objective(name: str, metric: str, target: float) -> Objective:
    return Objective(name, "ratio", metric, target)


class SLOEngine:
    """Samples objectives on an injected clock and renders verdicts.

    ``sample()`` is cheap (a few instrument reads per objective) and is
    meant to be called from the serving loop's tick — the simulated tick
    in the load harness, the asyncio flusher in ``serve_forever``.
    ``evaluate()`` turns the sample history into verdict dicts and
    ``export()`` mirrors them into ``slo.*`` gauges."""

    def __init__(self, objectives, *, clock=None, registry=None,
                 windows=DEFAULT_WINDOWS):
        self.objectives: tuple[Objective, ...] = tuple(objectives)
        self.clock = clock if clock is not None else time.monotonic
        self._registry = registry
        self.windows = tuple(sorted(windows))
        # name -> list[(t, good, total)] cumulative samples, bounded
        self._samples: dict[str, list[tuple]] = {
            o.name: [] for o in self.objectives
        }

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_metrics()

    # -------------------------------------------------------------- #
    # sampling

    def _counts(self, o: Objective) -> tuple[float, float]:
        """Cumulative (good, total) for the objective right now."""
        reg = self.registry
        inst = reg.find(o.metric)
        if o.kind == "latency":
            if inst is None or not getattr(inst, "count", 0):
                return (0.0, 0.0)
            good = sum(
                c for b, c in inst.buckets.items()
                if bucket_bounds(b)[1] <= o.budget_ms
            )
            return (float(good), float(inst.count))
        if o.kind == "availability":
            good = float(getattr(inst, "value", 0) or 0)
            bad = sum(
                float(getattr(reg.find(m), "value", 0) or 0)
                for m in o.bad_metrics
            )
            return (good, good + bad)
        # ratio: a gauge IS the compliance; synthesize unit counts so the
        # window algebra below degrades to "latest value"
        value = float(getattr(inst, "value", 0.0) or 0.0)
        return (value, 1.0)

    def sample(self, now: float | None = None) -> None:
        t = self.clock() if now is None else now
        for o in self.objectives:
            ring = self._samples[o.name]
            ring.append((t, *self._counts(o)))
            if len(ring) > MAX_SAMPLES:
                del ring[: len(ring) - MAX_SAMPLES]

    # -------------------------------------------------------------- #
    # evaluation

    @staticmethod
    def _compliance(good: float, total: float) -> float | None:
        return None if total <= 0 else good / total

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One verdict dict per objective: overall compliance vs target,
        per-window burn rates, and the pass/fail bits. Objectives with no
        data yet pass vacuously (``compliance: None``) — an idle service
        has not missed its SLO."""
        t = self.clock() if now is None else now
        self.sample(t)
        verdicts = []
        for o in self.objectives:
            ring = self._samples[o.name]
            t_now, good_now, total_now = ring[-1]
            compliance = self._compliance(good_now, total_now)
            if o.kind == "ratio":
                # gauges are instantaneous; cumulative algebra is moot
                compliance = good_now if total_now else None
            budget = max(1.0 - o.target, 1e-9)
            windows = []
            for w in self.windows:
                base = ring[0]
                for s in ring:
                    if s[0] >= t_now - w:
                        break
                    base = s
                if o.kind == "ratio":
                    w_comp = compliance
                else:
                    w_comp = self._compliance(
                        good_now - base[1], total_now - base[2]
                    )
                burn = None if w_comp is None else (1.0 - w_comp) / budget
                windows.append({
                    "window_s": w,
                    "compliance": w_comp,
                    "burn_rate": burn,
                })
            burns = [w["burn_rate"] for w in windows
                     if w["burn_rate"] is not None]
            burning = bool(burns) and all(b > 1.0 for b in burns)
            ok = compliance is None or compliance >= o.target
            verdicts.append({
                "objective": o.name,
                "kind": o.kind,
                "metric": o.metric,
                "target": o.target,
                "budget_ms": o.budget_ms,
                "compliance": compliance,
                "windows": windows,
                "burn_rate": max(burns) if burns else None,
                "burning": burning,
                "ok": ok,
            })
        return verdicts

    def export(self, verdicts: list[dict] | None = None,
               now: float | None = None) -> list[dict]:
        """Evaluates (unless given verdicts) and mirrors each verdict into
        ``slo.*`` gauges so the exposition/snapshot surfaces carry them:
        per-objective compliance, worst-window burn rate and the pass bit,
        plus the breach count across the whole set."""
        if verdicts is None:
            verdicts = self.evaluate(now)
        reg = self.registry
        breaches = 0
        for v in verdicts:
            name = v["objective"]
            help_ = f"SLO {v['kind']} objective on {v['metric']}"
            if v["compliance"] is not None:
                reg.gauge(f"slo.{name}.compliance", help_).set(v["compliance"])
            if v["burn_rate"] is not None:
                reg.gauge(f"slo.{name}.burn_rate", help_).set(v["burn_rate"])
            reg.gauge(f"slo.{name}.ok", help_).set(1.0 if v["ok"] else 0.0)
            breaches += 0 if v["ok"] else 1
        reg.gauge(
            "slo.breaches",
            "objectives currently out of compliance",
        ).set(float(breaches))
        return verdicts


def verdicts_ok(verdicts: list[dict]) -> bool:
    """The gate predicate benches use: every objective in compliance."""
    return all(v["ok"] for v in verdicts)


def render_verdicts(verdicts: list[dict]) -> str:
    """Human-readable verdict table (the ``--watch`` SLO panel)."""
    if not verdicts:
        return "(no SLOs declared)"
    width = max(len(v["objective"]) for v in verdicts)
    lines = []
    for v in verdicts:
        comp = "-" if v["compliance"] is None else f"{v['compliance']:.4f}"
        burn = "-" if v["burn_rate"] is None else f"{v['burn_rate']:.2f}"
        state = "ok" if v["ok"] else "BREACH"
        if v["burning"] and v["ok"]:
            state = "burning"
        wins = " ".join(
            f"{int(w['window_s'])}s="
            + ("-" if w["burn_rate"] is None else f"{w['burn_rate']:.2f}")
            for w in v["windows"]
        )
        lines.append(
            f"{v['objective'].ljust(width)}  target={v['target']:.3f}  "
            f"compliance={comp}  burn[{wins}]  max_burn={burn}  {state}"
        )
    return "\n".join(lines)


# -------------------------------------------------------------------- #
# canned objective sets

def default_serve_slos(*, budget_ms: float = 250.0,
                       latency_target: float = 0.99,
                       availability_target: float = 0.999,
                       convergence_target: float = 0.999,
                       latency_metric: str = "serve.request.e2e_ms",
                       ) -> list[Objective]:
    """The front door's default SLO set: request latency under budget,
    admission availability (accepts vs backpressure rejections — poison
    sheds are by-design and excluded), and the end-of-run converged-client
    ratio the load harness publishes. ``latency_metric`` defaults to the
    amscope request histogram; the load harness swaps in
    ``serve.sync.latency_ms`` so the objective also has data under the
    metrics-only stack."""
    return [
        latency_objective(
            "serve_latency", latency_metric, budget_ms,
            target=latency_target,
        ),
        availability_objective(
            "serve_availability", "serve.admission.accepted",
            ("serve.admission.rejected_backpressure",),
            target=availability_target,
        ),
        ratio_objective(
            "serve_convergence", "serve.clients.converged_ratio",
            convergence_target,
        ),
    ]


def default_mesh_slos(*, availability_target: float = 0.999
                      ) -> list[Objective]:
    """The mesh bench's machine-independent SLO set: delivery
    availability (changes applied vs docs lost to worker crashes) and
    worker liveness (spawns that stayed up vs crashes)."""
    return [
        availability_objective(
            "mesh_delivery", "farm.changes.applied",
            ("mesh.worker.lost_docs",),
            target=availability_target,
        ),
        availability_objective(
            "mesh_workers", "mesh.worker.spawns",
            ("mesh.worker.crashes",), target=availability_target,
        ),
    ]

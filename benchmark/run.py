#!/usr/bin/env python3
"""Runs one cell of the benchmark of automerge_tpu_torch once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration
(``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``) and its metrics
(``benchmark/metrics/<metric>.py``) are found by the names in
``BENCHMARK.json``; the configuration's ``schema`` and the traffic's
``loop`` name the generator, the reference and the window's driver
(``harness/plugins.py``). Set-up makes the stream from the seed, builds the
cell's system and runs the traffic's warm-up steps; the window then runs
whole steps until ``--seconds`` have passed and ends at a synchronize.
After it, every answer of the window is held to the plain reference: by
``harness/check.py``, or by the loop's own ``check`` where it has one.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error). Without CUDA, with fewer cards
than the cell takes, or with JAX or the JAX package loaded after the
window, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import os
import sys
import time

# One process with few threads, and one hash seed: the same --seed then
# runs the same work in the same order. A run started without the fixed
# hash seed starts itself again with it (before any import of weight).
PINNED_ENV = {"PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
              "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
if __name__ == "__main__" and any(os.environ.get(k) != v
                                  for k, v in PINNED_ENV.items()):
    os.environ.update(PINNED_ENV)
    os.execv(sys.executable, [sys.executable, *sys.argv])

T_CALLED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import cells  # noqa: E402
from harness import check as output_check  # noqa: E402
from harness import plugins  # noqa: E402
from harness import trace as tracing  # noqa: E402
from harness.traffic import make_stream  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "automerge_tpu")
# a traced run profiles whole steps from this share of the window on, for
# at least TRACE_SECONDS
TRACE_AT, TRACE_SECONDS = 0.3, 3.0


def process_start() -> float:
    """When this process started, on the ``time.perf_counter`` clock
    (Linux: its start time in /proc; else when this module ran)."""
    try:
        with open("/proc/self/stat") as fh:
            stat = fh.read()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        start = int(stat[stat.rindex(")") + 2:].split()[19])
        age = uptime - start / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return T_CALLED


def load_cell(name, root=ROOT):
    """(spec, cell, configuration, traffic) of workload `name`."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_config(os.path.join(root, config["file"]))
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{cell['traffic']}.json")) as fh:
        mix = json.load(fh)
    return spec, cell, cfg, mix


def load_config(path):
    """The configuration file at `path`. A file with ``extends`` holds the
    configuration it names (a file beside it) with its own keys put over
    it: a cut deployment states only its cut."""
    with open(path) as fh:
        cfg = json.load(fh)
    base = cfg.pop("extends", None)
    if base is None:
        return cfg
    if not plugins.NAME.fullmatch(base):
        raise ValueError(f"not a configuration name: {base!r}")
    out = load_config(os.path.join(os.path.dirname(path), f"{base}.json"))
    out.update(cfg)
    return out


def set_environment(cfg, root=ROOT):
    """Build and kernel caches at fixed paths inside the checkout, and
    the configuration's settings of the program (read at its import)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    for key, value in cfg.get("program_env", {}).items():
        os.environ[key] = str(value)


def _applies(metric, cell):
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def _percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _tail(values):
    if not values:
        return None
    return {"p50": _percentile(values, 50), "p95": _percentile(values, 95),
            "n": len(values)}


def read_metric(name, readings, root=ROOT):
    return plugins.load(root, "metrics", name).read(readings)


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             root=ROOT, plant=None, make_farms=None, driver_cls=None,
             steps=None):
    """One run of cell `name`. Returns (result dict, check result, info
    dict). A loop module that defines ``check(ref_mod, stream, driver,
    finals)`` judges its own runs with it (a ``CheckResult`` of
    ``harness/check.py`` with ``attempted`` set); a driver that has
    ``readings()`` hands the metric readers its dict under ``"loop"``, and
    one that has ``end_to_end(window_s)`` adds the end-to-end values of
    its own metrics.
    `plant(farms, syncs)`, when given, is called once the farms are
    built (the fault tests plant faults with it); `make_farms` and
    `driver_cls` stand in for the loop's ``build`` and ``Driver`` (the
    control puts the reference in the program's place with them).
    `steps`, when given, ends the window after that many steps instead
    of after `seconds` (the control runs as many steps as a run does)."""
    t_start = T_CALLED if t_start is None else t_start
    spec, cell, cfg, mix = load_cell(name, root)
    t0 = time.perf_counter()
    loop = plugins.load(root, "loops", mix["loop"])
    ref_mod = plugins.load(root, "reference", cfg["schema"])
    stream = make_stream(cfg, mix, seed, root)
    generate_s = time.perf_counter() - t0
    set_environment(cfg, root)
    import torch

    from automerge_tpu_torch.profiling import use_profile

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    farms, syncs = (make_farms or loop.build)(cfg, mix, stream, device)
    if plant is not None:
        plant(farms, syncs)
    driver = (driver_cls or loop.Driver)(stream, mix, farms, syncs, device)
    if trace:
        driver.span = torch.profiler.record_function
    bloom = tracing.BloomLaunches()
    device_trace = tracing.DeviceTrace()
    profile = tracing.annotated_profile() if trace else None
    with bloom.installed():
        t0 = time.perf_counter()
        for _ in range(mix["warmup_steps"]):
            driver.step()
        cells.synchronize(device)
        # the stream and the farms' set-up state move to the permanent
        # generation: the window's collections do not walk them again
        gc.collect()
        gc.freeze()
        warm_steps = driver.pos
        t_window = time.perf_counter()
        warmup_s = t_window - t0
        setup_s = t_window - t_start
        driver.in_window = True
        traced = not trace
        with use_profile(profile) if trace else contextlib.nullcontext():
            while True:
                elapsed = time.perf_counter() - t_window
                if not traced and elapsed >= TRACE_AT * seconds:
                    device_trace.run(driver, TRACE_SECONDS if steps is None
                                     else 0.0, bloom, on_card)
                    traced = True
                elif (elapsed >= seconds if steps is None
                      else driver.pos - warm_steps >= steps):
                    break
                else:
                    driver.step()
            cells.synchronize(device)
        window_s = time.perf_counter() - t_window
        driver.in_window = False
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    device_trace.reduce()
    finals = driver.finals()
    gc.unfreeze()
    driver.farms = driver.syncs = None
    del farms, syncs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    made = set(driver.made)
    own_check = getattr(loop, "check", None)
    if own_check is None:
        result_check = output_check.check(ref_mod, stream, driver.records,
                                          finals, made, driver.quarantined,
                                          driver.unquiesced)
        attempted = len(made)
    else:
        result_check = own_check(ref_mod, stream, driver, finals)
        attempted = result_check.attempted
        if attempted is None:
            raise ValueError(f"loop {mix['loop']!r}: its check set no "
                             "'attempted'")
    check_s = time.perf_counter() - t_check

    info = {
        "window_s": window_s, "setup_s": setup_s, "check_s": check_s,
        "generate_s": generate_s, "warmup_s": warmup_s,
        "steps": driver.pos - warm_steps, "warmup_steps": warm_steps,
        "stream_steps": len(stream.steps),
        "headroom": len(stream.steps) / max(driver.pos, 1),
        "changes": len(made), "rows": driver.rows,
        "apply_ms": _tail(driver.apply_ms),
        "sync_lag_ms": _tail(driver.lag_ms),
        "traffic_wait_s": window_s - driver.program_s,
        "patches_checked": result_check.patches,
        "states_checked": result_check.states,
    }
    if device_trace.result is not None:
        t = device_trace.result
        info["bloom"] = {
            "launches": t["bloom_launches"], "bound_ms": t["bloom_bounds_ms"],
            "device_ms": {k: 1e3 * sum(s for n, s in t["ops"].items()
                                       if f"bloom_{k}" in n)
                          for k in ("build", "query")},
            "kernels": sorted(n for n in t["ops"] if "bloom" in n)}
    readings = {"rows": driver.rows, "sweeps": driver.sweeps,
                "epochs": driver.epochs, "generate_s": driver.generate_s,
                "phases": ({k: t for k, (t, _) in
                            profile.totals_by_name().items()}
                           if profile is not None else {}),
                "trace": device_trace.result}
    if hasattr(driver, "readings"):
        readings["loop"] = driver.readings()
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if _applies(m, cell):
                value = read_metric(m["name"], readings, root)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "setup_s": setup_s,
            "merged_ops_per_s": driver.rows / window_s,
            "apply_p95_ms": (info["apply_ms"] or {}).get("p95"),
            "sync_lag_p95_ms": (info["sync_lag_ms"] or {}).get("p95"),
            "sync_bytes_per_change": (driver.sync_bytes / len(made)
                                      if made else None),
        }
        if hasattr(driver, "end_to_end"):
            values.update(driver.end_to_end(window_s))
        for m in spec["end_to_end"]:
            if _applies(m, cell) and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": result_check.correct, "attempted": attempted,
              "failed": result_check.failed, "metrics": metrics,
              "device": dev}
    if trace and device_trace.result is not None:
        t = device_trace.result
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        ops = sorted(t["ops"].items(), key=lambda kv: kv[1], reverse=True)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in t["gaps"][:10]]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in result_check.numbers()}
    return result, result_check, info


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    _, cell, _, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell takes {cell['chips']} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    try:
        result, result_check, info = run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=t_start)
    except cells.StreamExhausted as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), flush=True)
    for text in result_check.notes:
        print(f"check: {text}", file=sys.stderr)
    for n, v, lim in result_check.numbers():
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Request-flow tracing (amscope) in the port: ``automerge_tpu_torch.obs.scope``,
``obs/export`` and their serve-stack integration, twins of the JAX
package's tests/test_scope.py on the CPU (``device="cpu"``). Trace
contexts attach at ``AmServer.receive`` and ride the batching window; one
``DispatchSpan`` links the request traces a batched dispatch served; the
port's farm stamps that span as the exemplar of its dispatch and
readback latency histograms; per-tenant accounting, the disabled cost and
the live telemetry pipeline behave as in the JAX package."""
import json

import pytest

from automerge_tpu_torch.obs.export import (
    render_exposition,
    request_breakdown,
    snapshot_record,
)
from automerge_tpu_torch.obs.flight import get_flight
from automerge_tpu_torch.obs.metrics import get_metrics
from automerge_tpu_torch.obs.scope import (
    Amscope,
    PHASE_HISTOGRAMS,
    current_exemplar,
    dispatch_context,
    get_amscope,
)
from automerge_tpu_torch.serve.loadgen import LoadConfig, LoadGen
from automerge_tpu_torch.tpu.farm import TorchDocFarm


# ---------------------------------------------------------------------- #
# unit: scope lifecycle

def test_attach_marks_and_breakdown():
    tracer = Amscope()
    tracer.enabled = True
    scope = tracer.attach("t0", doc=3, client_id="c1", t=10.0, nbytes=42)
    assert scope is not None and scope.tenant == "t0" and scope.doc == 3
    scope.mark("flush", 10.05)
    scope.mark("committed", 10.07)
    scope.mark("sent", 10.08)
    scope.changes = 2
    tracer.finish(scope)
    bd = scope.breakdown()
    assert bd["queue_wait_ms"] == pytest.approx(50.0)
    assert bd["dispatch_ms"] == pytest.approx(20.0)
    assert bd["ack_ms"] == pytest.approx(10.0)
    assert bd["e2e_ms"] == pytest.approx(80.0)
    assert scope in tracer.recent
    stats = tracer.tenant_stats()["t0"]
    assert stats["requests"] == 1 and stats["bytes_in"] == 42
    assert stats["changes"] == 2
    assert stats["latency_ms"]["samples"] == 1


def test_drop_counts_per_tenant_without_latency_samples():
    tracer = Amscope()
    tracer.enabled = True
    for reason in ("shed", "backpressure", "rejected", "shed"):
        scope = tracer.attach("t1", 0, "c", t=0.0)
        tracer.drop(scope, reason)
    stats = tracer.tenant_stats()["t1"]
    assert stats["shed"] == 2
    assert stats["backpressure"] == 1
    assert stats["rejected"] == 1
    assert stats["latency_ms"]["samples"] == 0
    table = tracer.tenant_table()
    assert "t1" in table and "backpr" in table


def test_dispatch_span_links_traces_and_observes_phases():
    reg = get_metrics()
    reg.reset()
    tracer = Amscope()
    tracer.enabled = True
    scopes = [tracer.attach("t0", d, f"c{d}", t=0.0) for d in range(3)]
    span = tracer.begin_dispatch([s.trace_id for s in scopes], 1.0)
    assert len(span.trace_ids) == 3
    with dispatch_context(span):
        assert current_exemplar() == span.dispatch_id
    assert current_exemplar() is None
    reg.enable()
    tracer.end_dispatch(
        span, 1.5,
        phases={"device_dispatch": 0.004, "visibility": 0.002,
                "patch_assembly": 0.001, "walk": 0.0005},
        docs=3, changes=6,
    )
    reg.disable()
    assert span in tracer.dispatches
    # mapped phases observed with the span id as exemplar; unmapped
    # phases (walk) are carried on the span but not histogrammed
    hist = PHASE_HISTOGRAMS["device_dispatch"]
    assert hist.count == 1
    assert hist.exemplar_for(0.99) == span.dispatch_id
    assert "walk" in span.phases
    reg.reset()


def test_find_recent_trace_by_id():
    tracer = Amscope()
    tracer.enabled = True
    scope = tracer.attach("t0", 0, "c", t=0.0)
    tracer.finish(scope)
    assert tracer.find(scope.trace_id) is scope
    assert tracer.find("t-missing") is None


# ---------------------------------------------------------------------- #
# disabled cost (satellite: attach/propagate/record <= one attribute test)

class _Boom:
    def append(self, *_):
        raise AssertionError("disabled path touched internal state")

    def __bool__(self):
        raise AssertionError("disabled path inspected internal state")


def test_disabled_attach_is_attribute_test_only():
    tracer = Amscope()
    # poison everything attach would touch if it did any work
    tracer.recent = _Boom()
    tracer.tenants = None
    assert tracer.attach("t0", 0, "c", t=0.0, nbytes=9) is None


def test_disabled_flight_record_is_attribute_test_only():
    from automerge_tpu_torch.obs.flight import FlightRecorder

    rec = FlightRecorder()
    rec._ring = _Boom()
    rec.record("batcher.flush", t=0.0, reason="timer")  # no-op, no raise
    assert rec.trigger("anything") is None


def test_disabled_serve_path_creates_no_scopes():
    """Propagation cost when off: a full serving run with the stack
    disabled leaves no scopes, no dispatch spans, no flight events, and
    no pending scopes on any channel."""
    scope, flight = get_amscope(), get_flight()
    scope.reset()
    flight.clear()
    farm = TorchDocFarm(4, capacity=64, device="cpu")
    gen = LoadGen(farm, LoadConfig(
        clients=8, docs=4, edits_per_client=1, ops_per_edit=2,
        spread=0.2, observability="off",
    ))
    report = gen.run()
    assert report["converged"]
    assert len(scope.recent) == 0 and len(scope.dispatches) == 0
    assert len(flight) == 0
    assert all(
        not ch.pending_scopes for ch in gen.server.channels.values()
    )
    assert "breakdown" not in report


# ---------------------------------------------------------------------- #
# integration: the serving stack under full tracing

@pytest.fixture(scope="module")
def full_run():
    farm = TorchDocFarm(6, capacity=128, device="cpu")
    gen = LoadGen(farm, LoadConfig(
        clients=24, docs=6, edits_per_client=2, ops_per_edit=3,
        spread=0.5, tenants=3, observability="full", seed=3,
    ))
    report = gen.run()
    # snapshot the process-wide tracer state before other tests reset it
    tracer = get_amscope()
    return {
        "report": report,
        "dispatches": list(tracer.dispatches),
        "recent": list(tracer.recent),
        "tenant_table": tracer.tenant_table(),
        "metrics": get_metrics().as_dict(),
    }


def test_full_run_converges_with_breakdown(full_run):
    report = full_run["report"]
    assert report["converged"]
    bd = report["breakdown"]
    assert bd["requests"] > 0
    for phase in ("queue_wait", "dispatch", "readback", "assembly", "ack"):
        assert phase in bd["shares"], phase
    assert sum(bd["shares"].values()) == pytest.approx(1.0, abs=0.01)


def test_one_dispatch_span_links_many_request_traces(full_run):
    """The tentpole claim: a batched dispatch is ONE span owning the N
    member traces, and members share its phase breakdown."""
    spans = full_run["dispatches"]
    assert spans, "no dispatch spans recorded"
    linked = max(spans, key=lambda s: len(s.trace_ids))
    assert len(linked.trace_ids) >= 2
    assert "device_dispatch" in linked.phases
    members = [
        s for s in full_run["recent"] if s.dispatch_id == linked.dispatch_id
    ]
    assert len(members) >= 2
    assert all(m.phases == linked.phases for m in members)


def test_p99_exemplar_names_a_recorded_trace(full_run):
    bd = full_run["report"]["breakdown"]
    assert "p99_exemplar" in bd
    trace_id = bd["p99_exemplar"]["trace_id"]
    assert trace_id is not None
    assert any(s.trace_id == trace_id for s in full_run["recent"])


def test_request_histograms_carry_exemplars(full_run):
    e2e = full_run["metrics"]["serve.request.e2e_ms"]
    assert e2e["count"] > 0
    assert e2e.get("exemplars"), "request histogram recorded no exemplars"


def test_tenant_accounting_covers_every_tenant(full_run):
    tenants = full_run["report"]["tenants"]
    assert sorted(tenants) == ["t0", "t1", "t2"]
    for stats in tenants.values():
        assert stats["requests"] > 0
        assert stats["bytes_in"] > 0
        assert stats["latency_ms"]["samples"] > 0
    assert "p99ms" in full_run["tenant_table"]


def test_farm_latency_histograms_carry_dispatch_exemplars(full_run):
    """The farm-side hook: dispatch/readback latency histograms stamp the
    owning serve DispatchSpan id into their buckets."""
    snap = full_run["metrics"]["farm.dispatch.latency_ms"]
    assert snap["count"] > 0
    exemplars = set(snap.get("exemplars", {}).values())
    span_ids = {s.dispatch_id for s in full_run["dispatches"]}
    assert exemplars & span_ids


def test_farm_readback_exemplars_and_own_tracer(full_run):
    """The port's readback latency histogram is stamped with the owning
    dispatch span too, and its tracer and registry are its own objects,
    apart from the JAX package's process-wide ones."""
    from automerge_tpu.obs.metrics import get_metrics as jax_get_metrics
    from automerge_tpu.obs.scope import get_amscope as jax_get_amscope

    snap = full_run["metrics"]["farm.readback.latency_ms"]
    assert snap["count"] > 0
    span_ids = {s.dispatch_id for s in full_run["dispatches"]}
    assert set(snap.get("exemplars", {}).values()) & span_ids
    assert get_amscope() is not jax_get_amscope()
    assert get_metrics() is not jax_get_metrics()


# ---------------------------------------------------------------------- #
# live telemetry pipeline

def test_exposition_renders_metrics_and_tenants(full_run):
    text = render_exposition()
    assert "# TYPE" in text
    # names are sanitized for the exposition format
    assert "serve_request_e2e_ms_count" in text
    assert "# EXEMPLAR" in text


def test_snapshot_record_is_json_round_trippable(full_run):
    record = snapshot_record(t=1.5)
    blob = json.dumps(record, sort_keys=True, default=str)
    back = json.loads(blob)
    assert back["t"] == 1.5
    assert "metrics" in back and "tenants" in back
    assert back["breakdown"]["requests"] >= 0


def test_request_breakdown_empty_metrics():
    assert request_breakdown({}) == {
        "requests": 0, "mean_ms": {}, "shares": {}
    }


def test_telemetry_endpoint_serves_exposition():
    """The asyncio side-car: a GET against the telemetry listener returns
    the exposition page."""
    import asyncio

    from automerge_tpu_torch.obs.export import serve_exposition

    async def drive():
        server = await serve_exposition("127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /metrics HTTP/1.0\r\n\r\n")
        await writer.drain()
        payload = await reader.read()
        writer.close()
        server.close()
        await server.wait_closed()
        return payload

    payload = asyncio.run(drive())
    assert payload.startswith(b"HTTP/1.0 200 OK")
    assert b"# TYPE" in payload

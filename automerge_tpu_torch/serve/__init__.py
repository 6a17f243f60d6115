"""amserve: the asynchronous serving front door for the merge farm.

Everything below this package is library-shaped — callers hold a
``TorchDocFarm`` and drive batched calls themselves. This package is the
service layer a fleet of concurrent editors would actually hit, built with
the same continuous-batching discipline that keeps accelerator LLM
serving dense (PAPERS.md: Ragged Paged Attention): collect requests across
clients, dispatch one dense device batch, fan the results back out. This
is the port's own copy of the JAX package's ``serve`` package, over the
port's ``SyncFarm`` and ``TorchDocFarm``: the batch each flush hands the
farm is what the card merges.

Three parts:

- **Session multiplexer** (``serve/server.py``): ``AmServer`` owns one
  supervised ``SyncSession`` per client channel, created through
  ``SyncFarm.make_session``/``restore_session`` so connect/resume/restart
  ride the existing epoch machinery. The core is sans-io and runs
  entirely on an injectable clock — tests and the load harness drive it
  in simulated time (``ManualClock``) — with a thin asyncio adapter for
  real transports.
- **Dynamic batching scheduler** (``serve/batcher.py``):
  ``DynamicBatcher`` accumulates incoming payload frames per document
  across clients until ≤T seconds elapse or N documents are dirty, then
  issues ONE batched farm dispatch (``receive_messages`` →
  ``apply_changes(isolation="doc")``) and fans patches and sync replies
  back per session. Admission control (bounded per-tenant queues →
  ``BackpressureError``), quarantine-aware shedding (docs in the farm's
  quarantine set are rejected at admission — ``AdmissionRejectedError`` —
  and excluded from any flush they were queued into), and a flush policy
  that records batch occupancy so density is measurable.
- **Load harness** (``serve/loadgen.py``): drives
  10^4–10^6 simulated clients over the chaos transport in simulated time
  and reports p50/p95/p99 sync latency, e2e ops/s, batch occupancy, and
  shed/backpressure counts from amtrace.

See README "Serving" for the architecture sketch and the ``serve.*``
metric catalog.
"""
from __future__ import annotations

from .batcher import BatcherConfig, DynamicBatcher, FlushReport
from .loadgen import LoadConfig, LoadGen
from .server import AmServer, ClientChannel

__all__ = [
    "AmServer",
    "BatcherConfig",
    "ClientChannel",
    "DynamicBatcher",
    "FlushReport",
    "LoadConfig",
    "LoadGen",
]

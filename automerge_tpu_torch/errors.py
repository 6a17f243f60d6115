"""Error taxonomy for the merge pipeline: classifiable faults, compatible bases.

The farm's north star is untrusted multi-user traffic at batch scale, where
"a ValueError happened" is useless: the fault-isolation layer (tpu/farm.py)
must decide per document whether a delivery was structurally corrupt
(re-request it), causally invalid (quarantine the peer), or over a packing
limit (shed/split), and the obs counters need an ``error_kind`` dimension.
This module is the single vocabulary for those decisions.

Every concrete class multiply inherits the exception type the pre-taxonomy
code raised (``ValueError``/``TypeError``), so existing callers and tests
that catch the stdlib types keep working; new code should catch
``AutomergeError`` or a specific subclass. amlint rule AM401 enforces that
the data-plane modules (codecs, columnar, opset, sync, farm, rga, ...)
raise taxonomy errors rather than bare stdlib ones.

Hierarchy::

    AutomergeError
    ├── DecodeError(ValueError)        structurally invalid bytes
    │   ├── ChecksumError              container checksum / hash mismatch
    │   ├── StoreCorruptError          persisted segment fails its checksum/hash graph
    │   └── StoreTornWriteError        torn/short frame at a WAL segment tail
    ├── EncodeError(ValueError)        unencodable value / malformed op dict
    ├── CausalityError(ValueError)     seq reuse/skip, unknown pred/dep/ref
    ├── PackingLimitError(ValueError)  merge-key / MAX_ELEMS / interner caps
    ├── SyncProtocolError(ValueError)  malformed or inapplicable peer message
    │   ├── SyncFrameError             malformed session envelope (outer framing)
    │   ├── RetryExhaustedError        retransmission budget spent; channel quarantined
    │   └── ChannelQuarantinedError    traffic shed: the sync channel is quarantined
    ├── QuarantinedError               delivery shed: the doc is quarantined
    ├── NotPortedError                 needs a module this package has not ported yet
    ├── AdmissionRejectedError         serve front door refused the request at admission
    └── BackpressureError              serve front door: tenant queue full, retry later
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations


class AutomergeError(Exception):
    """Root of the taxonomy. ``kind`` is the obs/error-report dimension."""

    kind = "other"


class DecodeError(AutomergeError, ValueError):
    """Bytes that are not a structurally valid chunk/column/varint."""

    kind = "decode"


class ChecksumError(DecodeError):
    """Container checksum (or change-hash) does not match the data."""

    kind = "checksum"


class StoreCorruptError(DecodeError):
    """A persisted store segment is structurally complete but wrong: a
    frame checksum mismatch, a footer whose hash list disagrees with the
    rebuilt graph, or a compacted chunk that fails verification. Recovery
    quarantines the segment (and the documents it covers) rather than
    aborting the open; the docs are repairable via sync redelivery."""

    kind = "store_corrupt"


class StoreTornWriteError(DecodeError):
    """A short or torn frame at the tail of a write-ahead segment — the
    signature of a crash mid-append. Recovery truncates the segment at the
    last whole frame; everything before it is intact by construction."""

    kind = "store_torn"


class EncodeError(AutomergeError, ValueError):
    """A value or op dict that cannot be encoded into the wire format."""

    kind = "encode"


class CausalityError(AutomergeError, ValueError):
    """Causally invalid history: sequence number reuse or skip, duplicate
    opIds, predecessors/dependencies/list references that do not exist."""

    kind = "causality"


class PackingLimitError(AutomergeError, ValueError):
    """A device packing range would overflow: op counters beyond the
    merge-key range, list elements beyond the rank kernel's MAX_ELEMS, or
    an interner table past its bit-field cap."""

    kind = "packing"


class SyncProtocolError(AutomergeError, ValueError):
    """A peer sync message that is malformed or cannot be applied; local
    state is left untouched by the rejecting call."""

    kind = "sync"


class SyncFrameError(SyncProtocolError):
    """A session envelope (the outer seq/ack framing added by
    ``automerge_tpu.sync_session``) that is structurally invalid or fails
    its checksum; the inner reference wire format never saw the bytes and
    session state is untouched."""

    kind = "sync_frame"


class RetryExhaustedError(SyncProtocolError):
    """A supervised sync channel spent its full retransmission budget
    without an acknowledgement; the channel (not the document) is
    quarantined until ``SyncSession.release()``."""

    kind = "sync_retry"


class ChannelQuarantinedError(SyncProtocolError):
    """Traffic shed without processing: the sync channel is quarantined
    (see ``SyncSession.release``); the peer pair's documents stay live."""

    kind = "sync_quarantined"


class DeviceFaultError(AutomergeError):
    """The batched device program failed with this document's rows in the
    batch (isolated by the farm's dispatch bisection)."""

    kind = "device"


class WorkerCrashError(DeviceFaultError):
    """A mesh shard's worker process died (crash, kill, or unresponsive
    heartbeat). Documents whose delivery was in flight when the worker
    went down are quarantined with this error until released; the shard
    itself is respawned and re-hydrated from the controller's delivery
    log (see ``automerge_tpu.parallel.workers``)."""

    kind = "worker_crash"


class QuarantinedError(AutomergeError):
    """Delivery shed without processing: the target document is in the
    farm's quarantine set (see ``TpuDocFarm.release_quarantine``)."""

    kind = "quarantined"


class NotPortedError(AutomergeError, NotImplementedError):
    """The request needs a module of the JAX package that this package has
    not ported yet. ``slice_name`` names that module (for example
    ``"opset"`` for list/text documents, ``"sync_v2"`` for range-based
    sync); the call raises before anything commits."""

    kind = "not_ported"

    def __init__(self, slice_name: str, what: str):
        super().__init__(
            f"{what} needs the {slice_name!r} slice, which automerge_tpu_torch "
            "has not ported yet"
        )
        self.slice_name = slice_name


class AdmissionRejectedError(AutomergeError):
    """The serving front door (automerge_tpu.serve) refused a request at
    admission — e.g. the target document is in the farm's quarantine set,
    so queueing its traffic would only grow a batch the farm will shed.
    The client's retransmission path is the retry loop: once the cause
    clears (``release_quarantine``), the same frame is admitted."""

    kind = "admission"


class BackpressureError(AutomergeError):
    """The serving front door's bounded per-tenant queue is full: the
    tenant is submitting faster than the batcher drains. The request was
    not enqueued; the client should back off and retransmit (the session
    layer's timeout/backoff machinery does exactly that)."""

    kind = "backpressure"


def error_kind(exc: BaseException) -> str:
    """The ``error_kind`` dimension for one exception: the taxonomy class's
    ``kind``, or ``"other"`` for exceptions outside the taxonomy."""
    return getattr(exc, "kind", "other") if isinstance(exc, AutomergeError) else "other"


_KIND_INDEX: dict[str, type] = {}


def error_from_kind(kind: str, message: str) -> AutomergeError:
    """Rebuilds a taxonomy exception from its persisted ``kind`` dimension.

    The store's quarantine sidecar records causes as ``(kind, message)``
    pairs; hydration turns them back into catchable exceptions of the
    original class. Unknown kinds rebuild as the ``AutomergeError`` root
    so a newer sidecar never crashes an older reader."""
    if not _KIND_INDEX:
        stack: list[type] = [AutomergeError]
        while stack:
            cls = stack.pop()
            _KIND_INDEX.setdefault(cls.kind, cls)
            stack.extend(cls.__subclasses__())
    return _KIND_INDEX.get(kind, AutomergeError)(message)

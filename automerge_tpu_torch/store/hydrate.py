"""Batched cold-start hydration: ``ShardStore`` → ``TorchDocFarm``.

The naive cold start is a per-doc ``load()`` loop — one decode pass and
one farm delivery per document, paying the dispatch overhead
``num_docs`` times. ``open_farm`` instead feeds *every* recovered change
buffer through ``warm_decode_cache``'s vectorized decode path in one
shot, then replays the whole store as a single batched
``apply_changes`` delivery straight into farm pages (on the card unless
the caller asks for the CPU). After replay the
rebuilt hash graph is verified against the segment footers, documents a
corrupt segment covered are quarantined with their ``StoreCorruptError``
cause, and the persisted quarantine sidecar (causes + failure counts) is
restored — quarantine state survives save/load instead of silently
resetting.

Hydration happens *before* the store is attached to the farm, so the
replay is never re-logged into the WAL it just came from.

This module keeps its device-layer imports inside the functions: the
``store`` package stays importable without touching the device layer, and
only an actual hydration pulls in the farm.
"""
from __future__ import annotations

from ..errors import StoreCorruptError, error_from_kind
from ..obs.flight import get_flight
from ..obs.metrics import get_metrics
from .wal import ShardStore, StoreConfig

_METRICS = get_metrics()
_M_HYDRATE_DOCS = _METRICS.counter(
    "store.hydrate.docs", "documents hydrated into farm pages by open_farm"
)
_M_HYDRATE_CHANGES = _METRICS.counter(
    "store.hydrate.changes",
    "recovered changes replayed through the batched decode path",
)
_FLIGHT = get_flight()


def quarantine_snapshot(farm) -> dict:
    """The farm quarantine state the store persists as its sidecar: active
    causes (by taxonomy kind + message) and non-zero failure counts. JSON
    keys are strings; ``hydrate_farm`` undoes the coercion on restore."""
    return {
        "quarantine": {
            str(d): {"kind": getattr(exc, "kind", "other"), "message": str(exc)}
            for d, exc in farm.quarantine.items()
        },
        "fault_counts": {
            str(d): count
            for d, count in enumerate(farm.fault_counts) if count
        },
    }


def hydrate_farm(farm, store: ShardStore):
    """Replays a recovered store into ``farm`` as one batched delivery and
    restores the persisted fault-isolation state. Returns the store's
    ``RecoveryReport``. Call before ``farm.attach_store(store)``."""
    from ..tpu.decode import warm_decode_cache

    recovered = store.recovered_commits()
    per_doc: list[list] = [[] for _ in range(farm.num_docs)]
    total = 0
    for doc, buffers in recovered.items():
        if not 0 <= doc < farm.num_docs:
            raise StoreCorruptError(
                f"store covers doc {doc} but the farm has only "
                f"{farm.num_docs} slots — refusing to drop history"
            )
        per_doc[doc] = list(buffers)
        total += len(buffers)
    if total:
        warm_decode_cache([buf for bufs in per_doc for buf in bufs])
        farm.apply_changes(per_doc)
    store.drop_recovered()

    # hash-graph verification: every change a sealed/cold footer vouches
    # for must exist in the rebuilt graph, or the doc's history is a lie
    for doc, hashes in store.footer_hashes.items():
        if doc in store.corrupt_docs or doc >= farm.num_docs:
            continue
        index = farm.change_index_by_hash[doc]
        missing = sum(1 for h in hashes if h not in index)
        if missing:
            exc = StoreCorruptError(
                f"hash-graph verification failed for doc {doc}: {missing} "
                "footer hash(es) absent after replay — repair via sync "
                "redelivery"
            )
            store.corrupt_docs[doc] = exc
            store.report.corrupt_docs[doc] = exc

    for doc, exc in store.corrupt_docs.items():
        if doc < farm.num_docs:
            farm.quarantine[doc] = exc

    snapshot = store.load_quarantine()
    if snapshot:
        for key, cause in snapshot.get("quarantine", {}).items():
            doc = int(key)
            if doc < farm.num_docs and doc not in farm.quarantine:
                farm.quarantine[doc] = error_from_kind(
                    cause.get("kind", "other"), cause.get("message", "")
                )
        for key, count in snapshot.get("fault_counts", {}).items():
            doc = int(key)
            if doc < farm.num_docs:
                farm.fault_counts[doc] = int(count)

    if _METRICS.enabled:
        _M_HYDRATE_DOCS.inc(sum(1 for bufs in per_doc if bufs))
        _M_HYDRATE_CHANGES.inc(total)
    if _FLIGHT.enabled:
        _FLIGHT.record(
            "store.hydrate", root=store.root,
            docs=sum(1 for bufs in per_doc if bufs), changes=total,
            quarantined=len(farm.quarantine),
        )
    return store.report


def open_farm(root, num_docs: int | None = None, *,
              store_config: StoreConfig | None = None,
              farm=None, farm_factory=None, device="cuda", **farm_kwargs):
    """Opens (and thereby recovers) the shard store at ``root``, hydrates a
    farm from it in one batched delivery, and attaches the store so every
    subsequent committed delivery is WAL-durable before its ack.

    Pass an existing ``farm``, a ``farm_factory`` callable, or ``num_docs``
    (plus ``TorchDocFarm`` kwargs) to construct one on ``device``: the
    card unless the caller asks for the CPU (``device="cpu"``). Without
    CUDA a card request raises before the store is opened, so recovery
    never touches the directory. Returns ``(farm, store)``; the recovery
    details are on ``store.report``."""
    if farm is None and farm_factory is None:
        import torch

        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "open_farm hydrates on the card by default and CUDA is not "
                "available here; pass device='cpu' to run on the CPU"
            )
    store = ShardStore(root, store_config)
    try:
        if farm is None:
            if farm_factory is not None:
                farm = farm_factory()
            elif num_docs is None:
                raise ValueError(
                    "open_farm needs a farm, a farm_factory, or num_docs"
                )
            else:
                from ..tpu.farm import TorchDocFarm

                farm = TorchDocFarm(num_docs, device=device, **farm_kwargs)
        hydrate_farm(farm, store)
    except BaseException:
        store.close()
        raise
    farm.attach_store(store)
    return farm, store

"""automerge_tpu_torch: a CRDT framework with the capabilities of Automerge,
whose document merge farm and batched sync run in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``automerge_tpu``, which stays beside it as the
reference. This package imports neither JAX nor anything of
``automerge_tpu``: the host-only modules it needs are its own copies.
Entry points that touch a device run on the card unless the caller asks
for the CPU (``device="cpu"``).

The public API (port of the reference implementation's src/automerge.js)
works on one document at a time, on the host: every function takes an
immutable document and returns a new one.

    import automerge_tpu_torch as am

    doc = am.init("aa" * 16)                    # fixed actor id
    doc = am.change(doc, {"time": 0}, lambda d: d.update({"title": "x"}))
    data = am.save(doc)                         # bytes, as the JAX package's
    assert am.equals(am.load(data), doc)

The batched farm merges thousands of documents on the card, fed by the
changes the API produces, and syncs them with peers in batches:

    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    farm = TorchDocFarm(num_docs=1024)          # on the card
    buffers = [[] for _ in range(1024)]         # one change list per doc
    buffers[0] = am.get_all_changes(doc)
    farm.apply_changes(buffers)                 # one merge for the batch
    sync = SyncFarm(farm)
    session = sync.make_session(0)              # one supervised channel

A single-document peer runs over ``backend`` with ``SyncSession`` and
``BackendDriver``; ``encode_sync_state``/``decode_sync_state`` persist a
channel's sync state. A durable server hydrates from its write-ahead log
and serves clients through the batching front door:

    from automerge_tpu_torch.serve import AmServer
    from automerge_tpu_torch.store import open_farm

    farm, store = open_farm("shard-000", num_docs=1024)  # cold start
    server = AmServer(farm)                     # sessions + DynamicBatcher

``set_default_backend()`` swaps the module the API's documents run over.
The default, and the only one this package ships, is ``backend``: the
sequential pure-Python engine. No backend runs the API on the farm.
"""
from __future__ import annotations

from . import backend as _default_backend
from . import sync as _sync
from . import uuid as _uuid_module
from . import frontend as Frontend
from .columnar import decode_change, encode_change
from .errors import (
    AdmissionRejectedError,
    AutomergeError,
    BackpressureError,
    CausalityError,
    ChannelQuarantinedError,
    ChecksumError,
    DecodeError,
    DeviceFaultError,
    EncodeError,
    NotPortedError,
    PackingLimitError,
    QuarantinedError,
    RetryExhaustedError,
    StoreCorruptError,
    StoreTornWriteError,
    SyncFrameError,
    SyncProtocolError,
    WorkerCrashError,
)
from .sync import decode_sync_state, encode_sync_state
from .sync_session import BackendDriver, SessionConfig, SyncSession
from .frontend import (
    Counter,
    Float64,
    Int,
    List,
    Map,
    Observable,
    Table,
    Text,
    Uint,
    get_actor_id,
    get_backend_state,
    get_conflicts,
    get_element_ids,
    get_last_local_change,
    get_object_by_id,
    get_object_id,
    set_actor_id,
)
__version__ = "0.1.0"

__all__ = [
    "init", "from_data", "change", "empty_change", "clone", "free",
    "load", "save", "merge", "get_changes", "get_all_changes", "apply_changes",
    "encode_change", "decode_change", "equals", "get_history", "uuid",
    "Frontend", "set_default_backend", "get_backend",
    "generate_sync_message", "receive_sync_message", "init_sync_state",
    "encode_sync_state", "decode_sync_state",
    "SyncSession", "SessionConfig", "BackendDriver",
    "get_object_id", "get_object_by_id", "get_actor_id", "set_actor_id",
    "get_conflicts", "get_last_local_change", "get_element_ids",
    "Text", "Table", "Counter", "Observable", "Int", "Uint", "Float64",
    "Map", "List",
    "AutomergeError", "DecodeError", "ChecksumError", "EncodeError",
    "CausalityError", "PackingLimitError", "SyncProtocolError",
    "SyncFrameError", "RetryExhaustedError", "ChannelQuarantinedError",
    "QuarantinedError", "DeviceFaultError", "WorkerCrashError",
    "StoreCorruptError", "StoreTornWriteError",
    "AdmissionRejectedError", "BackpressureError", "NotPortedError",
    "TorchDocFarm", "SyncFarm",
]

_backend = _default_backend  # swappable via set_default_backend()

# the farm entry points import torch and the device layer: bound on first
# use, so the host-only API (and the obs CLI's renderers) load without them
_DEVICE_ENTRY_POINTS = {
    "TorchDocFarm": (".tpu.farm", "TorchDocFarm"),
    "SyncFarm": (".tpu.sync_farm", "SyncFarm"),
}


def __getattr__(name):
    entry = _DEVICE_ENTRY_POINTS.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(entry[0], __name__), entry[1])
    globals()[name] = value
    return value


def uuid():
    return _uuid_module.make_uuid()


def init(options=None):
    if isinstance(options, str):
        options = {"actorId": options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f"Unsupported options for init(): {options!r}")
    return Frontend.init(dict({"backend": _backend}, **options))


def from_data(initial_state, options=None):
    """Returns a new document initialized with the given state."""
    return change(init(options), {"message": "Initialization"},
                  lambda doc: doc.update(initial_state))


def change(doc, options=None, callback=None):
    new_doc, _request = Frontend.change(doc, options, callback)
    return new_doc


def empty_change(doc, options=None):
    new_doc, _request = Frontend.empty_change(doc, options)
    return new_doc


def _normalize_options(options):
    if isinstance(options, str):
        return {"actorId": options}
    return dict(options) if options else {}


def clone(doc, options=None):
    options = _normalize_options(options)
    state = _backend.clone(Frontend.get_backend_state(doc, "clone"))
    return _apply_patch(init(options), _backend.get_patch(state), state, [], options)


def free(doc):
    _backend.free(Frontend.get_backend_state(doc, "free"))


def load(data, options=None):
    options = _normalize_options(options)
    state = _backend.load(data)
    return _apply_patch(init(options), _backend.get_patch(state), state, [data], options)


def save(doc):
    return _backend.save(Frontend.get_backend_state(doc, "save"))


def merge(local_doc, remote_doc):
    local_state = Frontend.get_backend_state(local_doc, "merge")
    remote_state = Frontend.get_backend_state(remote_doc, "merge", "second")
    changes = _backend.get_changes_added(local_state, remote_state)
    updated_doc, _patch = apply_changes(local_doc, changes)
    return updated_doc


def get_changes(old_doc, new_doc):
    old_state = Frontend.get_backend_state(old_doc, "get_changes")
    new_state = Frontend.get_backend_state(new_doc, "get_changes", "second")
    return _backend.get_changes(new_state, _backend.get_heads(old_state))


def get_all_changes(doc):
    return _backend.get_all_changes(Frontend.get_backend_state(doc, "get_all_changes"))


def _apply_patch(doc, patch, backend_state, changes, options):
    new_doc = Frontend.apply_patch(doc, patch, backend_state)
    patch_callback = options.get("patchCallback") or doc._options.get("patchCallback")
    if patch_callback:
        patch_callback(patch, doc, new_doc, False, changes)
    return new_doc


def apply_changes(doc, changes, options=None):
    old_state = Frontend.get_backend_state(doc, "apply_changes")
    new_state, patch = _backend.apply_changes(old_state, changes)
    return _apply_patch(doc, patch, new_state, changes, options or {}), patch


def equals(val1, val2):
    """Deep structural equality on document values."""
    if isinstance(val1, (Map, dict)) and isinstance(val2, (Map, dict)):
        if sorted(val1.keys()) != sorted(val2.keys()):
            return False
        return all(equals(val1[k], val2[k]) for k in val1.keys())
    if isinstance(val1, (List, list)) and isinstance(val2, (List, list)):
        return len(val1) == len(val2) and all(equals(a, b) for a, b in zip(val1, val2))
    return val1 == val2


class _HistoryEntry:
    __slots__ = ("_binary", "_history", "_index", "_actor")

    def __init__(self, binary, history, index, actor):
        self._binary = binary
        self._history = history
        self._index = index
        self._actor = actor

    @property
    def change(self):
        return decode_change(self._binary)

    @property
    def snapshot(self):
        state = _backend.load_changes(_backend.init(), self._history[: self._index + 1])
        return Frontend.apply_patch(init(self._actor), _backend.get_patch(state), state)


def get_history(doc):
    """Returns the change history with lazy snapshot reconstruction
    (the reference implementation's src/automerge.js:105)."""
    actor = Frontend.get_actor_id(doc)
    history = get_all_changes(doc)
    return [
        _HistoryEntry(binary, history, index, actor) for index, binary in enumerate(history)
    ]


def generate_sync_message(doc, sync_state):
    state = Frontend.get_backend_state(doc, "generate_sync_message")
    return _sync.generate_sync_message(state, sync_state)


def receive_sync_message(doc, old_sync_state, message):
    old_backend_state = Frontend.get_backend_state(doc, "receive_sync_message")
    backend_state, sync_state, patch = _sync.receive_sync_message(
        old_backend_state, old_sync_state, message
    )
    if patch is None:
        return doc, sync_state, patch
    changes = None
    if doc._options.get("patchCallback"):
        changes = _sync.decode_sync_message(message)["changes"]
    return _apply_patch(doc, patch, backend_state, changes, {}), sync_state, patch


def init_sync_state():
    return _sync.init_sync_state()


def set_default_backend(new_backend):
    """Swaps the module the API's documents run over. It must offer the
    functions of ``backend.py``; this package ships no other such module."""
    global _backend
    _backend = new_backend


def get_backend():
    return _backend

"""Backend API: a stateless function facade over the OpSet engine.

The port's own copy of the JAX package's ``backend.py`` (a host-only
module; the reference implementation's backend/backend.js), over this
package's ``opset.OpSet``. Wraps the engine state in a `BackendHandle`
with move-semantics (old handles are frozen after use, backend/util.js:1-10)
so stale states cannot be mutated accidentally.

This module is the single-document backend the sequential sync protocol
(``sync.generate_sync_message``/``receive_sync_message``, ``sync_v2``) and
``sync_session.BackendDriver`` run over; the batched farm is ``tpu/farm.py``.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

from .columnar import encode_change
from .obs.metrics import get_metrics
from .obs.spans import get_trace
from .opset import OpSet

_M_CHANGES_APPLIED = get_metrics().counter(
    "backend.changes.applied", "changes applied through the backend facade"
)


class BackendHandle:
    __slots__ = ("state", "heads", "frozen")

    def __init__(self, state, heads):
        self.state = state
        self.heads = heads
        self.frozen = False


def _backend_state(backend: BackendHandle) -> OpSet:
    if backend.frozen:
        raise ValueError(
            "Attempting to use an outdated Automerge document that has already been updated. "
            "Please use the latest document state, or call Automerge.clone() if you really "
            "need to use this old document state."
        )
    return backend.state


def init() -> BackendHandle:
    return BackendHandle(OpSet(), [])


def clone(backend: BackendHandle) -> BackendHandle:
    return BackendHandle(_backend_state(backend).clone(), backend.heads)


def free(backend: BackendHandle) -> None:
    backend.state = None
    backend.frozen = True


def apply_changes(backend: BackendHandle, changes):
    state = _backend_state(backend)
    with get_trace().span("backend.apply_changes"):
        patch = state.apply_changes(changes)
    _M_CHANGES_APPLIED.inc(len(changes))
    backend.frozen = True
    return BackendHandle(state, state.heads), patch


def _hash_by_actor(state: OpSet, actor_id: str, index: int) -> str:
    hashes = state.hashes_by_actor.get(actor_id)
    if hashes and index < len(hashes) and hashes[index]:
        return hashes[index]
    if not state.have_hash_graph:
        state.compute_hash_graph()
        hashes = state.hashes_by_actor.get(actor_id)
        if hashes and index < len(hashes) and hashes[index]:
            return hashes[index]
    raise ValueError(f"Unknown change: actorId = {actor_id}, seq = {index + 1}")


def apply_local_change(backend: BackendHandle, change):
    """Applies a change request from the local frontend; returns
    (new_backend, patch, binary_change). Adds the local actor's previous
    change hash to deps (backend.js:54-91)."""
    state = _backend_state(backend)
    if change["seq"] <= state.clock.get(change["actor"], 0):
        raise ValueError("Change request has already been applied")

    if change["seq"] > 1:
        last_hash = _hash_by_actor(state, change["actor"], change["seq"] - 2)
        if not last_hash:
            raise ValueError(f"Cannot find hash of localChange before seq={change['seq']}")
        deps = {last_hash: True}
        for h in change["deps"]:
            deps[h] = True
        change = dict(change, deps=sorted(deps.keys()))

    binary_change = encode_change(change)
    with get_trace().span("backend.apply_local_change"):
        patch = state.apply_changes([binary_change], is_local=True)
    _M_CHANGES_APPLIED.inc()
    backend.frozen = True

    # On the outgoing patch, omit the last local change hash
    last_hash = _hash_by_actor(state, change["actor"], change["seq"] - 1)
    patch["deps"] = [head for head in patch["deps"] if head != last_hash]
    return BackendHandle(state, state.heads), patch, binary_change


def save(backend: BackendHandle) -> bytes:
    with get_trace().span("backend.save"):
        return _backend_state(backend).save()


def load(data) -> BackendHandle:
    with get_trace().span("backend.load"):
        state = OpSet(data)
    return BackendHandle(state, state.heads)


def load_changes(backend: BackendHandle, changes) -> BackendHandle:
    """Applies changes without building a patch (faster for bulk loads)."""
    state = _backend_state(backend)
    state.apply_changes(changes)
    backend.frozen = True
    return BackendHandle(state, state.heads)


def get_patch(backend: BackendHandle):
    with get_trace().span("backend.get_patch"):
        return _backend_state(backend).get_patch()


def get_heads(backend: BackendHandle):
    return backend.heads


def get_all_changes(backend: BackendHandle):
    return get_changes(backend, [])


def get_changes(backend: BackendHandle, have_deps):
    if not isinstance(have_deps, list):
        raise TypeError("Pass a list of hashes to get_changes()")
    return _backend_state(backend).get_changes(have_deps)


def get_changes_added(backend1: BackendHandle, backend2: BackendHandle):
    return _backend_state(backend2).get_changes_added(_backend_state(backend1))


def get_change_by_hash(backend: BackendHandle, hash_):
    return _backend_state(backend).get_change_by_hash(hash_)


def get_missing_deps(backend: BackendHandle, heads=()):
    return _backend_state(backend).get_missing_deps(heads)

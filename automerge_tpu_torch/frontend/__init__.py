"""Frontend: the document layer. Knows the actorId, assigns opIds to local
changes, and materialises Python objects from backend patches.

The port's own copy of the JAX package's ``frontend/`` (the reference
implementation's frontend/index.js). Talks to the backend only via two
message types: change requests (frontend -> backend) and patches (backend ->
frontend); both are plain JSON-able dicts, so the backend can be any module
with the ``backend.py`` functions (this package's pure-Python ``backend``
by default) or a remote process.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import time as _time

from ..uuid import make_uuid
from ..common import check_actor_id
from .apply_patch import clone_root_object, interpret_patch
from .context import Context
from .datatypes import (
    Counter,
    Float64,
    Int,
    List,
    Map,
    Table,
    Text,
    Uint,
)
from .observable import Observable
from .proxies import root_object_proxy

__all__ = [
    "init", "from_data", "change", "empty_change", "apply_patch",
    "get_object_id", "get_object_by_id", "get_actor_id", "set_actor_id",
    "get_conflicts", "get_last_local_change", "get_backend_state",
    "get_element_ids", "Context",
    "Text", "Table", "Counter", "Observable", "Float64", "Int", "Uint",
    "Map", "List",
]


def _update_root_object(doc, updated, state):
    """Returns a new immutable document root reflecting `updated` objects
    (index.js:34)."""
    new_doc = updated.get("_root")
    if new_doc is None:
        new_doc = clone_root_object(doc._cache["_root"])
        updated["_root"] = new_doc
    new_doc._options = doc._options
    new_doc._cache = updated
    new_doc._state = state
    for object_id, obj in doc._cache.items():
        if object_id not in updated:
            updated[object_id] = obj
    return new_doc


def _count_ops(ops):
    count = 0
    for op in ops:
        if op["action"] == "set" and "values" in op:
            count += len(op["values"])
        else:
            count += 1
    return count


def _make_change(doc, context, options):
    """Builds a change request from the context and round-trips it through
    the backend (index.js:78)."""
    actor = get_actor_id(doc)
    if not actor:
        raise ValueError("Actor ID must be initialized with set_actor_id() before making a change")
    state = dict(doc._state)
    state["seq"] += 1

    options = options or {}
    change_request = {
        "actor": actor,
        "seq": state["seq"],
        "startOp": state["maxOp"] + 1,
        "deps": state["deps"],
        "time": options["time"] if isinstance(options.get("time"), (int, float)) else round(_time.time()),
        "message": options.get("message") if isinstance(options.get("message"), str) else "",
        "ops": context.ops,
    }

    backend = doc._options.get("backend")
    if backend is not None:
        backend_state, patch, binary_change = backend.apply_local_change(
            state["backendState"], change_request
        )
        state["backendState"] = backend_state
        state["lastLocalChange"] = binary_change
        new_doc = _apply_patch_to_doc(doc, patch, state, True)
        patch_callback = options.get("patchCallback") or doc._options.get("patchCallback")
        if patch_callback:
            patch_callback(patch, doc, new_doc, True, [binary_change])
        return new_doc, change_request

    queued_request = {"actor": actor, "seq": change_request["seq"], "before": doc}
    state["requests"] = state["requests"] + [queued_request]
    state["maxOp"] = state["maxOp"] + _count_ops(change_request["ops"])
    state["deps"] = []
    return _update_root_object(doc, context.updated if context else {}, state), change_request


def get_last_local_change(doc):
    return doc._state.get("lastLocalChange")


def _apply_patch_to_doc(doc, patch, state, from_backend):
    actor = get_actor_id(doc)
    updated = {}
    interpret_patch(patch["diffs"], doc, updated)
    if from_backend:
        if "clock" not in patch:
            raise ValueError("patch is missing clock field")
        if patch["clock"].get(actor, 0) > state["seq"]:
            state["seq"] = patch["clock"][actor]
        state["clock"] = patch["clock"]
        state["deps"] = patch["deps"]
        state["maxOp"] = max(state["maxOp"], patch["maxOp"])
    return _update_root_object(doc, updated, state)


def init(options=None):
    """Creates an empty document object with no changes (index.js:166)."""
    if isinstance(options, str):
        options = {"actorId": options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f"Unsupported value for init() options: {options!r}")
    else:
        options = dict(options)

    if not options.get("deferActorId"):
        if options.get("actorId") is None:
            options["actorId"] = make_uuid()
        check_actor_id(options["actorId"])

    if options.get("observable"):
        patch_callback = options.get("patchCallback")
        observable = options["observable"]

        def combined(patch, before, after, local, changes):
            if patch_callback:
                patch_callback(patch, before, after, local, changes)
            observable.patch_callback(patch, before, after, local, changes)

        options["patchCallback"] = combined

    root = Map()
    root._object_id = "_root"
    cache = {"_root": root}
    state = {"seq": 0, "maxOp": 0, "requests": [], "clock": {}, "deps": []}
    if options.get("backend") is not None:
        state["backendState"] = options["backend"].init()
        state["lastLocalChange"] = None
    root._options = options
    root._cache = cache
    root._state = state
    return root


def from_data(initial_state, options=None):
    """Returns a new document initialized with the given state (index.js:207)."""
    return change(init(options), {"message": "Initialization"},
                  lambda doc: doc.update(initial_state))


def change(doc, options=None, callback=None):
    """Makes a local change via a mutation callback; returns (doc, request)
    (index.js:224)."""
    if doc._object_id != "_root":
        raise TypeError("The first argument to change() must be the document root")
    if callable(options) and callback is None:
        options, callback = None, options
    if isinstance(options, str):
        options = {"message": options}
    if options is not None and not isinstance(options, dict):
        raise TypeError("Unsupported type of options")

    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError("Actor ID must be initialized with set_actor_id() before making a change")
    context = Context(doc, actor_id)
    callback(root_object_proxy(context))

    if not context.updated:
        return doc, None
    return _make_change(doc, context, options)


def empty_change(doc, options=None):
    """Makes a change containing no operations (index.js:264)."""
    if doc._object_id != "_root":
        raise TypeError("The first argument to empty_change() must be the document root")
    if isinstance(options, str):
        options = {"message": options}
    if options is not None and not isinstance(options, dict):
        raise TypeError("Unsupported type of options")
    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError("Actor ID must be initialized with set_actor_id() before making a change")
    return _make_change(doc, Context(doc, actor_id), options)


def apply_patch(doc, patch, backend_state=None):
    """Applies a backend patch to the document root (index.js:288)."""
    if doc._object_id != "_root":
        raise TypeError("The first argument to apply_patch() must be the document root")
    state = dict(doc._state)

    if doc._options.get("backend") is not None:
        if backend_state is None:
            raise ValueError("apply_patch() must be called with the updated backend state")
        state["backendState"] = backend_state
        return _apply_patch_to_doc(doc, patch, state, True)

    if state["requests"]:
        base_doc = state["requests"][0]["before"]
        if patch.get("actor") == get_actor_id(doc):
            if state["requests"][0]["seq"] != patch.get("seq"):
                raise ValueError(
                    f"Mismatched sequence number: patch {patch.get('seq')} does not match "
                    f"next request {state['requests'][0]['seq']}"
                )
            state["requests"] = state["requests"][1:]
        else:
            state["requests"] = list(state["requests"])
    else:
        base_doc = doc
        state["requests"] = []

    new_doc = _apply_patch_to_doc(base_doc, patch, state, True)
    if not state["requests"]:
        return new_doc
    state["requests"][0] = dict(state["requests"][0])
    state["requests"][0]["before"] = new_doc
    return _update_root_object(doc, {}, state)


def get_object_id(obj):
    return getattr(obj, "_object_id", None)


def get_object_by_id(doc, object_id):
    return doc._cache.get(object_id)


def get_actor_id(doc):
    return doc._state.get("actorId") or doc._options.get("actorId")


def set_actor_id(doc, actor_id):
    check_actor_id(actor_id)
    state = dict(doc._state)
    state["actorId"] = actor_id
    return _update_root_object(doc, {}, state)


def get_conflicts(obj, key):
    """Returns the conflicting values at `key` if there is more than one
    (index.js:374)."""
    conflicts = getattr(obj, "_conflicts", None)
    if conflicts is None:
        return None
    try:
        entry = conflicts[key]
    except (KeyError, IndexError, TypeError):
        return None
    if entry and len(entry) > 1:
        return dict(entry)
    return None


def get_backend_state(doc, caller_name=None, arg_pos="first"):
    if doc is None or getattr(doc, "_object_id", None) != "_root":
        if caller_name:
            raise TypeError(
                f"The {arg_pos} argument to {caller_name} must be the document root"
            )
        raise TypeError("Argument is not an Automerge document root")
    return doc._state["backendState"]


def get_element_ids(lst):
    """Element IDs of each list element / text character (index.js:403)."""
    if isinstance(lst, Text):
        return [elem["elemId"] for elem in lst.elems]
    return list(lst._elem_ids)

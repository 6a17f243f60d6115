"""Mutable proxy wrappers handed to change callbacks.

The Python equivalent of the reference's ES6 Proxy layer
(the reference implementation's frontend/proxies.js): MapProxy/ListProxy translate Python
mutation idioms (item assignment, append, slicing, del) into Context calls.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

from .context import get_elem_id
from .datatypes import List, Map, Table, Text, WriteableTable


class MapProxy:
    """Mutable view of a map object inside a change block."""

    __slots__ = ("_context", "_object_id", "_path")

    def __init__(self, context, object_id, path):
        object.__setattr__(self, "_context", context)
        object.__setattr__(self, "_object_id", object_id)
        object.__setattr__(self, "_path", path)

    def _target(self):
        return self._context.get_object(self._object_id)

    # -- reads ---------------------------------------------------------------
    def __getitem__(self, key):
        if key not in self._target():
            raise KeyError(key)
        return self._context.get_object_field(self._path, self._object_id, key)

    def get(self, key, default=None):
        if key in self._target():
            return self._context.get_object_field(self._path, self._object_id, key)
        return default

    def __contains__(self, key):
        return key in self._target()

    def __len__(self):
        return len(self._target())

    def __iter__(self):
        return iter(self._target())

    def keys(self):
        return self._target().keys()

    def values(self):
        return [self[k] for k in self._target()]

    def items(self):
        return [(k, self[k]) for k in self._target()]

    def object_id(self):
        return self._object_id

    def __repr__(self):
        return f"MapProxy({dict(self._target())!r})"

    # -- writes --------------------------------------------------------------
    def __setitem__(self, key, value):
        self._context.set_map_key(self._path, key, value)

    def __delitem__(self, key):
        self._context.delete_map_key(self._path, key)

    def update(self, other):
        for key, value in other.items():
            self[key] = value

    def increment(self, key, delta=1):
        self._context.increment(self._path, key, delta)

    def __eq__(self, other):
        if isinstance(other, MapProxy):
            return dict(self._target()) == dict(other._target())
        if isinstance(other, dict):
            return dict(self._target()) == other
        return NotImplemented


class ListProxy:
    """Mutable view of a list object inside a change block."""

    __slots__ = ("_context", "_object_id", "_path")

    def __init__(self, context, object_id, path):
        self._context = context
        self._object_id = object_id
        self._path = path

    def _target(self):
        return self._context.get_object(self._object_id)

    # -- reads ---------------------------------------------------------------
    def __len__(self):
        return len(self._target())

    def __getitem__(self, index):
        target = self._target()
        if isinstance(index, slice):
            return [
                self._context.get_object_field(self._path, self._object_id, i)
                for i in range(*index.indices(len(target)))
            ]
        if index < 0:
            index += len(target)
        if not (0 <= index < len(target)):
            raise IndexError(index)
        return self._context.get_object_field(self._path, self._object_id, index)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def index(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        raise ValueError(f"{value!r} is not in list")

    def __contains__(self, value):
        return any(v == value for v in self)

    def object_id(self):
        return self._object_id

    def __repr__(self):
        return f"ListProxy({list(self._target())!r})"

    def __eq__(self, other):
        if isinstance(other, ListProxy):
            return list(self._target()) == list(other._target())
        if isinstance(other, list):
            return list(self._target()) == other
        return NotImplemented

    # -- writes --------------------------------------------------------------
    def __setitem__(self, index, value):
        if isinstance(index, slice):
            start, stop, step = index.indices(len(self._target()))
            if step != 1:
                raise ValueError("Extended slices are not supported in change blocks")
            self._context.splice(self._path, start, max(0, stop - start), list(value))
            return
        if index < 0:
            index += len(self._target())
        self._context.set_list_index(self._path, index, value)

    def __delitem__(self, index):
        if isinstance(index, slice):
            start, stop, step = index.indices(len(self._target()))
            if step != 1:
                raise ValueError("Extended slices are not supported in change blocks")
            self._context.splice(self._path, start, max(0, stop - start), [])
            return
        if index < 0:
            index += len(self._target())
        self._context.splice(self._path, index, 1, [])

    def append(self, value):
        self._context.splice(self._path, len(self._target()), 0, [value])

    def extend(self, values):
        self._context.splice(self._path, len(self._target()), 0, list(values))

    def insert(self, index, value):
        self._context.splice(self._path, index, 0, [value])

    def insert_at(self, index, *values):
        self._context.splice(self._path, index, 0, list(values))
        return self

    def delete_at(self, index, num_delete=1):
        self._context.splice(self._path, index, num_delete, [])
        return self

    def pop(self, index=-1):
        target = self._target()
        if index < 0:
            index += len(target)
        value = self[index]
        self._context.splice(self._path, index, 1, [])
        return value

    def splice(self, start, deletions=0, insertions=()):
        self._context.splice(self._path, start, deletions, list(insertions))

    def increment(self, index, delta=1):
        self._context.increment(self._path, index, delta)

    def elem_id(self, index):
        return get_elem_id(self._target(), index)


def instantiate_proxy(context, path, object_id):
    obj = context.get_object(object_id)
    if isinstance(obj, Text):
        return obj.get_writeable(context, path)
    if isinstance(obj, Table):
        return WriteableTable(context, path, obj)
    if isinstance(obj, (List, list)) and not isinstance(obj, Map):
        return ListProxy(context, object_id, path)
    return MapProxy(context, object_id, path)


def root_object_proxy(context):
    """Returns the root proxy for a change callback (proxies.js:258)."""

    def instantiate_object(path, object_id):
        return instantiate_proxy(context, path, object_id)

    context.instantiate_object = instantiate_object
    return MapProxy(context, "_root", [])

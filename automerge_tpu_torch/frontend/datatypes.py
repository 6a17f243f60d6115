"""Frontend document value types: Map, List, Text, Table, Counter and the
explicit numeric wrappers.

Python equivalents of the reference's document layer types
(the reference implementation's frontend/{text,table,counter,numbers}.js and the frozen
map/list objects produced by apply_patch.js). Documents are immutable
outside of change blocks: Map/List subclass dict/list but refuse mutation
unless instantiated as writable working copies by the patch interpreter.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import datetime as _dt

from ..common import parse_op_id


class Int:
    """Explicit int64 datatype wrapper (numbers.js:3)."""

    __slots__ = ("value",)

    def __init__(self, value):
        if not isinstance(value, int) or isinstance(value, bool):
            raise ValueError("Value must be an integer")
        if not (-(2**53 - 1) <= value <= 2**53 - 1):
            raise ValueError("Value out of range")
        self.value = value


class Uint:
    """Explicit uint64 datatype wrapper (numbers.js:13)."""

    __slots__ = ("value",)

    def __init__(self, value):
        if not isinstance(value, int) or isinstance(value, bool):
            raise ValueError("Value must be an integer")
        if not (0 <= value <= 2**53 - 1):
            raise ValueError("Value out of range")
        self.value = value


class Float64:
    """Explicit IEEE754 double datatype wrapper (numbers.js:23)."""

    __slots__ = ("value",)

    def __init__(self, value):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise ValueError("Value must be a number")
        self.value = float(value)


class Counter:
    """A commutative increment-only register (counter.js:6). Behaves like an
    int in comparisons and arithmetic."""

    def __init__(self, value=0):
        self.value = value

    def __int__(self):
        return self.value

    def __index__(self):
        return self.value

    def __eq__(self, other):
        if isinstance(other, Counter):
            return self.value == other.value
        return self.value == other

    def __hash__(self):
        return hash(self.value)

    def __add__(self, other):
        return self.value + other

    def __radd__(self, other):
        return other + self.value

    def __sub__(self, other):
        return self.value - other

    def __lt__(self, other):
        return self.value < (other.value if isinstance(other, Counter) else other)

    def __le__(self, other):
        return self.value <= (other.value if isinstance(other, Counter) else other)

    def __gt__(self, other):
        return self.value > (other.value if isinstance(other, Counter) else other)

    def __ge__(self, other):
        return self.value >= (other.value if isinstance(other, Counter) else other)

    def __repr__(self):
        return f"Counter({self.value})"

    def increment(self, delta=1):
        raise TypeError("Counters can only be incremented inside a change block")

    def decrement(self, delta=1):
        raise TypeError("Counters can only be decremented inside a change block")


class WriteableCounter(Counter):
    """Counter bound to a change context (counter.js:46)."""

    def __init__(self, value, context, path, object_id, key):
        super().__init__(value)
        self._context = context
        self._path = path
        self._object_id = object_id
        self._key = key

    def increment(self, delta=1):
        self._context.increment(self._path, self._key, delta)
        self.value += delta
        return self.value

    def decrement(self, delta=1):
        return self.increment(-delta)


class Map(dict):
    """An immutable map object in a document. Mutation must go through a
    change block's proxy."""

    __slots__ = ("_object_id", "_conflicts", "_options", "_cache", "_state")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._object_id = None
        self._conflicts = {}
        self._options = None
        self._cache = None
        self._state = None

    def _forbid(self, *a, **k):
        raise TypeError(
            "This object is read-only outside of a change block. "
            "Use automerge_tpu_torch.change() to modify the document."
        )

    __setitem__ = _forbid
    __delitem__ = _forbid
    clear = _forbid
    pop = _forbid
    popitem = _forbid
    setdefault = _forbid
    update = _forbid

    def _unsafe_set(self, key, value):
        dict.__setitem__(self, key, value)

    def _unsafe_delete(self, key):
        dict.__delitem__(self, key)


class List(list):
    """An immutable list object in a document."""

    __slots__ = ("_object_id", "_conflicts", "_elem_ids")

    def __init__(self, *args):
        super().__init__(*args)
        self._object_id = None
        self._conflicts = []
        self._elem_ids = []

    def _forbid(self, *a, **k):
        raise TypeError(
            "This object is read-only outside of a change block. "
            "Use automerge_tpu_torch.change() to modify the document."
        )

    __setitem__ = _forbid
    __delitem__ = _forbid
    __iadd__ = _forbid
    append = _forbid
    extend = _forbid
    insert = _forbid
    pop = _forbid
    remove = _forbid
    reverse = _forbid
    sort = _forbid
    clear = _forbid

    def _unsafe(self):
        return super()


class Text:
    """A sequence-of-graphemes CRDT (text.js:4). Internally a list of elems
    {elemId, pred, value}."""

    def __init__(self, text=None):
        if isinstance(text, str):
            self.elems = [{"value": ch} for ch in text]
        elif isinstance(text, (list, tuple)):
            self.elems = [{"value": v} for v in text]
        elif text is None:
            self.elems = []
        else:
            raise TypeError(f"Unsupported initial value for Text: {text!r}")
        self._object_id = None
        self.context = None
        self.path = None

    def __len__(self):
        return len(self.elems)

    def get(self, index):
        value = self.elems[index]["value"]
        if self.context is not None and isinstance(value, (Map, List, Text, Table)):
            object_id = value._object_id
            path = self.path + [{"key": index, "objectId": object_id}]
            return self.context.instantiate_object(path, object_id)
        return value

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self.get(i) for i in range(*index.indices(len(self.elems)))]
        return self.get(index)

    def get_elem_id(self, index):
        return self.elems[index]["elemId"]

    def __iter__(self):
        for elem in self.elems:
            yield elem["value"]

    def __str__(self):
        return "".join(e["value"] for e in self.elems if isinstance(e["value"], str))

    def __eq__(self, other):
        if isinstance(other, Text):
            return [e["value"] for e in self.elems] == [e["value"] for e in other.elems]
        if isinstance(other, str):
            return str(self) == other
        return NotImplemented

    def __repr__(self):
        return f"Text({str(self)!r})"

    def to_spans(self):
        """Returns the content as strings interleaved with non-character
        elements (text.js:78)."""
        spans = []
        chars = ""
        for elem in self.elems:
            if isinstance(elem["value"], str):
                chars += elem["value"]
            else:
                if chars:
                    spans.append(chars)
                    chars = ""
                spans.append(elem["value"])
        if chars:
            spans.append(chars)
        return spans

    def get_writeable(self, context, path):
        if self._object_id is None:
            raise ValueError("get_writeable() requires the objectId to be set")
        instance = instantiate_text(self._object_id, self.elems)
        instance.context = context
        instance.path = path
        return instance

    def set(self, index, value):
        if self.context is not None:
            self.context.set_list_index(self.path, index, value)
        elif self._object_id is None:
            self.elems[index]["value"] = value
        else:
            raise TypeError("Text object cannot be modified outside of a change block")
        return self

    def __setitem__(self, index, value):
        self.set(index, value)

    def insert_at(self, index, *values):
        if self.context is not None:
            self.context.splice(self.path, index, 0, list(values))
        elif self._object_id is None:
            self.elems[index:index] = [{"value": v} for v in values]
        else:
            raise TypeError("Text object cannot be modified outside of a change block")
        return self

    def delete_at(self, index, num_delete=1):
        if self.context is not None:
            self.context.splice(self.path, index, num_delete, [])
        elif self._object_id is None:
            del self.elems[index : index + num_delete]
        else:
            raise TypeError("Text object cannot be modified outside of a change block")
        return self


def instantiate_text(object_id, elems):
    instance = Text.__new__(Text)
    instance._object_id = object_id
    instance.elems = elems
    instance.context = None
    instance.path = None
    return instance


class Table:
    """A collection of unordered rows keyed by UUID (table.js:25). Rows have
    no conflicts since their primary keys are unique. Each row object carries
    an `id` property equal to its key (table.js:152-156)."""

    def __init__(self):
        self.entries = {}
        self.op_ids = {}
        self._object_id = None

    def by_id(self, id_):
        return self.entries.get(id_)

    @property
    def ids(self):
        return [
            key
            for key, entry in self.entries.items()
            if isinstance(entry, (Map, dict)) and entry.get("id") == key
        ]

    @property
    def count(self):
        return len(self.ids)

    @property
    def rows(self):
        return [self.by_id(id_) for id_ in self.ids]

    def filter(self, fn):
        return [row for row in self.rows if fn(row)]

    def find(self, fn):
        for row in self.rows:
            if fn(row):
                return row
        return None

    def map(self, fn):
        return [fn(row) for row in self.rows]

    def sort(self, arg=None):
        """Sorts rows by a compare-key function, a column name, a list of
        column names, or by row ID (table.js:103)."""
        if callable(arg):
            return sorted(self.rows, key=arg)
        if isinstance(arg, str):
            return sorted(self.rows, key=lambda row: row.get(arg))
        if isinstance(arg, list):
            return sorted(self.rows, key=lambda row: [row.get(col) for col in arg])
        if arg is None:
            return sorted(self.rows, key=lambda row: row.get("id"))
        raise TypeError(f"Unsupported sorting argument: {arg!r}")

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return self.count

    def add(self, row):
        raise TypeError("A table can only be modified in a change block")

    def remove(self, id_):
        raise TypeError("A table can only be modified in a change block")

    def _set(self, id_, value, op_id):
        if isinstance(value, Map):
            dict.__setitem__(value, "id", id_)
        elif isinstance(value, dict):
            value["id"] = id_
        self.entries[id_] = value
        self.op_ids[id_] = op_id

    def _remove(self, id_):
        self.entries.pop(id_, None)
        self.op_ids.pop(id_, None)

    def _clone(self):
        if self._object_id is None:
            raise RuntimeError("clone() requires the objectId to be set")
        return instantiate_table(self._object_id, dict(self.entries), dict(self.op_ids))

    def to_dict(self):
        return {id_: self.by_id(id_) for id_ in self.ids}

    def __eq__(self, other):
        return isinstance(other, Table) and self.entries == other.entries

    def __repr__(self):
        return f"Table({len(self.entries)} rows)"


def instantiate_table(object_id, entries=None, op_ids=None):
    if not object_id:
        raise ValueError("instantiate_table requires an objectId to be given")
    table = Table()
    table._object_id = object_id
    table.entries = entries if entries is not None else {}
    table.op_ids = op_ids if op_ids is not None else {}
    return table


class WriteableTable:
    """Table view bound to a change context (table.js:217)."""

    def __init__(self, context, path, table):
        self.context = context
        self.path = path
        self.table = table
        self._object_id = table._object_id

    @property
    def count(self):
        return self.table.count

    @property
    def ids(self):
        return self.table.ids

    def by_id(self, id_):
        entry = self.table.entries.get(id_)
        if isinstance(entry, (Map, dict)) and entry.get("id") == id_:
            object_id = entry._object_id
            path = self.path + [{"key": id_, "objectId": object_id}]
            return self.context.instantiate_object(path, object_id)
        return None

    def add(self, row):
        return self.context.add_table_row(self.path, row)

    def remove(self, id_):
        entry = self.table.entries.get(id_)
        if isinstance(entry, (Map, dict)) and entry.get("id") == id_:
            self.context.delete_table_row(self.path, id_, self.table.op_ids[id_])
        else:
            raise KeyError(f"There is no row with ID {id_} in this table")

    @property
    def rows(self):
        return [self.by_id(id_) for id_ in self.ids]


DateValue = _dt.datetime


def timestamp_to_datetime(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)


def datetime_to_timestamp(value: _dt.datetime) -> int:
    return round(value.timestamp() * 1000)

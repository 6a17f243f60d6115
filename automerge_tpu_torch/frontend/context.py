"""Mutation context: records operations as the user mutates proxy objects in
a change block, and optimistically applies the corresponding patch.

Port of the reference implementation's frontend/context.js.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import datetime as _dt

from ..uuid import make_uuid
from ..common import parse_op_id
from .apply_patch import interpret_patch
from .datatypes import (
    Counter,
    Float64,
    Int,
    List,
    Map,
    Table,
    Text,
    Uint,
    WriteableCounter,
    datetime_to_timestamp,
)

MAX_SAFE = 2**53 - 1


def _is_primitive(value):
    return value is None or isinstance(value, (str, bool, int, float))


def _strict_equals(a, b):
    """JS === semantics: value equality for primitives, identity for objects."""
    if _is_primitive(a) and _is_primitive(b):
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        return a == b and (a is not None) == (b is not None)
    return a is b


class Context:
    def __init__(self, doc, actor_id, apply_patch_fn=None):
        self.actor_id = actor_id
        self.next_op_num = doc._state["maxOp"] + 1
        self.cache = doc._cache
        self.updated = {}
        self.ops = []
        self.apply_patch = apply_patch_fn if apply_patch_fn is not None else interpret_patch
        self.instantiate_object = None  # installed by proxies.root_object_proxy

    def add_op(self, operation):
        self.ops.append(operation)
        if operation["action"] == "set" and "values" in operation:
            self.next_op_num += len(operation["values"])
        elif operation["action"] == "del" and "multiOp" in operation:
            self.next_op_num += operation["multiOp"]
        else:
            self.next_op_num += 1

    def next_op_id(self):
        return f"{self.next_op_num}@{self.actor_id}"

    def get_value_description(self, value):
        """Describes a value in patch format (context.js:51)."""
        if isinstance(value, bool) or value is None or isinstance(value, str):
            return {"type": "value", "value": value}
        if isinstance(value, _dt.datetime):
            return {"type": "value", "value": datetime_to_timestamp(value), "datatype": "timestamp"}
        if isinstance(value, Int):
            return {"type": "value", "value": value.value, "datatype": "int"}
        if isinstance(value, Uint):
            return {"type": "value", "value": value.value, "datatype": "uint"}
        if isinstance(value, Float64):
            return {"type": "value", "value": value.value, "datatype": "float64"}
        if isinstance(value, Counter):
            return {"type": "value", "value": value.value, "datatype": "counter"}
        if isinstance(value, int):
            if -MAX_SAFE <= value <= MAX_SAFE:
                return {"type": "value", "value": value, "datatype": "int"}
            return {"type": "value", "value": float(value), "datatype": "float64"}
        if isinstance(value, float):
            return {"type": "value", "value": value, "datatype": "float64"}
        if isinstance(value, (Map, List, Text, Table, dict, list, tuple)):
            object_id = getattr(value, "_object_id", None)
            if object_id is None:
                raise ValueError(f"Object {value!r} has no objectId")
            type_ = self.get_object_type(object_id)
            if type_ in ("list", "text"):
                return {"objectId": object_id, "type": type_, "edits": []}
            return {"objectId": object_id, "type": type_, "props": {}}
        raise TypeError(f"Unsupported type of value: {type(value).__name__}")

    def get_values_descriptions(self, path, obj, key):
        """All conflicting values of a property, as opId -> description
        (context.js:100)."""
        if isinstance(obj, Table):
            value = obj.by_id(key)
            op_id = obj.op_ids.get(key)
            return {op_id: self.get_value_description(value)} if value is not None else {}
        if isinstance(obj, Text):
            value = obj.get(key)
            elem_id = obj.get_elem_id(key)
            return {elem_id: self.get_value_description(value)} if value is not None else {}
        conflicts = obj._conflicts[key] if isinstance(obj, Map) else obj._conflicts[key]
        if conflicts is None:
            raise ValueError(f"No children at key {key} of path {path}")
        return {op_id: self.get_value_description(v) for op_id, v in conflicts.items()}

    def get_property_value(self, obj, key, op_id):
        if isinstance(obj, Table):
            return obj.by_id(key)
        if isinstance(obj, Text):
            return obj.get(key)
        return obj._conflicts[key][op_id]

    def get_subpatch(self, patch, path):
        """Returns the subpatch at `path`, creating nodes as needed
        (context.js:142)."""
        if not path:
            return patch
        subpatch = patch
        obj = self.get_object("_root")
        for path_elem in path:
            key = path_elem["key"]
            values = self.get_values_descriptions(path, obj, key)
            if "props" in subpatch:
                if key not in subpatch["props"]:
                    subpatch["props"][key] = values
            elif "edits" in subpatch:
                for op_id, value in values.items():
                    subpatch["edits"].append(
                        {"action": "update", "index": key, "opId": op_id, "value": value}
                    )
            next_op_id = None
            for op_id, value in values.items():
                if value.get("objectId") == path_elem["objectId"]:
                    next_op_id = op_id
            if next_op_id is None:
                raise ValueError(f"Cannot find path object with objectId {path_elem['objectId']}")
            subpatch = values[next_op_id]
            obj = self.get_property_value(obj, key, next_op_id)
        return subpatch

    def get_object(self, object_id):
        obj = self.updated.get(object_id) or self.cache.get(object_id)
        if obj is None:
            raise ValueError(f"Target object does not exist: {object_id}")
        return obj

    def get_object_type(self, object_id):
        if object_id == "_root":
            return "map"
        obj = self.get_object(object_id)
        if isinstance(obj, Text):
            return "text"
        if isinstance(obj, Table):
            return "table"
        if isinstance(obj, (List, list)) and not isinstance(obj, Map):
            return "list"
        return "map"

    def get_object_field(self, path, object_id, key):
        """Returns the value of a field, wrapping objects in proxies."""
        obj = self.get_object(object_id)
        try:
            value = obj[key]
        except (KeyError, IndexError):
            return None
        if isinstance(value, Counter):
            return WriteableCounter(value.value, self, path, object_id, key)
        if isinstance(value, (Map, List, Text, Table)):
            child_id = value._object_id
            subpath = path + [{"key": key, "objectId": child_id}]
            return self.instantiate_object(subpath, child_id)
        return value

    def create_nested_objects(self, obj, key, value, insert, pred, elem_id=None):
        """Recursively creates document objects for a new value tree
        (context.js:230)."""
        if getattr(value, "_object_id", None):
            raise ValueError("Cannot create a reference to an existing document object")
        object_id = self.next_op_id()

        if isinstance(value, Text):
            op = {"action": "makeText", "obj": obj, "insert": insert, "pred": pred}
            if elem_id is not None:
                op["elemId"] = elem_id
            else:
                op["key"] = key
            self.add_op(op)
            subpatch = {"objectId": object_id, "type": "text", "edits": []}
            self.insert_list_items(subpatch, 0, [e["value"] for e in value.elems], True)
            return subpatch

        if isinstance(value, Table):
            if value.count > 0:
                raise ValueError("Assigning a non-empty Table object is not supported")
            op = {"action": "makeTable", "obj": obj, "insert": insert, "pred": pred}
            if elem_id is not None:
                op["elemId"] = elem_id
            else:
                op["key"] = key
            self.add_op(op)
            return {"objectId": object_id, "type": "table", "props": {}}

        if isinstance(value, (list, tuple)) and not isinstance(value, Map):
            op = {"action": "makeList", "obj": obj, "insert": insert, "pred": pred}
            if elem_id is not None:
                op["elemId"] = elem_id
            else:
                op["key"] = key
            self.add_op(op)
            subpatch = {"objectId": object_id, "type": "list", "edits": []}
            self.insert_list_items(subpatch, 0, list(value), True)
            return subpatch

        # Map object
        op = {"action": "makeMap", "obj": obj, "insert": insert, "pred": pred}
        if elem_id is not None:
            op["elemId"] = elem_id
        else:
            op["key"] = key
        self.add_op(op)
        props = {}
        for nested in sorted(value.keys()):
            op_id = self.next_op_id()
            value_patch = self.set_value(object_id, nested, value[nested], False, [])
            props[nested] = {op_id: value_patch}
        return {"objectId": object_id, "type": "map", "props": props}

    def set_value(self, object_id, key, value, insert, pred, elem_id=None):
        """Records an assignment and returns its value patch (context.js:289)."""
        if not object_id:
            raise ValueError("set_value needs an objectId")
        if key == "":
            raise ValueError("The key of a map entry must not be an empty string")

        if (
            isinstance(value, (dict, list, tuple, Map, List, Text, Table))
            and not isinstance(value, _dt.datetime)
        ):
            return self.create_nested_objects(object_id, key, value, insert, pred, elem_id)

        description = self.get_value_description(value)
        op = {"action": "set", "obj": object_id, "insert": insert, "value": description["value"], "pred": pred}
        if elem_id is not None:
            op["elemId"] = elem_id
        else:
            op["key"] = key
        if description.get("datatype") is not None:
            op["datatype"] = description["datatype"]
        self.add_op(op)
        return description

    def apply_at_path(self, path, callback):
        diff = {"objectId": "_root", "type": "map", "props": {}}
        callback(self.get_subpatch(diff, path))
        self.apply_patch(diff, self.cache["_root"], self.updated)

    def set_map_key(self, path, key, value):
        if not isinstance(key, str):
            raise TypeError(f"The key of a map entry must be a string, not {type(key).__name__}")
        object_id = "_root" if not path else path[-1]["objectId"]
        obj = self.get_object(object_id)
        if isinstance(obj.get(key), Counter):
            raise ValueError(
                "Cannot overwrite a Counter object; use increment() or decrement() to change its value."
            )
        if (
            not _strict_equals(obj.get(key), value)
            or len(obj._conflicts.get(key) or {}) > 1
            or value is None and key not in obj
        ):
            def cb(subpatch):
                pred = get_pred(obj, key)
                op_id = self.next_op_id()
                value_patch = self.set_value(object_id, key, value, False, pred)
                subpatch["props"][key] = {op_id: value_patch}

            self.apply_at_path(path, cb)

    def delete_map_key(self, path, key):
        object_id = "_root" if not path else path[-1]["objectId"]
        obj = self.get_object(object_id)
        if key in obj:
            pred = get_pred(obj, key)
            self.add_op({"action": "del", "obj": object_id, "key": key, "insert": False, "pred": pred})

            def cb(subpatch):
                subpatch["props"][key] = {}

            self.apply_at_path(path, cb)

    def insert_list_items(self, subpatch, index, values, new_object):
        """Inserts elements into a list/text, emitting multi-insert ops where
        all values are primitives of one datatype (context.js:370)."""
        lst = [] if new_object else self.get_object(subpatch["objectId"])
        if index < 0 or index > len(lst):
            raise IndexError(f"List index {index} is out of bounds for list of length {len(lst)}")
        if not values:
            return

        elem_id = get_elem_id(lst, index, insert=True)
        all_primitive = all(
            isinstance(v, (str, bool, int, float, _dt.datetime, Counter, Int, Uint, Float64))
            or v is None
            for v in values
        )
        descriptions = [self.get_value_description(v) for v in values] if all_primitive else []
        datatypes_same = all(
            d.get("datatype") == descriptions[0].get("datatype") for d in descriptions
        ) if descriptions else False

        if all_primitive and datatypes_same and len(values) > 1:
            next_elem_id = self.next_op_id()
            datatype = descriptions[0].get("datatype")
            plain_values = [d["value"] for d in descriptions]
            op = {"action": "set", "obj": subpatch["objectId"], "elemId": elem_id, "insert": True,
                  "values": plain_values, "pred": []}
            edit = {"action": "multi-insert", "elemId": next_elem_id, "index": index, "values": plain_values}
            if datatype is not None:
                op["datatype"] = datatype
                edit["datatype"] = datatype
            self.add_op(op)
            subpatch["edits"].append(edit)
        else:
            for offset, value in enumerate(values):
                next_elem_id = self.next_op_id()
                value_patch = self.set_value(
                    subpatch["objectId"], index + offset, value, True, [], elem_id
                )
                elem_id = next_elem_id
                subpatch["edits"].append(
                    {"action": "insert", "index": index + offset, "elemId": elem_id,
                     "opId": elem_id, "value": value_patch}
                )

    def set_list_index(self, path, index, value):
        object_id = "_root" if not path else path[-1]["objectId"]
        lst = self.get_object(object_id)
        if index >= len(lst):
            insertions = [None] * (index - len(lst))
            insertions.append(value)
            return self.splice(path, len(lst), 0, insertions)
        current = lst.get(index) if isinstance(lst, Text) else lst[index]
        if isinstance(current, Counter):
            raise ValueError(
                "Cannot overwrite a Counter object; use increment() or decrement() to change its value."
            )
        conflicts = lst._conflicts[index] if not isinstance(lst, Text) and index < len(lst._conflicts) else None
        if not _strict_equals(current, value) or len(conflicts or {}) > 1 or value is None:
            def cb(subpatch):
                pred = get_pred(lst, index)
                op_id = self.next_op_id()
                value_patch = self.set_value(object_id, index, value, False, pred, get_elem_id(lst, index))
                subpatch["edits"].append({"action": "update", "index": index, "opId": op_id, "value": value_patch})

            self.apply_at_path(path, cb)

    def splice(self, path, start, deletions, insertions):
        """Deletes `deletions` elements at `start` and inserts `insertions`
        (context.js:441). Consecutive deletions compress into multiOp dels."""
        object_id = "_root" if not path else path[-1]["objectId"]
        lst = self.get_object(object_id)
        length = len(lst)
        if start < 0 or deletions < 0 or start > length - deletions:
            raise IndexError(
                f"{deletions} deletions starting at index {start} are out of bounds "
                f"for list of length {length}"
            )
        if deletions == 0 and not insertions:
            return
        patch = {"diffs": {"objectId": "_root", "type": "map", "props": {}}}
        subpatch = self.get_subpatch(patch["diffs"], path)

        if deletions > 0:
            op = None
            last_elem_parsed = None
            last_pred_parsed = None
            for i in range(deletions):
                if isinstance(self.get_object_field(path, object_id, start + i), Counter):
                    raise TypeError("Unsupported operation: deleting a counter from a list")
                this_elem = get_elem_id(lst, start + i)
                this_elem_parsed = parse_op_id(this_elem)
                this_pred = get_pred(lst, start + i)
                this_pred_parsed = parse_op_id(this_pred[0]) if len(this_pred) == 1 else None
                if (
                    op is not None
                    and last_elem_parsed is not None
                    and last_pred_parsed is not None
                    and this_pred_parsed is not None
                    and last_elem_parsed.actor_id == this_elem_parsed.actor_id
                    and last_elem_parsed.counter + 1 == this_elem_parsed.counter
                    and last_pred_parsed.actor_id == this_pred_parsed.actor_id
                    and last_pred_parsed.counter + 1 == this_pred_parsed.counter
                ):
                    op["multiOp"] = op.get("multiOp", 1) + 1
                else:
                    if op is not None:
                        self.add_op(op)
                    op = {"action": "del", "obj": object_id, "elemId": this_elem,
                          "insert": False, "pred": this_pred}
                last_elem_parsed = this_elem_parsed
                last_pred_parsed = this_pred_parsed
            self.add_op(op)
            subpatch["edits"].append({"action": "remove", "index": start, "count": deletions})

        if insertions:
            self.insert_list_items(subpatch, start, insertions, False)
        self.apply_patch(patch["diffs"], self.cache["_root"], self.updated)

    def add_table_row(self, path, row):
        """Adds a row to a table; returns its generated UUID (context.js:508)."""
        if not isinstance(row, (dict, Map)) or isinstance(row, (list, List)):
            raise TypeError("A table row must be a map")
        if getattr(row, "_object_id", None):
            raise TypeError("Cannot reuse an existing object as table row")
        if "id" in row:
            raise TypeError('A table row must not have an "id" property; it is generated automatically')

        id_ = make_uuid()
        value_patch = self.set_value(path[-1]["objectId"], id_, row, False, [])

        def cb(subpatch):
            subpatch["props"][id_] = {value_patch["objectId"]: value_patch}

        self.apply_at_path(path, cb)
        return id_

    def delete_table_row(self, path, row_id, pred):
        object_id = path[-1]["objectId"]
        table = self.get_object(object_id)
        if table.by_id(row_id):
            self.add_op({"action": "del", "obj": object_id, "key": row_id, "insert": False, "pred": [pred]})

            def cb(subpatch):
                subpatch["props"][row_id] = {}

            self.apply_at_path(path, cb)

    def increment(self, path, key, delta):
        object_id = "_root" if not path else path[-1]["objectId"]
        obj = self.get_object(object_id)
        current = obj.get(key) if isinstance(obj, (Map, dict)) else obj[key]
        if not isinstance(current, Counter):
            raise TypeError("Only counter values can be incremented")

        type_ = self.get_object_type(object_id)
        value = current.value + delta
        op_id = self.next_op_id()
        pred = get_pred(obj, key)

        if type_ in ("list", "text"):
            elem_id = get_elem_id(obj, key, insert=False)
            self.add_op({"action": "inc", "obj": object_id, "elemId": elem_id, "value": delta,
                         "insert": False, "pred": pred})
        else:
            self.add_op({"action": "inc", "obj": object_id, "key": key, "value": delta,
                         "insert": False, "pred": pred})

        def cb(subpatch):
            if type_ in ("list", "text"):
                subpatch["edits"].append({"action": "update", "index": key, "opId": op_id,
                                          "value": {"value": value, "datatype": "counter"}})
            else:
                subpatch["props"][key] = {op_id: {"value": value, "datatype": "counter"}}

        self.apply_at_path(path, cb)


def get_pred(obj, key):
    """Previous operation IDs for a property (context.js:576)."""
    if isinstance(obj, Table):
        return [obj.op_ids[key]]
    if isinstance(obj, Text):
        return obj.elems[key]["pred"]
    if isinstance(obj, Map):
        return list(obj._conflicts[key].keys()) if obj._conflicts.get(key) else []
    if isinstance(obj, List):
        if key < len(obj._conflicts) and obj._conflicts[key]:
            return list(obj._conflicts[key].keys())
        return []
    return []


def get_elem_id(lst, index, insert=False):
    """Element ID at a list index (context.js:588)."""
    if insert:
        if index == 0:
            return "_head"
        index -= 1
    if isinstance(lst, Text):
        return lst.get_elem_id(index)
    if isinstance(lst, List):
        return lst._elem_ids[index]
    if isinstance(lst, list) and not lst:
        raise IndexError(f"Cannot find elemId at list index {index}")
    raise IndexError(f"Cannot find elemId at list index {index}")

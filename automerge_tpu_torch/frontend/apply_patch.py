"""Patch interpreter: applies backend diffs to the immutable document tree.

Port of the reference implementation's frontend/apply_patch.js. Conflict resolution picks
the value with the greatest Lamport opId (apply_patch.js:57-77).
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

from ..common import lamport_compare_key, parse_op_id
from .datatypes import (
    Counter,
    List,
    Map,
    Table,
    Text,
    instantiate_table,
    instantiate_text,
    timestamp_to_datetime,
)


def get_value(patch, obj, updated):
    """Reconstructs a value from a value-or-object patch (apply_patch.js:10)."""
    if patch.get("objectId"):
        if obj is not None and getattr(obj, "_object_id", None) != patch["objectId"]:
            obj = None
        return interpret_patch(patch, obj, updated)
    if patch.get("datatype") == "timestamp":
        return timestamp_to_datetime(patch["value"])
    if patch.get("datatype") == "counter":
        return Counter(patch["value"])
    return patch.get("value")


def _lamport_key(op_id):
    return lamport_compare_key(op_id)


def apply_properties(props, obj, conflicts, updated):
    """Applies a `props` diff to a map object, updating values and the
    conflicts structure (apply_patch.js:57)."""
    if not props:
        return
    for key, prop in props.items():
        values = {}
        op_ids = sorted(prop.keys(), key=_lamport_key, reverse=True)
        for op_id in op_ids:
            subpatch = prop[op_id]
            if conflicts.get(key) and op_id in conflicts[key]:
                values[op_id] = get_value(subpatch, conflicts[key][op_id], updated)
            else:
                values[op_id] = get_value(subpatch, None, updated)
        if not op_ids:
            if key in obj:
                obj._unsafe_delete(key)
            conflicts.pop(key, None)
        else:
            obj._unsafe_set(key, values[op_ids[0]])
            conflicts[key] = values


def _clone_map_object(original, object_id):
    obj = Map(original if original is not None else {})
    obj._object_id = object_id
    obj._conflicts = dict(original._conflicts) if original is not None else {}
    return obj


def update_map_object(patch, obj, updated):
    object_id = patch["objectId"]
    if object_id not in updated:
        updated[object_id] = _clone_map_object(obj, object_id)
    target = updated[object_id]
    apply_properties(patch.get("props"), target, target._conflicts, updated)
    return target


def update_table_object(patch, obj, updated):
    object_id = patch["objectId"]
    if object_id not in updated:
        updated[object_id] = obj._clone() if obj is not None else instantiate_table(object_id)
    table = updated[object_id]
    for key, prop in (patch.get("props") or {}).items():
        op_ids = list(prop.keys())
        if not op_ids:
            table._remove(key)
        elif len(op_ids) == 1:
            subpatch = prop[op_ids[0]]
            table._set(key, get_value(subpatch, table.by_id(key), updated), op_ids[0])
        else:
            raise ValueError("Conflicts are not supported on properties of a table")
    return table


def _clone_list_object(original, object_id):
    lst = List(original if original is not None else [])
    lst._object_id = object_id
    lst._conflicts = list(original._conflicts) if original is not None else []
    lst._elem_ids = list(original._elem_ids) if original is not None else []
    return lst


def update_list_object(patch, obj, updated):
    object_id = patch["objectId"]
    if object_id not in updated:
        updated[object_id] = _clone_list_object(obj, object_id)
    lst = updated[object_id]
    conflicts = lst._conflicts
    elem_ids = lst._elem_ids
    base = super(List, lst)

    edits = patch["edits"]
    i = 0
    while i < len(edits):
        edit = edits[i]
        action = edit["action"]
        if action in ("insert", "update"):
            old_value = None
            if edit["index"] < len(conflicts) and conflicts[edit["index"]]:
                old_value = conflicts[edit["index"]].get(edit["opId"])
            last_value = get_value(edit["value"], old_value, updated)
            values = {edit["opId"]: last_value}
            # Successive updates for the same index indicate a conflict; edits
            # are sorted by Lamport timestamp so the last one wins
            while i < len(edits) - 1 and edits[i + 1]["index"] == edit["index"] \
                    and edits[i + 1]["action"] == "update":
                i += 1
                conflict = edits[i]
                old_value2 = None
                if conflict["index"] < len(conflicts) and conflicts[conflict["index"]]:
                    old_value2 = conflicts[conflict["index"]].get(conflict["opId"])
                last_value = get_value(conflict["value"], old_value2, updated)
                values[conflict["opId"]] = last_value
            if action == "insert":
                base.insert(edit["index"], last_value)
                conflicts.insert(edit["index"], values)
                elem_ids.insert(edit["index"], edit["elemId"])
            else:
                base.__setitem__(edit["index"], last_value)
                conflicts[edit["index"]] = values
        elif action == "multi-insert":
            start = parse_op_id(edit["elemId"])
            datatype = edit.get("datatype")
            new_elems, new_values, new_conflicts = [], [], []
            for offset, value in enumerate(edit["values"]):
                elem_id = f"{start.counter + offset}@{start.actor_id}"
                value = get_value({"value": value, "datatype": datatype}, None, updated)
                new_values.append(value)
                entry = {"value": value, "type": "value"}
                if datatype is not None:
                    entry["datatype"] = datatype
                new_conflicts.append({elem_id: entry})
                new_elems.append(elem_id)
            base.__setitem__(slice(edit["index"], edit["index"]), new_values)
            conflicts[edit["index"] : edit["index"]] = new_conflicts
            elem_ids[edit["index"] : edit["index"]] = new_elems
        elif action == "remove":
            base.__delitem__(slice(edit["index"], edit["index"] + edit["count"]))
            del conflicts[edit["index"] : edit["index"] + edit["count"]]
            del elem_ids[edit["index"] : edit["index"] + edit["count"]]
        i += 1
    return lst


def update_text_object(patch, obj, updated):
    object_id = patch["objectId"]
    if object_id in updated:
        elems = updated[object_id].elems
    elif obj is not None:
        elems = list(obj.elems)
    else:
        elems = []

    for edit in patch["edits"]:
        action = edit["action"]
        if action == "insert":
            value = get_value(edit["value"], None, updated)
            elems.insert(edit["index"], {"elemId": edit["elemId"], "pred": [edit["opId"]], "value": value})
        elif action == "multi-insert":
            start = parse_op_id(edit["elemId"])
            datatype = edit.get("datatype")
            new_elems = []
            for offset, value in enumerate(edit["values"]):
                value = get_value({"datatype": datatype, "value": value}, None, updated)
                elem_id = f"{start.counter + offset}@{start.actor_id}"
                new_elems.append({"elemId": elem_id, "pred": [elem_id], "value": value})
            elems[edit["index"] : edit["index"]] = new_elems
        elif action == "update":
            elem_id = elems[edit["index"]]["elemId"]
            value = get_value(edit["value"], elems[edit["index"]]["value"], updated)
            elems[edit["index"]] = {"elemId": elem_id, "pred": [edit["opId"]], "value": value}
        elif action == "remove":
            del elems[edit["index"] : edit["index"] + edit["count"]]

    updated[object_id] = instantiate_text(object_id, elems)
    return updated[object_id]


def interpret_patch(patch, obj, updated):
    """Applies a patch to the read-only object `obj`, placing a writable copy
    in `updated` (apply_patch.js:266)."""
    if (
        obj is not None
        and not patch.get("props")
        and not patch.get("edits")
        and patch["objectId"] not in updated
    ):
        return obj

    type_ = patch["type"]
    if type_ == "map":
        return update_map_object(patch, obj, updated)
    if type_ == "table":
        return update_table_object(patch, obj, updated)
    if type_ == "list":
        return update_list_object(patch, obj, updated)
    if type_ == "text":
        return update_text_object(patch, obj, updated)
    raise TypeError(f"Unknown object type: {type_}")


def clone_root_object(root):
    if root._object_id != "_root":
        raise ValueError(f"Not the root object: {root._object_id}")
    return _clone_map_object(root, "_root")

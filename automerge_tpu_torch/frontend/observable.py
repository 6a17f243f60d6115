"""Per-object change subscription by patch-walking
(port of the reference implementation's frontend/observable.js)."""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations


def _conflict_at(obj, key, op_id):
    conflicts = getattr(obj, "_conflicts", None)
    if conflicts is None:
        return None
    try:
        entry = conflicts[key]
    except (KeyError, IndexError, TypeError):
        return None
    if isinstance(entry, dict):
        return entry.get(op_id)
    return None


class Observable:
    """Allows callbacks to be registered for particular objects; when a patch
    touches such an object, the callback fires with the sub-diff and the
    before/after object states."""

    def __init__(self):
        self.observers = {}  # objectId -> list of callbacks

    def patch_callback(self, patch, before, after, local, changes):
        self._object_update(patch["diffs"], before, after, local, changes)

    def _object_update(self, diff, before, after, local, changes):
        if not isinstance(diff, dict) or not diff.get("objectId"):
            return
        for callback in self.observers.get(diff["objectId"], []):
            callback(diff, before, after, local, changes)

        type_ = diff.get("type")
        if type_ == "map" and diff.get("props"):
            for prop_name, prop in diff["props"].items():
                for op_id, subdiff in prop.items():
                    self._object_update(
                        subdiff,
                        _conflict_at(before, prop_name, op_id),
                        _conflict_at(after, prop_name, op_id),
                        local, changes,
                    )
        elif type_ == "table" and diff.get("props"):
            for row_id, prop in diff["props"].items():
                for op_id, subdiff in prop.items():
                    self._object_update(
                        subdiff,
                        before.by_id(row_id) if before is not None else None,
                        after.by_id(row_id) if after is not None else None,
                        local, changes,
                    )
        elif type_ == "list" and diff.get("edits"):
            offset = 0
            for edit in diff["edits"]:
                action = edit["action"]
                if action == "insert":
                    offset -= 1
                    self._object_update(
                        edit["value"], None,
                        _conflict_at(after, edit["index"], edit["elemId"]),
                        local, changes,
                    )
                elif action == "multi-insert":
                    offset -= len(edit["values"])
                elif action == "update":
                    self._object_update(
                        edit["value"],
                        _conflict_at(before, edit["index"] + offset, edit["opId"]),
                        _conflict_at(after, edit["index"], edit["opId"]),
                        local, changes,
                    )
                elif action == "remove":
                    offset += edit["count"]
        elif type_ == "text" and diff.get("edits"):
            offset = 0
            for edit in diff["edits"]:
                action = edit["action"]
                if action == "insert":
                    offset -= 1
                    self._object_update(
                        edit["value"], None,
                        after.get(edit["index"]) if after is not None else None,
                        local, changes,
                    )
                elif action == "multi-insert":
                    offset -= len(edit["values"])
                elif action == "update":
                    self._object_update(
                        edit["value"],
                        before.get(edit["index"] + offset) if before is not None else None,
                        after.get(edit["index"]) if after is not None else None,
                        local, changes,
                    )
                elif action == "remove":
                    offset += edit["count"]

    def observe(self, obj, callback):
        object_id = getattr(obj, "_object_id", None)
        if not object_id:
            raise TypeError("The observed object must be part of an Automerge document")
        self.observers.setdefault(object_id, []).append(callback)

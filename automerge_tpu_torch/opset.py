"""The OpSet engine: stores all operations of all time and merges incoming
changes, emitting frontend patches.

Semantically equivalent to the reference engine (backend/new.js,
class BackendDoc), but re-architected: instead of RLE-columnar blocks of <=600
ops with Bloom-filter skip metadata, the document is a flat Python list of
fixed-width op rows in the same total order the reference maintains:

  - ops grouped by object: root-object ops first, then objects ordered by
    (counter, actorId) of their objectId  (new.js:59-74 seek order)
  - within a map object: keys in UTF-16 code-unit order, multiple ops on one
    key in ascending opId order  (new.js:1153-1224)
  - within a list object: elements in RGA document order, each element's ops
    (insert op then updates) in ascending opId order  (new.js:144-190)

This flat dense-row form is also the transcoding source for the device engine's
op tensors (tpu/). Deletion is not a row: a 'del' op only appends
its opId to the succ lists of the ops it overwrites (new.js:1204-1217); an op
is visible iff it has no successors.

Patch generation reproduces the reference's incremental patch state machine
(updatePatchProperty, appendEdit/appendUpdate/convertInsertToUpdate,
new.js:747-1040) exactly, so patches are bit-identical JSON.

This is the port's own copy of the JAX package's ``opset.py`` (a host-only
module): the sequential engine ``TorchDocFarm`` embeds per list/text
document. It differs only in its imports; its native column encoder binds
the port's own ``native`` library.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

from .columnar import (
    ACTIONS,
    CHANGE_COLUMNS,
    DOC_OPS_COLUMNS,
    DOCUMENT_COLUMNS,
    OBJECT_TYPE,
    ColumnType,
    ValueType,
    ParsedOpId,
    decode_change_columns,
    decode_change_meta,
    decode_changes,
    decode_columns,
    decode_document_header,
    decode_value,
    encode_change,
    encode_document_header,
    encoder_by_column_id,
    make_decoders,
)
from .codecs import Encoder
from .common import parse_op_id, utf16_key
from .errors import CausalityError, DecodeError

# Row field indices, matching the doc/change column layout (new.js:10-12)
OBJ_ACTOR, OBJ_CTR, KEY_ACTOR, KEY_CTR, KEY_STR = 0, 1, 2, 3, 4
ID_ACTOR, ID_CTR, INSERT, ACTION, VAL_LEN, VAL_RAW = 5, 6, 7, 8, 9, 10
CHLD_ACTOR, CHLD_CTR = 11, 12
SUCC_NUM, SUCC_ACTOR, SUCC_CTR = 13, 14, 15
PRED_NUM, PRED_ACTOR, PRED_CTR = 13, 14, 15

_SET = ACTIONS.index("set")
_DEL = ACTIONS.index("del")
_INC = ACTIONS.index("inc")


def _empty_object_patch(object_id, type_):
    if type_ in ("list", "text"):
        return {"objectId": object_id, "type": type_, "edits": []}
    return {"objectId": object_id, "type": type_, "props": {}}


def _deep_copy_update(tree, path, value):
    """Updates tree[path[0]][path[1]][...] = value, copying nested nodes so
    previous versions are not mutated (new.js:24)."""
    if len(path) == 1:
        tree[path[0]] = value
    else:
        child = dict(tree.get(path[0]) or {})
        _deep_copy_update(child, path[1:], value)
        tree[path[0]] = child


def _op_id_delta(id1, id2, delta=1):
    p1, p2 = parse_op_id(id1), parse_op_id(id2)
    return p1.actor_id == p2.actor_id and p1.counter + delta == p2.counter


def append_edit(existing_edits, next_edit):
    """Appends a list edit, extending the last edit into a multi-op where
    possible (new.js:747)."""
    if not existing_edits:
        existing_edits.append(next_edit)
        return
    last = existing_edits[-1]
    if (
        last["action"] == "insert"
        and next_edit["action"] == "insert"
        and last["index"] == next_edit["index"] - 1
        and last["value"].get("type") == "value"
        and next_edit["value"].get("type") == "value"
        and last["elemId"] == last["opId"]
        and next_edit["elemId"] == next_edit["opId"]
        and _op_id_delta(last["elemId"], next_edit["elemId"], 1)
        and last["value"].get("datatype") == next_edit["value"].get("datatype")
        and type(last["value"].get("value")) is type(next_edit["value"].get("value"))
    ):
        last["action"] = "multi-insert"
        if next_edit["value"].get("datatype") is not None:
            last["datatype"] = next_edit["value"]["datatype"]
        last["values"] = [last["value"]["value"], next_edit["value"]["value"]]
        del last["value"]
        del last["opId"]
    elif (
        last["action"] == "multi-insert"
        and next_edit["action"] == "insert"
        and last["index"] + len(last["values"]) == next_edit["index"]
        and next_edit["value"].get("type") == "value"
        and next_edit["elemId"] == next_edit["opId"]
        and _op_id_delta(last["elemId"], next_edit["elemId"], len(last["values"]))
        and last.get("datatype") == next_edit["value"].get("datatype")
        and type(last["values"][0]) is type(next_edit["value"].get("value"))
    ):
        last["values"].append(next_edit["value"]["value"])
    elif (
        last["action"] == "remove"
        and next_edit["action"] == "remove"
        and last["index"] == next_edit["index"]
    ):
        last["count"] += next_edit["count"]
    else:
        existing_edits.append(next_edit)


def append_update(edits, index, elem_id, op_id, value, first_update):
    """Appends an UpdateEdit; conflicting values are consecutive edits with the
    same index (new.js:798)."""
    insert = False
    if first_update:
        while not insert and edits:
            last = edits[-1]
            if last["action"] in ("insert", "update") and last["index"] == index:
                edits.pop()
                insert = last["action"] == "insert"
            elif last["action"] == "multi-insert" and last["index"] + len(last["values"]) - 1 == index:
                last["values"].pop()
                insert = True
            else:
                break
    if insert:
        append_edit(edits, {"action": "insert", "index": index, "elemId": elem_id, "opId": op_id, "value": value})
    else:
        append_edit(edits, {"action": "update", "index": index, "opId": op_id, "value": value})


def convert_insert_to_update(edits, index, elem_id):
    """Rewrites a trailing insert-plus-updates suffix at `index` into updates
    (new.js:838)."""
    updates = []
    while edits:
        last = edits[-1]
        if last["action"] == "insert":
            if last["index"] != index:
                raise ValueError("last edit has unexpected index")  # amlint: disable=AM401 — internal edit-stream invariant, not a data fault
            updates.insert(0, edits.pop())
            break
        elif last["action"] == "update":
            if last["index"] != index:
                raise ValueError("last edit has unexpected index")  # amlint: disable=AM401 — internal edit-stream invariant, not a data fault
            updates.insert(0, edits.pop())
        else:
            raise ValueError("last edit has unexpected action")  # amlint: disable=AM401 — internal edit-stream invariant, not a data fault
    first_update = True
    for update in updates:
        append_update(edits, index, elem_id, update["opId"], update["value"], first_update)
        first_update = False


class _DocState:
    """Working state during applyChanges; committed to the OpSet only on
    success (mirrors docState in new.js:1805)."""

    __slots__ = ("max_op", "change_index_by_hash", "actor_ids", "heads", "clock", "ops", "object_meta")

    def __init__(self, opset):
        self.max_op = opset.max_op
        self.change_index_by_hash = opset.change_index_by_hash
        self.actor_ids = opset.actor_ids
        self.heads = opset.heads
        self.clock = opset.clock
        self.ops = list(opset.ops)
        self.object_meta = dict(opset.object_meta)


class _ChangeState:
    """Pseudo-iterator over the operations of a sequence of changes
    (mirrors changeState in new.js:678)."""

    __slots__ = (
        "changes", "change_index", "rows", "row_index", "op_ctr",
        "actor_table", "actor_index", "done", "next_op", "object_ids",
    )

    def __init__(self, changes, object_ids):
        self.changes = changes
        self.change_index = -1
        self.rows = None
        self.row_index = 0
        self.op_ctr = 0
        self.actor_table = None
        self.actor_index = None
        self.done = False
        self.next_op = None
        self.object_ids = object_ids


def _read_op_rows(columns, column_spec, actor_table=None):
    """Decodes column buffers into flat op rows (lists). ACTOR_ID values are
    translated through actor_table when given; group columns become lists.

    Port of readOperation (new.js:570) applied across the whole column set.
    """
    decoders = make_decoders(columns, column_spec)
    # Validate that the standard columns appear at the expected positions
    for i, (name, column_id) in enumerate(column_spec):
        if i < len(decoders) and decoders[i]["columnId"] != column_id:
            # Unknown column present before a standard one; unsupported for now
            raise DecodeError("unexpected columnId")
    if len(decoders) != len(column_spec):
        raise DecodeError("unexpected columnId")

    ds = [d["decoder"] for d in decoders]
    action_d = ds[ACTION]
    rows = []
    while not action_d.done:
        row = [None] * 16
        row[OBJ_ACTOR] = ds[OBJ_ACTOR].read_value()
        row[OBJ_CTR] = ds[OBJ_CTR].read_value()
        row[KEY_ACTOR] = ds[KEY_ACTOR].read_value()
        row[KEY_CTR] = ds[KEY_CTR].read_value()
        row[KEY_STR] = ds[KEY_STR].read_value()
        row[ID_ACTOR] = ds[ID_ACTOR].read_value()
        row[ID_CTR] = ds[ID_CTR].read_value()
        row[INSERT] = ds[INSERT].read_value()
        row[ACTION] = ds[ACTION].read_value()
        val_len = ds[VAL_LEN].read_value()
        row[VAL_LEN] = val_len if val_len is not None else 0
        row[VAL_RAW] = ds[VAL_RAW].read_raw_bytes((row[VAL_LEN] or 0) >> 4)
        row[CHLD_ACTOR] = ds[CHLD_ACTOR].read_value()
        row[CHLD_CTR] = ds[CHLD_CTR].read_value()
        card = ds[13].read_value() or 0
        row[13] = card
        row[14] = [ds[14].read_value() for _ in range(card)]
        row[15] = [ds[15].read_value() for _ in range(card)]
        if actor_table is not None:
            for idx in (OBJ_ACTOR, KEY_ACTOR, ID_ACTOR, CHLD_ACTOR):
                if row[idx] is not None:
                    row[idx] = actor_table[row[idx]]
            row[14] = [actor_table[a] if a is not None else None for a in row[14]]
        rows.append(row)
    return rows


def _get_actor_table(actor_ids, change):
    """Returns (actor_ids, actor_table) translating change actor indexes to doc
    actor indexes (new.js:1434)."""
    if change["actorIds"][0] not in actor_ids:
        if change["seq"] != 1:
            raise CausalityError(f"Seq {change['seq']} is the first change for actor {change['actorIds'][0]}")
        actor_ids = actor_ids + [change["actorIds"][0]]
    actor_table = []
    for actor_id in change["actorIds"]:
        try:
            actor_table.append(actor_ids.index(actor_id))
        except ValueError:
            raise CausalityError(f"actorId {actor_id} is not known to document") from None
    return actor_ids, actor_table


def _read_next_change_op(doc_state, change_state):
    """Advances change_state.next_op (port of readNextChangeOp, new.js:678)."""
    while change_state.change_index < len(change_state.changes) - 1 and (
        change_state.rows is None or change_state.row_index >= len(change_state.rows)
    ):
        change_state.change_index += 1
        change = change_state.changes[change_state.change_index]
        actor_ids, actor_table = _get_actor_table(doc_state.actor_ids, change)
        doc_state.actor_ids = actor_ids
        change_state.actor_table = actor_table
        change_state.actor_index = doc_state.actor_ids.index(change["actorIds"][0])
        columns = [(c["columnId"], c["buffer"]) for c in change["columns"]]
        change_state.rows = _read_op_rows(columns, CHANGE_COLUMNS, actor_table)
        change_state.row_index = 0
        change_state.op_ctr = change["startOp"]
        if not change_state.rows:
            change["maxOp"] = change["startOp"] - 1

    if change_state.rows is None or change_state.row_index >= len(change_state.rows):
        change_state.done = True
        change_state.next_op = None
        return

    op = list(change_state.rows[change_state.row_index])
    change_state.row_index += 1
    op[ID_ACTOR] = change_state.actor_index
    op[ID_CTR] = change_state.op_ctr
    change_state.changes[change_state.change_index]["maxOp"] = change_state.op_ctr
    if change_state.op_ctr > doc_state.max_op:
        doc_state.max_op = change_state.op_ctr
    change_state.op_ctr += 1
    change_state.next_op = op

    if (op[OBJ_CTR] is None) != (op[OBJ_ACTOR] is None):
        raise DecodeError(f"Mismatched object reference: ({op[OBJ_CTR]}, {op[OBJ_ACTOR]})")
    if (
        (op[KEY_CTR] is None and op[KEY_ACTOR] is not None)
        or (op[KEY_CTR] == 0 and op[KEY_ACTOR] is not None)
        or (op[KEY_CTR] is not None and op[KEY_CTR] > 0 and op[KEY_ACTOR] is None)
    ):
        raise DecodeError(f"Mismatched operation key: ({op[KEY_CTR]}, {op[KEY_ACTOR]})")


def _seek_to_op(doc_state, ops):
    """Finds the position at which an operation run should be applied; returns
    (skip_count, visible_count). Port of seekWithinBlock (new.js:50) over the
    flat op list (single conceptual block; no Bloom filters needed)."""
    rows = doc_state.ops
    actor_ids = doc_state.actor_ids
    n = len(rows)
    obj_actor, obj_ctr = ops["objActor"], ops["objCtr"]
    key_actor, key_ctr, key_str = ops["keyActor"], ops["keyCtr"], ops["keyStr"]
    id_actor, id_ctr, insert = ops["idActor"], ops["idCtr"], ops["insert"]

    skip_count = 0
    visible_count = 0
    elem_visible = False
    pos = 0  # aligned cursor for id/insert/succ/obj reads in the list phase
    next_obj_actor = None
    next_obj_ctr = None

    def actor_of(idx):
        return None if idx is None else actor_ids[idx]

    # Seek to the beginning of the object being updated
    if obj_ctr is not None:
        while pos < n:
            row = rows[pos]
            pos += 1
            next_obj_ctr = row[OBJ_CTR]
            next_obj_actor = actor_of(row[OBJ_ACTOR])
            if (
                next_obj_ctr is None
                or next_obj_actor is None
                or next_obj_ctr < obj_ctr
                or (next_obj_ctr == obj_ctr and next_obj_actor < obj_actor)
            ):
                skip_count += 1
            else:
                break
    if next_obj_ctr != obj_ctr or next_obj_actor != obj_actor:
        return skip_count, visible_count

    # Seek to the appropriate key (if string key is used). NB: mirrors the
    # reference's cursor layout where the obj cursor runs one op ahead of the
    # key cursor for non-root objects (new.js:77-92); any under-seek is
    # corrected by the merge loop.
    if key_str is not None:
        key_pos = skip_count
        target_key = utf16_key(key_str)
        while key_pos < n:
            if pos < n:
                row = rows[pos]
                next_obj_actor = actor_of(row[OBJ_ACTOR])
                next_obj_ctr = row[OBJ_CTR]
            else:
                next_obj_actor = None
                next_obj_ctr = None
            next_key_str = rows[key_pos][KEY_STR]
            pos += 1
            key_pos += 1
            if (
                next_key_str is not None
                and utf16_key(next_key_str) < target_key
                and next_obj_ctr == obj_ctr
                and next_obj_actor == obj_actor
            ):
                skip_count += 1
            else:
                break
        return skip_count, visible_count

    # List operation: read fields of row at skip_count (the first op of the
    # object), aligned with the obj cursor (new.js:94-101)
    pos = skip_count
    if pos >= n:
        return skip_count, visible_count
    row = rows[pos]
    pos += 1
    next_id_ctr = row[ID_CTR]
    next_id_actor = actor_of(row[ID_ACTOR])
    next_insert = row[INSERT]
    next_succ_num = row[SUCC_NUM]

    if insert:
        if key_ctr is not None and key_ctr > 0 and key_actor is not None:
            # Seek to the reference element of the insertion
            skip_count += 1
            while pos <= n and (next_id_ctr != key_ctr or next_id_actor != key_actor):
                if next_insert:
                    elem_visible = False
                if next_succ_num == 0 and not elem_visible:
                    visible_count += 1
                    elem_visible = True
                if pos >= n:
                    next_id_ctr = None
                    next_id_actor = None
                    next_obj_ctr = None
                    next_obj_actor = None
                    next_insert = None
                    next_succ_num = None
                    break
                row = rows[pos]
                pos += 1
                next_id_ctr = row[ID_CTR]
                next_id_actor = actor_of(row[ID_ACTOR])
                next_obj_ctr = row[OBJ_CTR]
                next_obj_actor = actor_of(row[OBJ_ACTOR])
                next_insert = row[INSERT]
                next_succ_num = row[SUCC_NUM]
                if next_obj_ctr == obj_ctr and next_obj_actor == obj_actor:
                    skip_count += 1
                else:
                    break
            if (
                next_obj_ctr != obj_ctr
                or next_obj_actor != obj_actor
                or next_id_ctr != key_ctr
                or next_id_actor != key_actor
                or not next_insert
            ):
                raise CausalityError(f"Reference element not found: {key_ctr}@{key_actor}")
            if next_insert:
                elem_visible = False
            if next_succ_num == 0 and not elem_visible:
                visible_count += 1
                elem_visible = True
            # Set up the next values to the operation following the reference element
            if pos >= n:
                return skip_count, visible_count
            row = rows[pos]
            pos += 1
            next_id_ctr = row[ID_CTR]
            next_id_actor = actor_of(row[ID_ACTOR])
            next_obj_ctr = row[OBJ_CTR]
            next_obj_actor = actor_of(row[OBJ_ACTOR])
            next_insert = row[INSERT]
            next_succ_num = row[SUCC_NUM]

        # Skip over any list elements with greater ID than the new one, and any
        # non-insertions (RGA convergence rule, new.js:144-163)
        while (
            (not next_insert or next_id_ctr > id_ctr or (next_id_ctr == id_ctr and next_id_actor > id_actor))
            and next_obj_ctr == obj_ctr
            and next_obj_actor == obj_actor
        ):
            skip_count += 1
            if next_insert:
                elem_visible = False
            if next_succ_num == 0 and not elem_visible:
                visible_count += 1
                elem_visible = True
            if pos < n:
                row = rows[pos]
                pos += 1
                next_id_ctr = row[ID_CTR]
                next_id_actor = actor_of(row[ID_ACTOR])
                next_obj_ctr = row[OBJ_CTR]
                next_obj_actor = actor_of(row[OBJ_ACTOR])
                next_insert = row[INSERT]
                next_succ_num = row[SUCC_NUM]
            else:
                break

    elif key_ctr is not None and key_ctr > 0 and key_actor is not None:
        # Updating an existing list element: seek to just before the
        # reference element's insertion op
        while (
            (not next_insert or next_id_ctr != key_ctr or next_id_actor != key_actor)
            and next_obj_ctr == obj_ctr
            and next_obj_actor == obj_actor
        ):
            skip_count += 1
            if next_insert:
                elem_visible = False
            if next_succ_num == 0 and not elem_visible:
                visible_count += 1
                elem_visible = True
            if pos < n:
                row = rows[pos]
                pos += 1
                next_id_ctr = row[ID_CTR]
                next_id_actor = actor_of(row[ID_ACTOR])
                next_obj_ctr = row[OBJ_CTR]
                next_obj_actor = actor_of(row[OBJ_ACTOR])
                next_insert = row[INSERT]
                next_succ_num = row[SUCC_NUM]
            else:
                break
        if (
            next_obj_ctr != obj_ctr
            or next_obj_actor != obj_actor
            or next_id_ctr != key_ctr
            or next_id_actor != key_actor
            or not next_insert
        ):
            raise CausalityError(f"Reference element not found: {key_ctr}@{key_actor}")

    return skip_count, visible_count


def _update_patch_property(patches, object_id, op, doc_state, prop_state, list_index,
                           old_succ_num, is_whole_doc):
    """Port of updatePatchProperty (new.js:884). `op` is a doc-format row."""
    actor_ids = doc_state.actor_ids
    action = op[ACTION]
    type_ = OBJECT_TYPE.get(ACTIONS[action]) if action < len(ACTIONS) else None
    op_id = f"{op[ID_CTR]}@{actor_ids[op[ID_ACTOR]]}"
    if op[INSERT]:
        elem_id_actor, elem_id_ctr = op[ID_ACTOR], op[ID_CTR]
    else:
        elem_id_actor, elem_id_ctr = op[KEY_ACTOR], op[KEY_CTR]
    if op[KEY_STR] is not None:
        elem_id = op[KEY_STR]
    else:
        elem_id = f"{elem_id_ctr}@{actor_ids[elem_id_actor]}"

    # Record new parent-child relationships for make* operations
    if action % 2 == 0 and op_id not in doc_state.object_meta:
        doc_state.object_meta[op_id] = {
            "parentObj": object_id, "parentKey": elem_id, "opId": op_id, "type": type_, "children": {},
        }
        _deep_copy_update(
            doc_state.object_meta,
            [object_id, "children", elem_id, op_id],
            {"objectId": op_id, "type": type_, "props": {}},
        )

    first_op = elem_id not in prop_state
    if first_op:
        prop_state[elem_id] = {"visibleOps": [], "hasChild": False}
    state = prop_state[elem_id]

    is_overwritten = old_succ_num is not None and op[SUCC_NUM] > 0

    if not is_overwritten:
        state["visibleOps"].append(op)
        state["hasChild"] = state["hasChild"] or (action % 2) == 0

    prev_children = doc_state.object_meta[object_id]["children"].get(elem_id)
    if state["hasChild"] or (prev_children and len(prev_children) > 0):
        values = {}
        for visible in state["visibleOps"]:
            vis_op_id = f"{visible[ID_CTR]}@{actor_ids[visible[ID_ACTOR]]}"
            vis_action = visible[ACTION]
            if vis_action < len(ACTIONS) and ACTIONS[vis_action] == "set":
                values[vis_op_id] = dict(
                    {"type": "value"}, **decode_value(visible[VAL_LEN], visible[VAL_RAW])
                )
            elif vis_action % 2 == 0:
                obj_type = OBJECT_TYPE.get(ACTIONS[vis_action]) if vis_action < len(ACTIONS) else None
                values[vis_op_id] = _empty_object_patch(vis_op_id, obj_type)
        _deep_copy_update(doc_state.object_meta, [object_id, "children", elem_id], values)

    patch_key = None
    patch_value = None

    is_set = action < len(ACTIONS) and ACTIONS[action] == "set"
    is_inc = action < len(ACTIONS) and ACTIONS[action] == "inc"

    if is_overwritten and is_set and (op[VAL_LEN] & 0x0F) == ValueType.COUNTER:
        # Initial set operation creating a counter: collect successor ops
        if "counterStates" not in state:
            state["counterStates"] = {}
        counter_state = {
            "opId": op_id,
            "value": decode_value(op[VAL_LEN], op[VAL_RAW])["value"],
            "succs": {},
        }
        for i in range(op[SUCC_NUM]):
            succ_op = f"{op[SUCC_CTR][i]}@{actor_ids[op[SUCC_ACTOR][i]]}"
            state["counterStates"][succ_op] = counter_state
            counter_state["succs"][succ_op] = True

    elif is_inc:
        if "counterStates" not in state or op_id not in state["counterStates"]:
            raise CausalityError(f"increment operation {op_id} for unknown counter")
        counter_state = state["counterStates"][op_id]
        counter_state["value"] += decode_value(op[VAL_LEN], op[VAL_RAW])["value"]
        del counter_state["succs"][op_id]
        if not counter_state["succs"]:
            patch_key = counter_state["opId"]
            patch_value = {"type": "value", "datatype": "counter", "value": counter_state["value"]}

    elif not is_overwritten:
        if is_set:
            patch_key = op_id
            patch_value = dict({"type": "value"}, **decode_value(op[VAL_LEN], op[VAL_RAW]))
        elif action % 2 == 0:
            if op_id not in patches:
                patches[op_id] = _empty_object_patch(op_id, type_)
            patch_key = op_id
            patch_value = patches[op_id]

    if object_id not in patches:
        patches[object_id] = _empty_object_patch(object_id, doc_state.object_meta[object_id]["type"])
    patch = patches[object_id]

    if op[KEY_STR] is None:
        # List or text object
        if old_succ_num == 0 and not is_whole_doc and state.get("action") == "insert":
            state["action"] = "update"
            convert_insert_to_update(patch["edits"], list_index, elem_id)

        if patch_value is not None:
            if not state.get("action") and (old_succ_num is None or is_whole_doc):
                state["action"] = "insert"
                append_edit(
                    patch["edits"],
                    {"action": "insert", "index": list_index, "elemId": elem_id,
                     "opId": patch_key, "value": patch_value},
                )
            elif state.get("action") == "remove":
                last_edit = patch["edits"][-1]
                if last_edit["action"] != "remove":
                    raise ValueError("last edit has unexpected type")  # amlint: disable=AM401 — internal edit-stream invariant, not a data fault
                if last_edit["count"] > 1:
                    last_edit["count"] -= 1
                else:
                    patch["edits"].pop()
                state["action"] = "update"
                append_update(patch["edits"], list_index, elem_id, patch_key, patch_value, True)
            else:
                append_update(
                    patch["edits"], list_index, elem_id, patch_key, patch_value, not state.get("action")
                )
                if not state.get("action"):
                    state["action"] = "update"

        elif old_succ_num == 0 and not state.get("action"):
            state["action"] = "remove"
            append_edit(patch["edits"], {"action": "remove", "index": list_index, "count": 1})

    elif patch_value is not None or not is_whole_doc:
        # Map or table object
        if first_op or op[KEY_STR] not in patch["props"]:
            patch["props"][op[KEY_STR]] = {}
        if patch_value is not None:
            patch["props"][op[KEY_STR]][patch_key] = patch_value


def _merge_doc_change_ops(patches, out_rows, change_state, doc_state, list_index, doc_cursor):
    """Two-pointer merge of doc ops and change ops for one run
    (port of mergeDocChangeOps, new.js:1052).

    `doc_cursor` is the index into doc_state.ops of the first unconsumed doc
    op. Returns the number of doc ops consumed. Merged output is appended to
    out_rows.
    """
    rows = doc_state.ops
    actor_ids = doc_state.actor_ids
    n = len(rows)

    first_op = change_state.next_op
    insert = first_op[INSERT]
    obj_actor, obj_ctr = first_op[OBJ_ACTOR], first_op[OBJ_CTR]
    object_id = "_root" if obj_actor is None else f"{obj_ctr}@{actor_ids[obj_actor]}"
    id_actor_index = change_state.actor_index
    id_actor = actor_ids[id_actor_index]

    found_list_elem = False
    elem_visible = False
    prop_state = {}
    change_state.object_ids.add(object_id)

    doc_op = rows[doc_cursor] if doc_cursor < n else None
    doc_ops_consumed = 0 if doc_op is None else 1
    doc_op_old_succ_num = 0 if doc_op is None else doc_op[SUCC_NUM]
    next_doc = doc_cursor + 1

    change_ops = []
    pred_seen = []
    last_change_key = None
    change_op = None

    def read_next_doc_op():
        nonlocal doc_op, next_doc, doc_ops_consumed, doc_op_old_succ_num
        if next_doc < n:
            doc_op = rows[next_doc]
            next_doc += 1
            doc_ops_consumed += 1
            doc_op_old_succ_num = doc_op[SUCC_NUM]
        else:
            doc_op = None

    while True:
        if not change_ops:
            found_list_elem = False
            next_op = change_state.next_op
            while (
                not change_state.done
                and next_op[ID_ACTOR] == id_actor_index
                and next_op[INSERT] == insert
                and next_op[OBJ_ACTOR] == first_op[OBJ_ACTOR]
                and next_op[OBJ_CTR] == first_op[OBJ_CTR]
            ):
                last_op = change_ops[-1] if change_ops else None
                is_overwrite = False
                for i in range(next_op[PRED_NUM]):
                    for prev_op in change_ops:
                        if (
                            next_op[PRED_ACTOR][i] == prev_op[ID_ACTOR]
                            and next_op[PRED_CTR][i] == prev_op[ID_CTR]
                        ):
                            is_overwrite = True

                if next_op is first_op:
                    pass  # first change op is always used
                elif (
                    insert
                    and last_op is not None
                    and next_op[KEY_STR] is None
                    and next_op[KEY_ACTOR] == last_op[ID_ACTOR]
                    and next_op[KEY_CTR] == last_op[ID_CTR]
                ):
                    pass  # consecutive insertions
                elif (
                    not insert
                    and last_op is not None
                    and next_op[KEY_STR] is not None
                    and next_op[KEY_STR] == last_op[KEY_STR]
                    and not is_overwrite
                ):
                    pass  # several updates to the same key
                elif (
                    not insert
                    and last_op is not None
                    and next_op[KEY_STR] is None
                    and last_op[KEY_STR] is None
                    and next_op[KEY_ACTOR] == last_op[KEY_ACTOR]
                    and next_op[KEY_CTR] == last_op[KEY_CTR]
                    and not is_overwrite
                ):
                    pass  # several updates to the same list element
                elif (
                    not insert
                    and last_op is None
                    and next_op[KEY_STR] is None
                    and doc_op is not None
                    and doc_op[INSERT]
                    and doc_op[KEY_STR] is None
                    and doc_op[ID_ACTOR] == next_op[KEY_ACTOR]
                    and doc_op[ID_CTR] == next_op[KEY_CTR]
                ):
                    pass  # updating consecutive list elements
                elif (
                    not insert
                    and last_op is None
                    and next_op[KEY_STR] is not None
                    and last_change_key is not None
                    and utf16_key(last_change_key) < utf16_key(next_op[KEY_STR])
                ):
                    pass  # several keys in ascending order
                else:
                    break

                last_change_key = next_op[KEY_STR]
                change_ops.append(next_op)
                pred_seen.append([False] * next_op[PRED_NUM])
                _read_next_change_op(doc_state, change_state)
                next_op = change_state.next_op

        if change_ops:
            change_op = change_ops[0]
        in_correct_object = (
            doc_op is not None
            and doc_op[OBJ_ACTOR] == change_op[OBJ_ACTOR]
            and doc_op[OBJ_CTR] == change_op[OBJ_CTR]
        )
        key_matches = (
            doc_op is not None
            and doc_op[KEY_STR] is not None
            and doc_op[KEY_STR] == change_op[KEY_STR]
        )
        list_elem_matches = (
            doc_op is not None
            and doc_op[KEY_STR] is None
            and change_op[KEY_STR] is None
            and (
                (not doc_op[INSERT]
                 and doc_op[KEY_ACTOR] == change_op[KEY_ACTOR]
                 and doc_op[KEY_CTR] == change_op[KEY_CTR])
                or (doc_op[INSERT]
                    and doc_op[ID_ACTOR] == change_op[KEY_ACTOR]
                    and doc_op[ID_CTR] == change_op[KEY_CTR])
            )
        )

        if not change_ops and not (in_correct_object and (key_matches or list_elem_matches)):
            break

        take_doc_op = False
        take_change_ops = 0

        if insert or not in_correct_object or (
            doc_op[KEY_STR] is None and change_op[KEY_STR] is not None
        ) or (
            doc_op[KEY_STR] is not None
            and change_op[KEY_STR] is not None
            and utf16_key(change_op[KEY_STR]) < utf16_key(doc_op[KEY_STR])
        ):
            take_change_ops = len(change_ops)
            if not in_correct_object and not found_list_elem and change_op[KEY_STR] is None and not change_op[INSERT]:
                raise CausalityError(
                    "could not find list element with ID: "
                    f"{change_op[KEY_CTR]}@{actor_ids[change_op[KEY_ACTOR]]}"
                )

        elif key_matches or list_elem_matches or found_list_elem:
            # Update the doc op's succ with any change ops whose pred matches
            for op_index, op in enumerate(change_ops):
                for i in range(op[PRED_NUM]):
                    if op[PRED_ACTOR][i] == doc_op[ID_ACTOR] and op[PRED_CTR][i] == doc_op[ID_CTR]:
                        # Copy-on-write so rows shared with the committed
                        # state are never mutated in place
                        doc_op = list(doc_op)
                        doc_op[SUCC_ACTOR] = list(doc_op[SUCC_ACTOR])
                        doc_op[SUCC_CTR] = list(doc_op[SUCC_CTR])
                        j = 0
                        while j < doc_op[SUCC_NUM] and (
                            doc_op[SUCC_CTR][j] < op[ID_CTR]
                            or (doc_op[SUCC_CTR][j] == op[ID_CTR]
                                and actor_ids[doc_op[SUCC_ACTOR][j]] < id_actor)
                        ):
                            j += 1
                        doc_op[SUCC_CTR].insert(j, op[ID_CTR])
                        doc_op[SUCC_ACTOR].insert(j, id_actor_index)
                        doc_op[SUCC_NUM] += 1
                        pred_seen[op_index][i] = True
                        break

            if list_elem_matches:
                found_list_elem = True

            if found_list_elem and not list_elem_matches:
                take_change_ops = len(change_ops)
            elif not change_ops or doc_op[ID_CTR] < change_op[ID_CTR] or (
                doc_op[ID_CTR] == change_op[ID_CTR]
                and actor_ids[doc_op[ID_ACTOR]] < id_actor
            ):
                take_doc_op = True
                _update_patch_property(
                    patches, object_id, doc_op, doc_state, prop_state, list_index,
                    doc_op_old_succ_num, False,
                )
                # Deletion ops are represented only by succ entries; remove
                # fully-seen del ops from the pending change ops
                for i in range(len(change_ops) - 1, -1, -1):
                    deleted = all(pred_seen[i])
                    op_action = change_ops[i][ACTION]
                    if op_action < len(ACTIONS) and ACTIONS[op_action] == "del" and deleted:
                        change_ops.pop(i)
                        pred_seen.pop(i)
            elif doc_op[ID_CTR] == change_op[ID_CTR] and actor_ids[doc_op[ID_ACTOR]] == id_actor:
                raise CausalityError(f"duplicate operation ID: {change_op[ID_CTR]}@{id_actor}")
            else:
                take_change_ops = 1
        else:
            take_doc_op = True

        if take_doc_op:
            out_rows.append(doc_op)
            if doc_op[INSERT] and elem_visible:
                elem_visible = False
                list_index += 1
            if doc_op[SUCC_NUM] == 0:
                elem_visible = True
            read_next_doc_op()

        if take_change_ops > 0:
            for i in range(take_change_ops):
                op = change_ops[i]
                for j in range(op[PRED_NUM]):
                    if not pred_seen[i][j]:
                        raise CausalityError(
                            "no matching operation for pred: "
                            f"{op[PRED_CTR][j]}@{actor_ids[op[PRED_ACTOR][j]]}"
                        )
                new_row = op[:13] + [0, [], []]
                out_rows.append(new_row)
                _update_patch_property(
                    patches, object_id, new_row, doc_state, prop_state, list_index, None, False
                )
                if op[INSERT]:
                    elem_visible = False
                    list_index += 1
                else:
                    elem_visible = True
            del change_ops[:take_change_ops]
            del pred_seen[:take_change_ops]

    if doc_op is not None:
        out_rows.append(doc_op)
    return doc_ops_consumed


def _apply_ops(patches, change_state, doc_state):
    """Applies one run of change ops: seek, merge, splice (port of applyOps,
    new.js:1304)."""
    op = change_state.next_op
    actor_ids = doc_state.actor_ids
    ops_info = {
        "objActor": None if op[OBJ_ACTOR] is None else actor_ids[op[OBJ_ACTOR]],
        "objCtr": op[OBJ_CTR],
        "keyActor": None if op[KEY_ACTOR] is None else actor_ids[op[KEY_ACTOR]],
        "keyCtr": op[KEY_CTR],
        "keyStr": op[KEY_STR],
        "idActor": actor_ids[op[ID_ACTOR]],
        "idCtr": op[ID_CTR],
        "insert": op[INSERT],
    }
    skip_count, visible_count = _seek_to_op(doc_state, ops_info)
    out_rows = []
    consumed = _merge_doc_change_ops(
        patches, out_rows, change_state, doc_state, visible_count, skip_count
    )
    doc_state.ops[skip_count : skip_count + consumed] = out_rows


def _setup_patches(patches, object_ids, doc_state):
    """Links child-object patches into their parents up to the root
    (port of setupPatches, new.js:1461)."""
    for object_id in object_ids:
        meta = doc_state.object_meta[object_id]
        child_meta = None
        patch_exists = False
        while True:
            has_children = (
                child_meta is not None
                and len(meta["children"].get(child_meta["parentKey"], {})) > 0
            )
            if object_id not in patches:
                patches[object_id] = _empty_object_patch(object_id, meta["type"])

            if child_meta is not None and has_children:
                if meta["type"] in ("list", "text"):
                    for edit in patches[object_id]["edits"]:
                        if edit.get("opId") and edit["opId"] in meta["children"][child_meta["parentKey"]]:
                            patch_exists = True
                    if not patch_exists:
                        obj = parse_op_id(object_id)
                        elem = parse_op_id(child_meta["parentKey"])
                        seek_pos = {
                            "objActor": obj.actor_id,
                            "objCtr": obj.counter,
                            "keyActor": elem.actor_id,
                            "keyCtr": elem.counter,
                            "keyStr": None,
                            "insert": False,
                            "idActor": None,
                            "idCtr": None,
                        }
                        _skip, visible_count = _seek_to_op(doc_state, seek_pos)
                        for op_id, value in meta["children"][child_meta["parentKey"]].items():
                            patch_value = value
                            if value.get("objectId"):
                                if value["objectId"] not in patches:
                                    patches[value["objectId"]] = _empty_object_patch(
                                        value["objectId"], value["type"]
                                    )
                                patch_value = patches[value["objectId"]]
                            edit = {"action": "update", "index": visible_count, "opId": op_id, "value": patch_value}
                            append_edit(patches[object_id]["edits"], edit)
                else:
                    if child_meta["parentKey"] not in patches[object_id]["props"]:
                        patches[object_id]["props"][child_meta["parentKey"]] = {}
                    values = patches[object_id]["props"][child_meta["parentKey"]]
                    for op_id, value in meta["children"][child_meta["parentKey"]].items():
                        if op_id in values:
                            patch_exists = True
                        elif value.get("objectId"):
                            if value["objectId"] not in patches:
                                patches[value["objectId"]] = _empty_object_patch(
                                    value["objectId"], value["type"]
                                )
                            values[op_id] = patches[value["objectId"]]
                        else:
                            values[op_id] = value

            if patch_exists or not meta["parentObj"] or (child_meta is not None and not has_children):
                break
            child_meta = meta
            object_id = meta["parentObj"]
            meta = doc_state.object_meta[object_id]
    return patches


def _apply_change_batch(patches, decoded_changes, doc_state, object_ids, throw_exceptions):
    """Causal gate + application loop (port of the applyChanges function,
    new.js:1550). Returns (applied, enqueued)."""
    heads = set(doc_state.heads)
    change_hashes = set()
    clock = dict(doc_state.clock)
    applied, enqueued = [], []

    for change in decoded_changes:
        if change["hash"] in doc_state.change_index_by_hash or change["hash"] in change_hashes:
            continue
        expected_seq = clock.get(change["actor"], 0) + 1
        causally_ready = True
        for dep in change["deps"]:
            dep_index = doc_state.change_index_by_hash.get(dep)
            if (dep_index is None or dep_index == -1) and dep not in change_hashes:
                causally_ready = False
        if not causally_ready:
            enqueued.append(change)
        elif change["seq"] < expected_seq:
            if throw_exceptions:
                raise CausalityError(
                    f"Reuse of sequence number {change['seq']} for actor {change['actor']}"
                )
            return [], decoded_changes
        elif change["seq"] > expected_seq:
            raise CausalityError(f"Skipped sequence number {expected_seq} for actor {change['actor']}")
        else:
            clock[change["actor"]] = change["seq"]
            change_hashes.add(change["hash"])
            for dep in change["deps"]:
                heads.discard(dep)
            heads.add(change["hash"])
            applied.append(change)

    if applied:
        change_state = _ChangeState(applied, object_ids)
        _read_next_change_op(doc_state, change_state)
        while not change_state.done:
            _apply_ops(patches, change_state, doc_state)
        doc_state.heads = sorted(heads)
        doc_state.clock = clock
    return applied, enqueued


def _document_patch(doc_state):
    """Scans all ops and generates the init patch for the whole document
    (port of documentPatch, new.js:1604)."""
    prop_state = {}
    patches = {"_root": {"objectId": "_root", "type": "map", "props": {}}}
    last_obj_actor = None
    last_obj_ctr = None
    object_id = "_root"
    elem_visible = False
    list_index = 0

    for doc_op in doc_state.ops:
        if doc_op[OBJ_ACTOR] != last_obj_actor or doc_op[OBJ_CTR] != last_obj_ctr:
            object_id = f"{doc_op[OBJ_CTR]}@{doc_state.actor_ids[doc_op[OBJ_ACTOR]]}"
            last_obj_actor = doc_op[OBJ_ACTOR]
            last_obj_ctr = doc_op[OBJ_CTR]
            prop_state = {}
            list_index = 0
            elem_visible = False

        if doc_op[INSERT] and elem_visible:
            elem_visible = False
            list_index += 1
        if doc_op[SUCC_NUM] == 0:
            elem_visible = True
        if doc_op[ID_CTR] > doc_state.max_op:
            doc_state.max_op = doc_op[ID_CTR]
        for i in range(doc_op[SUCC_NUM]):
            if doc_op[SUCC_CTR][i] > doc_state.max_op:
                doc_state.max_op = doc_op[SUCC_CTR][i]

        _update_patch_property(
            patches, object_id, doc_op, doc_state, prop_state, list_index,
            doc_op[SUCC_NUM], True,
        )
    return patches["_root"]


class OpSet:
    """Backend document state (port of BackendDoc, new.js:1694)."""

    def __init__(self, buffer=None):
        self.max_op = 0
        self.have_hash_graph = False
        self.changes = []  # binary changes (bytes), in application order
        self.change_index_by_hash = {}
        self.dependencies_by_hash = {}
        self.dependents_by_hash = {}
        self.hashes_by_actor = {}
        self.actor_ids = []
        self.heads = []
        self.clock = {}
        self.queue = []
        self.object_meta = {
            "_root": {"parentObj": None, "parentKey": None, "opId": None, "type": "map", "children": {}}
        }
        self.ops = []  # flat doc op rows
        self.change_meta = []  # per-change metadata for the document format
        self.binary_doc = None
        self.init_patch = None
        self.extra_bytes = None

        if buffer is not None:
            doc = decode_document_header(buffer)
            self.binary_doc = bytes(buffer)
            self.actor_ids = doc["actorIds"]
            self.heads = doc["heads"]
            self.extra_bytes = doc["extraBytes"]
            clock, head_actors, change_meta = self._read_document_changes(doc)
            self.clock = clock
            self.change_meta = change_meta
            self.changes = [None] * len(change_meta)

            if len(doc["heads"]) == 1 and len(head_actors) == 1:
                self.hashes_by_actor[head_actors[0]] = [None] * clock[head_actors[0]]
                self.hashes_by_actor[head_actors[0]][clock[head_actors[0]] - 1] = doc["heads"][0]

            if len(doc["heads"]) == len(doc["headsIndexes"]):
                for head, index in zip(doc["heads"], doc["headsIndexes"]):
                    self.change_index_by_hash[head] = index
            elif len(doc["heads"]) == 1:
                self.change_index_by_hash[doc["heads"][0]] = len(change_meta) - 1
            else:
                for head in doc["heads"]:
                    self.change_index_by_hash[head] = -1

            self.ops = _read_op_rows(doc["opsColumns"], DOC_OPS_COLUMNS)
            doc_state = _DocState(self)
            doc_state.object_meta = self.object_meta
            doc_state.max_op = 0
            self.init_patch = _document_patch(doc_state)
            self.max_op = doc_state.max_op
        else:
            self.have_hash_graph = True

    @staticmethod
    def _read_document_changes(doc):
        """Reads the change-metadata columns of a loaded document
        (port of readDocumentChanges, new.js:1645)."""
        rows = decode_columns(doc["changesColumns"], doc["actorIds"], DOCUMENT_COLUMNS)
        clock = {}
        head_indexes = set()
        change_meta = []
        for i, row in enumerate(rows):
            actor_id = row["actor"]
            seq = row["seq"]
            if seq != 1 and seq != clock.get(actor_id, 0) + 1:
                raise CausalityError(f"Expected seq {clock.get(actor_id, 0) + 1}, got {seq} for actor {actor_id}")
            clock[actor_id] = seq
            head_indexes.add(i)
            deps_indexes = [d["depsIndex"] for d in row["depsNum"]]
            for dep in deps_indexes:
                head_indexes.discard(dep)
            change_meta.append(
                {
                    "actor": actor_id,
                    "seq": seq,
                    "maxOp": row["maxOp"],
                    "time": row["time"],
                    "message": row["message"],
                    "depsIndexes": deps_indexes,
                    "extraBytes": row.get("extraLen") or b"",
                }
            )
        head_actors = sorted(change_meta[i]["actor"] for i in head_indexes)
        return clock, head_actors, change_meta

    def clone(self):
        copy = OpSet()
        copy.max_op = self.max_op
        copy.have_hash_graph = self.have_hash_graph
        copy.changes = list(self.changes)
        copy.change_index_by_hash = dict(self.change_index_by_hash)
        copy.dependencies_by_hash = dict(self.dependencies_by_hash)
        copy.dependents_by_hash = {k: list(v) for k, v in self.dependents_by_hash.items()}
        copy.hashes_by_actor = {k: list(v) for k, v in self.hashes_by_actor.items()}
        copy.actor_ids = self.actor_ids
        copy.heads = self.heads
        copy.clock = self.clock
        copy.ops = self.ops
        copy.object_meta = self.object_meta
        copy.queue = self.queue
        copy.change_meta = list(self.change_meta)
        copy.binary_doc = self.binary_doc
        copy.init_patch = self.init_patch
        copy.extra_bytes = self.extra_bytes
        return copy

    def apply_changes(self, change_buffers, is_local=False):
        """Parses binary changes and applies them; returns a patch
        (port of BackendDoc.applyChanges, new.js:1796)."""
        decoded_changes = []
        for buffer in change_buffers:
            decoded = decode_change_columns(buffer)
            decoded["buffer"] = bytes(buffer)
            decoded_changes.append(decoded)

        patches = {"_root": {"objectId": "_root", "type": "map", "props": {}}}
        doc_state = _DocState(self)
        # Work on a copy of the hash index so a delivery that raises midway
        # (seq reuse in a later gate batch, a corrupt change) cannot leave
        # phantom hashes behind: the committed index is only swapped in at
        # the commit point below (error-path atomicity for the sync layer
        # and the farm's per-doc quarantine).
        doc_state.change_index_by_hash = dict(self.change_index_by_hash)

        queue = decoded_changes if not self.queue else decoded_changes + self.queue
        all_applied = []
        object_ids = set()

        while True:
            applied, enqueued = _apply_change_batch(
                patches, queue, doc_state, object_ids, self.have_hash_graph
            )
            queue = enqueued
            for i, change in enumerate(applied):
                doc_state.change_index_by_hash[change["hash"]] = (
                    len(self.changes) + len(all_applied) + i
                )
            if applied:
                all_applied.extend(applied)
            if not queue:
                break
            if not applied:
                if self.have_hash_graph:
                    break
                self.compute_hash_graph()
                doc_state.change_index_by_hash = dict(self.change_index_by_hash)
                for i, change in enumerate(all_applied):
                    doc_state.change_index_by_hash[change["hash"]] = (
                        len(self.changes) + i
                    )

        _setup_patches(patches, object_ids, doc_state)

        # Commit (only reached if no exception was raised)
        self.change_index_by_hash = doc_state.change_index_by_hash
        for change in all_applied:
            self.changes.append(change["buffer"])
            self.hashes_by_actor.setdefault(change["actor"], [])
            actor_hashes = self.hashes_by_actor[change["actor"]]
            while len(actor_hashes) < change["seq"]:
                actor_hashes.append(None)
            actor_hashes[change["seq"] - 1] = change["hash"]
            self.change_index_by_hash[change["hash"]] = len(self.changes) - 1
            self.dependencies_by_hash[change["hash"]] = change["deps"]
            self.dependents_by_hash[change["hash"]] = []
            for dep in change["deps"]:
                self.dependents_by_hash.setdefault(dep, []).append(change["hash"])
            self.change_meta.append(
                {
                    "actor": change["actor"],
                    "seq": change["seq"],
                    "maxOp": change["maxOp"],
                    "time": change["time"],
                    "message": change["message"],
                    "depsIndexes": [self.change_index_by_hash[d] for d in change["deps"]],
                    "extraBytes": change.get("extraBytes", b"") or b"",
                }
            )

        self.max_op = doc_state.max_op
        self.actor_ids = doc_state.actor_ids
        self.heads = doc_state.heads
        self.clock = doc_state.clock
        self.ops = doc_state.ops
        self.object_meta = doc_state.object_meta
        self.queue = queue
        self.binary_doc = None
        self.init_patch = None

        patch = {
            "maxOp": self.max_op,
            "clock": self.clock,
            "deps": self.heads,
            "pendingChanges": len(self.queue),
            "diffs": patches["_root"],
        }
        if is_local and len(decoded_changes) == 1:
            patch["actor"] = decoded_changes[0]["actor"]
            patch["seq"] = decoded_changes[0]["seq"]
        return patch

    def compute_hash_graph(self):
        """Reconstructs the full change history from the current document
        (port of computeHashGraph, new.js:1879)."""
        binary_doc = self.save()
        self.have_hash_graph = True
        self.changes = []
        self.change_index_by_hash = {}
        self.dependencies_by_hash = {}
        self.dependents_by_hash = {}
        self.hashes_by_actor = {}
        self.clock = {}

        for change in decode_changes([binary_doc]):
            binary_change = encode_change(change)
            self.changes.append(binary_change)
            self.change_index_by_hash[change["hash"]] = len(self.changes) - 1
            self.dependencies_by_hash[change["hash"]] = change["deps"]
            self.dependents_by_hash[change["hash"]] = []
            for dep in change["deps"]:
                self.dependents_by_hash[dep].append(change["hash"])
            if change["seq"] == 1:
                self.hashes_by_actor[change["actor"]] = []
            self.hashes_by_actor[change["actor"]].append(change["hash"])
            expected_seq = self.clock.get(change["actor"], 0) + 1
            if change["seq"] != expected_seq:
                raise CausalityError(
                    f"Expected seq {expected_seq}, got seq {change['seq']} from actor {change['actor']}"
                )
            self.clock[change["actor"]] = change["seq"]

    def get_changes(self, have_deps):
        """Returns changes to send to a replica that has `have_deps`
        (port of getChanges, new.js:1913)."""
        if not self.have_hash_graph:
            self.compute_hash_graph()
        if not have_deps:
            return list(self.changes)

        stack = []
        seen_hashes = {}
        to_return = []
        for h in have_deps:
            seen_hashes[h] = True
            successors = self.dependents_by_hash.get(h)
            if successors is None:
                raise CausalityError(f"hash not found: {h}")
            stack.extend(successors)

        while stack:
            h = stack.pop()
            seen_hashes[h] = True
            to_return.append(h)
            if not all(seen_hashes.get(dep) for dep in self.dependencies_by_hash[h]):
                break
            stack.extend(self.dependents_by_hash[h])

        if not stack and all(seen_hashes.get(head) for head in self.heads):
            return [self.changes[self.change_index_by_hash[h]] for h in to_return]

        stack = list(have_deps)
        seen_hashes = {}
        while stack:
            h = stack.pop()
            if h not in seen_hashes:
                deps = self.dependencies_by_hash.get(h)
                if deps is None:
                    raise CausalityError(f"hash not found: {h}")
                stack.extend(deps)
                seen_hashes[h] = True

        return [
            change
            for change in self.changes
            if decode_change_meta(change, True)["hash"] not in seen_hashes
        ]

    def get_changes_added(self, other):
        """Returns changes present here but not in `other`
        (port of getChangesAdded, new.js:1971)."""
        if not self.have_hash_graph:
            self.compute_hash_graph()
        stack = list(self.heads)
        seen_hashes = {}
        to_return = []
        while stack:
            h = stack.pop()
            if h not in seen_hashes and other.change_index_by_hash.get(h) is None:
                seen_hashes[h] = True
                to_return.append(h)
                stack.extend(self.dependencies_by_hash[h])
        return [self.changes[self.change_index_by_hash[h]] for h in reversed(to_return)]

    def get_change_by_hash(self, hash_):
        if not self.have_hash_graph:
            self.compute_hash_graph()
        index = self.change_index_by_hash.get(hash_)
        return self.changes[index] if index is not None and index >= 0 else None

    def get_missing_deps(self, heads=()):
        """Returns hashes of missing dependencies (port of getMissingDeps,
        new.js:2006)."""
        if not self.have_hash_graph:
            self.compute_hash_graph()
        all_deps = set(heads)
        in_queue = set()
        for change in self.queue:
            in_queue.add(change["hash"])
            for dep in change["deps"]:
                all_deps.add(dep)
        missing = [
            h for h in all_deps if self.change_index_by_hash.get(h) is None and h not in in_queue
        ]
        return sorted(missing)

    def save(self):
        """Serialises the document into the binary document format
        (port of save, new.js:2025). Byte-identical to the reference because
        all columns are deterministic re-encodings of the maintained op and
        change-metadata sequences."""
        if self.binary_doc:
            return self.binary_doc
        self.binary_doc = encode_document_header(
            {
                "changesColumns": self._encode_change_columns(),
                "opsColumns": self._encode_ops_columns(),
                "actorIds": self.actor_ids,
                "heads": self.heads,
                "headsIndexes": [self.change_index_by_hash[h] for h in self.heads],
                "extraBytes": self.extra_bytes,
            }
        )
        return self.binary_doc

    def _encode_ops_columns(self, force_python=False):
        """Encodes the flat op rows into document op columns. Uses the native
        C++ codec library for the numeric columns when available (byte-
        identical output; see automerge_tpu/native.py)."""
        if not force_python:
            native_cols = self._encode_ops_columns_native()
            if native_cols is not None:
                return native_cols
        encoders = [encoder_by_column_id(cid) for _name, cid in DOC_OPS_COLUMNS]
        for row in self.ops:
            for i in range(13):
                if i == INSERT:
                    encoders[i].append_value(bool(row[i]))
                elif i == VAL_RAW:
                    if row[VAL_RAW]:
                        encoders[i].append_raw_bytes(row[VAL_RAW])
                elif i == VAL_LEN:
                    encoders[i].append_value(row[i])
                else:
                    encoders[i].append_value(row[i])
            encoders[SUCC_NUM].append_value(row[SUCC_NUM])
            for a in row[SUCC_ACTOR]:
                encoders[SUCC_ACTOR].append_value(a)
            for c in row[SUCC_CTR]:
                encoders[SUCC_CTR].append_value(c)
        return [
            (cid, enc.buffer) for (_name, cid), enc in zip(DOC_OPS_COLUMNS, encoders)
        ]

    def _encode_ops_columns_native(self):
        """Bulk column encode through the native codec library. Returns None
        when the library is unavailable (pure-Python fallback is used)."""
        try:
            from . import native
        except ImportError:
            return None
        if not native.available():
            return None
        import numpy as np

        ops = self.ops
        sent = native.NULL_SENTINEL

        def column(idx, transform=None):
            return np.array(
                [sent if row[idx] is None else (transform(row[idx]) if transform else row[idx])
                 for row in ops],
                np.int64,
            )

        out = []
        for name, cid in DOC_OPS_COLUMNS:
            if name == "keyStr":
                enc = encoder_by_column_id(cid)
                for row in ops:
                    enc.append_value(row[KEY_STR])
                out.append((cid, enc.buffer))
            elif name == "valRaw":
                out.append((cid, b"".join(row[VAL_RAW] or b"" for row in ops)))
            elif name == "insert":
                out.append((cid, native.bool_encode(
                    np.array([bool(row[INSERT]) for row in ops], np.uint8))))
            elif name == "keyCtr":
                out.append((cid, native.delta_encode(column(KEY_CTR))))
            elif name == "idCtr":
                out.append((cid, native.delta_encode(column(ID_CTR))))
            elif name == "chldCtr":
                out.append((cid, native.delta_encode(column(CHLD_CTR))))
            elif name == "succCtr":
                flat = [c for row in ops for c in row[SUCC_CTR]]
                out.append((cid, native.delta_encode(np.array(flat, np.int64))))
            elif name == "succActor":
                flat = [a for row in ops for a in row[SUCC_ACTOR]]
                out.append((cid, native.rle_encode(np.array(flat, np.int64))))
            elif name == "objActor":
                out.append((cid, native.rle_encode(column(OBJ_ACTOR))))
            elif name == "objCtr":
                out.append((cid, native.rle_encode(column(OBJ_CTR))))
            elif name == "keyActor":
                out.append((cid, native.rle_encode(column(KEY_ACTOR))))
            elif name == "idActor":
                out.append((cid, native.rle_encode(column(ID_ACTOR))))
            elif name == "action":
                out.append((cid, native.rle_encode(column(ACTION))))
            elif name == "valLen":
                out.append((cid, native.rle_encode(column(VAL_LEN))))
            elif name == "chldActor":
                out.append((cid, native.rle_encode(column(CHLD_ACTOR))))
            elif name == "succNum":
                out.append((cid, native.rle_encode(column(SUCC_NUM))))
            else:
                return None
        return out

    def _encode_change_columns(self):
        """Encodes change metadata into document change columns
        (port of appendChange, new.js:1680)."""
        encoders = [encoder_by_column_id(cid) for _name, cid in DOCUMENT_COLUMNS]
        actor_index = {a: i for i, a in enumerate(self.actor_ids)}
        for meta in self.change_meta:
            encoders[0].append_value(actor_index[meta["actor"]])
            encoders[1].append_value(meta["seq"])
            encoders[2].append_value(meta["maxOp"])
            encoders[3].append_value(meta["time"])
            encoders[4].append_value(meta["message"] if meta["message"] is not None else "")
            encoders[5].append_value(len(meta["depsIndexes"]))
            for dep in meta["depsIndexes"]:
                encoders[6].append_value(dep)
            extra = meta["extraBytes"] or b""
            encoders[7].append_value(len(extra) << 4 | ValueType.BYTES)
            if extra:
                encoders[8].append_raw_bytes(extra)
        return [
            (cid, enc.buffer) for (_name, cid), enc in zip(DOCUMENT_COLUMNS, encoders)
        ]

    def get_patch(self):
        """Returns a patch that reconstructs the current document state
        (port of getPatch, new.js:2052)."""
        if self.init_patch is not None:
            diffs = self.init_patch
        else:
            object_meta = {
                "_root": {"parentObj": None, "parentKey": None, "opId": None, "type": "map", "children": {}}
            }
            doc_state = _DocState(self)
            doc_state.object_meta = object_meta
            doc_state.max_op = 0
            diffs = _document_patch(doc_state)
        return {
            "maxOp": self.max_op,
            "clock": self.clock,
            "deps": self.heads,
            "pendingChanges": len(self.queue),
            "diffs": diffs,
        }

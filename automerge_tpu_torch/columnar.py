"""L1 binary format: column schemas, containers, change/document transcoding.

Byte-compatible with the reference implementation's columnar layer
(the reference implementation's backend/columnar.js): same column IDs, value-type tags,
container framing (magic bytes + SHA-256 checksum + chunk type), change
chunk layout and document chunk layout. SHA-256 via hashlib, DEFLATE via
zlib (raw streams).
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations

import os
import struct
import zlib
from hashlib import sha256

import numpy as np

from .codecs import (
    MAX_SAFE_INTEGER,
    MIN_SAFE_INTEGER,
    BooleanDecoder,
    BooleanEncoder,
    Decoder,
    DecodeCache,
    DeltaDecoder,
    DeltaEncoder,
    Encoder,
    RLEDecoder,
    RLEEncoder,
    bytes_to_hex,
    hex_to_bytes,
)
from .common import parse_op_id
from .errors import ChecksumError, DecodeError, EncodeError
from .obs.metrics import get_metrics

# These bytes don't mean anything, they were generated randomly
# (columnar.js:24); they identify an Automerge binary container.
MAGIC_BYTES = bytes([0x85, 0x6F, 0x4A, 0x83])

CHUNK_TYPE_DOCUMENT = 0
CHUNK_TYPE_CHANGE = 1
CHUNK_TYPE_DEFLATE = 2  # like CHUNK_TYPE_CHANGE but with DEFLATE compression

DEFLATE_MIN_SIZE = 256

#: null marker in the dense int64 column arrays of the array-at-a-time
#: decode path (tpu/decode.py); far outside the 53-bit wire value range
NULL_SENTINEL = -(2**62)


class ColumnType:
    GROUP_CARD = 0
    ACTOR_ID = 1
    INT_RLE = 2
    INT_DELTA = 3
    BOOLEAN = 4
    STRING_RLE = 5
    VALUE_LEN = 6
    VALUE_RAW = 7


COLUMN_TYPE_DEFLATE = 8


class ValueType:
    NULL = 0
    FALSE = 1
    TRUE = 2
    LEB128_UINT = 3
    LEB128_INT = 4
    IEEE754 = 5
    UTF8 = 6
    BYTES = 7
    COUNTER = 8
    TIMESTAMP = 9
    MIN_UNKNOWN = 10
    MAX_UNKNOWN = 15


# make* actions must be at even-numbered indexes in this list (columnar.js:51)
ACTIONS = ["makeMap", "set", "makeList", "del", "makeText", "inc", "makeTable", "link"]

OBJECT_TYPE = {"makeMap": "map", "makeList": "list", "makeText": "text", "makeTable": "table"}

COMMON_COLUMNS = [
    ("objActor", 0 << 4 | ColumnType.ACTOR_ID),
    ("objCtr", 0 << 4 | ColumnType.INT_RLE),
    ("keyActor", 1 << 4 | ColumnType.ACTOR_ID),
    ("keyCtr", 1 << 4 | ColumnType.INT_DELTA),
    ("keyStr", 1 << 4 | ColumnType.STRING_RLE),
    ("idActor", 2 << 4 | ColumnType.ACTOR_ID),
    ("idCtr", 2 << 4 | ColumnType.INT_DELTA),
    ("insert", 3 << 4 | ColumnType.BOOLEAN),
    ("action", 4 << 4 | ColumnType.INT_RLE),
    ("valLen", 5 << 4 | ColumnType.VALUE_LEN),
    ("valRaw", 5 << 4 | ColumnType.VALUE_RAW),
    ("chldActor", 6 << 4 | ColumnType.ACTOR_ID),
    ("chldCtr", 6 << 4 | ColumnType.INT_DELTA),
]

CHANGE_COLUMNS = COMMON_COLUMNS + [
    ("predNum", 7 << 4 | ColumnType.GROUP_CARD),
    ("predActor", 7 << 4 | ColumnType.ACTOR_ID),
    ("predCtr", 7 << 4 | ColumnType.INT_DELTA),
]

DOC_OPS_COLUMNS = COMMON_COLUMNS + [
    ("succNum", 8 << 4 | ColumnType.GROUP_CARD),
    ("succActor", 8 << 4 | ColumnType.ACTOR_ID),
    ("succCtr", 8 << 4 | ColumnType.INT_DELTA),
]

DOCUMENT_COLUMNS = [
    ("actor", 0 << 4 | ColumnType.ACTOR_ID),
    ("seq", 0 << 4 | ColumnType.INT_DELTA),
    ("maxOp", 1 << 4 | ColumnType.INT_DELTA),
    ("time", 2 << 4 | ColumnType.INT_DELTA),
    ("message", 3 << 4 | ColumnType.STRING_RLE),
    ("depsNum", 4 << 4 | ColumnType.GROUP_CARD),
    ("depsIndex", 4 << 4 | ColumnType.INT_DELTA),
    ("extraLen", 5 << 4 | ColumnType.VALUE_LEN),
    ("extraRaw", 5 << 4 | ColumnType.VALUE_RAW),
]


def deflate_raw(data: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    return comp.compress(bytes(data)) + comp.flush()


def inflate_raw(data: bytes) -> bytes:
    return zlib.decompress(bytes(data), -15)


class ParsedOpId:
    """OpId mapped to an actor-table index (columnar.js:101 actorIdToActorNum)."""

    __slots__ = ("counter", "actor_num", "actor_id")

    def __init__(self, counter, actor_num, actor_id):
        self.counter = counter
        self.actor_num = actor_num
        self.actor_id = actor_id

    def sort_key(self):
        return (self.counter, self.actor_id)


def _parse(op_id: str) -> ParsedOpId:
    p = parse_op_id(op_id)
    return ParsedOpId(p.counter, None, p.actor_id)


def expand_multi_ops(ops, start_op, actor):
    """Expands multi-insert set ops and multiOp deletions into individual ops
    (columnar.js:446)."""
    op_num = start_op
    expanded = []
    for op in ops:
        if op.get("action") == "set" and op.get("values") is not None and op.get("insert"):
            if op.get("pred"):
                raise EncodeError("multi-insert pred must be empty")
            last_elem_id = op.get("elemId")
            datatype = op.get("datatype")
            for value in op["values"]:
                if not _valid_datatype(value, datatype):
                    raise EncodeError(
                        f"Decode failed: bad value/datatype association ({value},{datatype})"
                    )
                new_op = {
                    "action": "set",
                    "obj": op["obj"],
                    "elemId": last_elem_id,
                    "value": value,
                    "pred": [],
                    "insert": True,
                }
                if datatype is not None:
                    new_op["datatype"] = datatype
                expanded.append(new_op)
                last_elem_id = f"{op_num}@{actor}"
                op_num += 1
        elif op.get("action") == "del" and op.get("multiOp", 0) > 1:
            if len(op.get("pred", [])) != 1:
                raise EncodeError("multiOp deletion must have exactly one pred")
            start_elem = parse_op_id(op["elemId"])
            start_pred = parse_op_id(op["pred"][0])
            for i in range(op["multiOp"]):
                expanded.append(
                    {
                        "action": "del",
                        "obj": op["obj"],
                        "elemId": f"{start_elem.counter + i}@{start_elem.actor_id}",
                        "pred": [f"{start_pred.counter + i}@{start_pred.actor_id}"],
                    }
                )
                op_num += 1
        else:
            expanded.append(op)
            op_num += 1
    return expanded


def _valid_datatype(value, datatype):
    if datatype is None:
        return isinstance(value, (str, bool)) or value is None
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def parse_all_op_ids(changes, single):
    """Parses string opIds in changes into ParsedOpId form and builds the
    actor-ID table (columnar.js:133)."""
    actors = {}
    new_changes = []
    for change in changes:
        change = dict(change)
        actors[change["actor"]] = True
        change["ops"] = expand_multi_ops(change["ops"], change["startOp"], change["actor"])
        parsed_ops = []
        for op in change["ops"]:
            op = dict(op)
            if op["obj"] != "_root":
                op["obj"] = _parse(op["obj"])
                actors[op["obj"].actor_id] = True
            if op.get("elemId") and op["elemId"] != "_head":
                op["elemId"] = _parse(op["elemId"])
                actors[op["elemId"].actor_id] = True
            if op.get("child"):
                op["child"] = _parse(op["child"])
                actors[op["child"].actor_id] = True
            op["pred"] = [_parse(p) for p in op.get("pred", [])]
            for pred in op["pred"]:
                actors[pred.actor_id] = True
            parsed_ops.append(op)
        change["ops"] = parsed_ops
        new_changes.append(change)

    actor_ids = sorted(actors.keys())
    if single:
        author = changes[0]["actor"]
        actor_ids = [author] + [a for a in actor_ids if a != author]

    index_of = {a: i for i, a in enumerate(actor_ids)}
    for change in new_changes:
        change["actorNum"] = index_of[change["actor"]]
        for i, op in enumerate(change["ops"]):
            op["id"] = ParsedOpId(change["startOp"] + i, change["actorNum"], change["actor"])
            for field in ("obj", "elemId", "child"):
                v = op.get(field)
                if isinstance(v, ParsedOpId):
                    v.actor_num = index_of[v.actor_id]
            for pred in op["pred"]:
                pred.actor_num = index_of[pred.actor_id]
    return new_changes, actor_ids


def _get_number_type_and_value(op):
    """Determines the value-type tag for a numeric value (columnar.js:228)."""
    datatype = op.get("datatype")
    value = op["value"]
    if datatype == "counter":
        return ValueType.COUNTER, value
    if datatype == "timestamp":
        return ValueType.TIMESTAMP, value
    if datatype == "uint":
        return ValueType.LEB128_UINT, value
    if datatype == "int":
        return ValueType.LEB128_INT, value
    if datatype == "float64":
        return ValueType.IEEE754, struct.pack("<d", value)
    if (
        isinstance(value, int)
        and not isinstance(value, bool)
        and MIN_SAFE_INTEGER <= value <= MAX_SAFE_INTEGER
    ):
        return ValueType.LEB128_INT, value
    return ValueType.IEEE754, struct.pack("<d", value)


def encode_value(op, columns):
    """Encodes op['value'] into the valLen/valRaw columns (columnar.js:259)."""
    value = op.get("value")
    datatype = op.get("datatype")
    if (op["action"] not in ("set", "inc")) or value is None:
        columns["valLen"].append_value(ValueType.NULL)
    elif value is False:
        columns["valLen"].append_value(ValueType.FALSE)
    elif value is True:
        columns["valLen"].append_value(ValueType.TRUE)
    elif isinstance(value, str):
        num_bytes = columns["valRaw"].append_raw_string(value)
        columns["valLen"].append_value(num_bytes << 4 | ValueType.UTF8)
    elif isinstance(value, (bytes, bytearray)) and not (
        isinstance(datatype, int) and ValueType.MIN_UNKNOWN <= datatype <= ValueType.MAX_UNKNOWN
    ):
        num_bytes = columns["valRaw"].append_raw_bytes(value)
        columns["valLen"].append_value(num_bytes << 4 | ValueType.BYTES)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        type_tag, enc = _get_number_type_and_value(op)
        if type_tag == ValueType.LEB128_UINT:
            num_bytes = columns["valRaw"].append_uint53(enc)
        elif type_tag == ValueType.IEEE754:
            num_bytes = columns["valRaw"].append_raw_bytes(enc)
        else:
            num_bytes = columns["valRaw"].append_int53(enc)
        columns["valLen"].append_value(num_bytes << 4 | type_tag)
    elif (
        isinstance(datatype, int)
        and ValueType.MIN_UNKNOWN <= datatype <= ValueType.MAX_UNKNOWN
        and isinstance(value, (bytes, bytearray))
    ):
        num_bytes = columns["valRaw"].append_raw_bytes(value)
        columns["valLen"].append_value(num_bytes << 4 | datatype)
    elif datatype:
        raise EncodeError(f"Unknown datatype {datatype} for value {value}")
    else:
        raise EncodeError(f"Unsupported value in operation: {value}")


def decode_value(size_tag, data):
    """Decodes a (valLen tag, valRaw bytes) pair into {'value': v, 'datatype': d}
    (columnar.js:300)."""
    if size_tag == ValueType.NULL:
        return {"value": None}
    if size_tag == ValueType.FALSE:
        return {"value": False}
    if size_tag == ValueType.TRUE:
        return {"value": True}
    tag = size_tag % 16
    if tag == ValueType.UTF8:
        return {"value": bytes(data).decode("utf-8", "surrogatepass")}
    if tag == ValueType.LEB128_UINT:
        return {"value": Decoder(data).read_uint53(), "datatype": "uint"}
    if tag == ValueType.LEB128_INT:
        return {"value": Decoder(data).read_int53(), "datatype": "int"}
    if tag == ValueType.IEEE754:
        if len(data) == 8:
            return {"value": struct.unpack("<d", bytes(data))[0], "datatype": "float64"}
        raise DecodeError(f"Invalid length for floating point number: {len(data)}")
    if tag == ValueType.COUNTER:
        return {"value": Decoder(data).read_int53(), "datatype": "counter"}
    if tag == ValueType.TIMESTAMP:
        return {"value": Decoder(data).read_int53(), "datatype": "timestamp"}
    return {"value": bytes(data), "datatype": tag}


def encode_ops(ops, for_document):
    """Encodes parsed ops into columns; returns a list of
    (column_id, column_name, encoder) sorted by column id (columnar.js:370)."""
    columns = {
        "objActor": RLEEncoder("uint"),
        "objCtr": RLEEncoder("uint"),
        "keyActor": RLEEncoder("uint"),
        "keyCtr": DeltaEncoder(),
        "keyStr": RLEEncoder("utf8"),
        "insert": BooleanEncoder(),
        "action": RLEEncoder("uint"),
        "valLen": RLEEncoder("uint"),
        "valRaw": Encoder(),
        "chldActor": RLEEncoder("uint"),
        "chldCtr": DeltaEncoder(),
    }
    if for_document:
        columns["idActor"] = RLEEncoder("uint")
        columns["idCtr"] = DeltaEncoder()
        columns["succNum"] = RLEEncoder("uint")
        columns["succActor"] = RLEEncoder("uint")
        columns["succCtr"] = DeltaEncoder()
    else:
        columns["predNum"] = RLEEncoder("uint")
        columns["predCtr"] = DeltaEncoder()
        columns["predActor"] = RLEEncoder("uint")

    for op in ops:
        # objActor/objCtr
        if op["obj"] == "_root":
            columns["objActor"].append_value(None)
            columns["objCtr"].append_value(None)
        elif op["obj"].actor_num >= 0 and op["obj"].counter > 0:
            columns["objActor"].append_value(op["obj"].actor_num)
            columns["objCtr"].append_value(op["obj"].counter)
        else:
            raise EncodeError(f"Unexpected objectId reference: {op['obj']}")

        # keyActor/keyCtr/keyStr
        if op.get("key") is not None:
            columns["keyActor"].append_value(None)
            columns["keyCtr"].append_value(None)
            columns["keyStr"].append_value(op["key"])
        elif op.get("elemId") == "_head" and op.get("insert"):
            columns["keyActor"].append_value(None)
            columns["keyCtr"].append_value(0)
            columns["keyStr"].append_value(None)
        elif op.get("elemId") is not None and op["elemId"].actor_num >= 0 and op["elemId"].counter > 0:
            columns["keyActor"].append_value(op["elemId"].actor_num)
            columns["keyCtr"].append_value(op["elemId"].counter)
            columns["keyStr"].append_value(None)
        else:
            raise EncodeError(f"Unexpected operation key: {op}")

        columns["insert"].append_value(bool(op.get("insert")))

        # action
        action = op["action"]
        if action in ACTIONS:
            columns["action"].append_value(ACTIONS.index(action))
        elif isinstance(action, int):
            columns["action"].append_value(action)
        else:
            raise EncodeError(f"Unexpected operation action: {action}")

        encode_value(op, columns)

        child = op.get("child")
        if child is not None and child.counter:
            columns["chldActor"].append_value(child.actor_num)
            columns["chldCtr"].append_value(child.counter)
        else:
            columns["chldActor"].append_value(None)
            columns["chldCtr"].append_value(None)

        if for_document:
            columns["idActor"].append_value(op["id"].actor_num)
            columns["idCtr"].append_value(op["id"].counter)
            succ = sorted(op["succ"], key=ParsedOpId.sort_key)
            columns["succNum"].append_value(len(succ))
            for s in succ:
                columns["succActor"].append_value(s.actor_num)
                columns["succCtr"].append_value(s.counter)
        else:
            pred = sorted(op["pred"], key=ParsedOpId.sort_key)
            columns["predNum"].append_value(len(pred))
            for p in pred:
                columns["predActor"].append_value(p.actor_num)
                columns["predCtr"].append_value(p.counter)

    spec = DOC_OPS_COLUMNS if for_document else CHANGE_COLUMNS
    column_list = [
        (column_id, name, columns[name]) for name, column_id in spec if name in columns
    ]
    column_list.sort(key=lambda c: c[0])
    return column_list


def decode_ops(rows, for_document):
    """Turns decoded column rows into op dicts in backend form (columnar.js:483)."""
    new_ops = []
    for row in rows:
        obj = "_root" if row["objCtr"] is None else f"{row['objCtr']}@{row['objActor']}"
        if row["keyStr"] is not None:
            elem_id = None
        elif row["keyCtr"] == 0:
            elem_id = "_head"
        else:
            elem_id = f"{row['keyCtr']}@{row['keyActor']}"
        action = ACTIONS[row["action"]] if row["action"] < len(ACTIONS) else row["action"]
        if elem_id is not None:
            new_op = {"obj": obj, "elemId": elem_id, "action": action}
        else:
            new_op = {"obj": obj, "key": row["keyStr"], "action": action}
        new_op["insert"] = bool(row["insert"])
        if action in ("set", "inc"):
            new_op["value"] = row["valLen"]
            if row.get("valLen_datatype") is not None:
                new_op["datatype"] = row["valLen_datatype"]
        if bool(row["chldCtr"] is None) != bool(row["chldActor"] is None):
            raise DecodeError(f"Mismatched child columns: {row['chldCtr']} and {row['chldActor']}")
        if row["chldCtr"] is not None:
            new_op["child"] = f"{row['chldCtr']}@{row['chldActor']}"
        if for_document:
            new_op["id"] = f"{row['idCtr']}@{row['idActor']}"
            new_op["succ"] = [f"{s['succCtr']}@{s['succActor']}" for s in row["succNum"]]
            _check_sorted_op_ids([(s["succCtr"], s["succActor"]) for s in row["succNum"]])
        else:
            new_op["pred"] = [f"{p['predCtr']}@{p['predActor']}" for p in row["predNum"]]
            _check_sorted_op_ids([(p["predCtr"], p["predActor"]) for p in row["predNum"]])
        new_ops.append(new_op)
    return new_ops


def _check_sorted_op_ids(op_ids):
    last = None
    for op_id in op_ids:
        if last is not None and last >= op_id:
            raise DecodeError("operation IDs are not in ascending order")
        last = op_id


def encoder_by_column_id(column_id):
    t = column_id & 7
    if t == ColumnType.INT_DELTA:
        return DeltaEncoder()
    if t == ColumnType.BOOLEAN:
        return BooleanEncoder()
    if t == ColumnType.STRING_RLE:
        return RLEEncoder("utf8")
    if t == ColumnType.VALUE_RAW:
        return Encoder()
    return RLEEncoder("uint")


def decoder_by_column_id(column_id, buffer):
    t = column_id & 7
    if t == ColumnType.INT_DELTA:
        return DeltaDecoder(buffer)
    if t == ColumnType.BOOLEAN:
        return BooleanDecoder(buffer)
    if t == ColumnType.STRING_RLE:
        return RLEDecoder("utf8", buffer)
    if t == ColumnType.VALUE_RAW:
        return Decoder(buffer)
    return RLEDecoder("uint", buffer)


def make_decoders(columns, column_spec):
    """Merges the columns present in the data with the expected column spec,
    instantiating empty decoders for missing columns (columnar.js:553).

    `columns` is a list of (column_id, buffer); `column_spec` is a list of
    (name, column_id). Returns a list of dicts {columnId, columnName?, decoder}.
    """
    empty = b""
    decoders = []
    ci = 0
    si = 0
    while ci < len(columns) or si < len(column_spec):
        if ci == len(columns) or (si < len(column_spec) and column_spec[si][1] < columns[ci][0]):
            name, column_id = column_spec[si]
            decoders.append(
                {"columnId": column_id, "columnName": name, "decoder": decoder_by_column_id(column_id, empty)}
            )
            si += 1
        elif si == len(column_spec) or columns[ci][0] < column_spec[si][1]:
            column_id, buffer = columns[ci]
            decoders.append({"columnId": column_id, "decoder": decoder_by_column_id(column_id, buffer)})
            ci += 1
        else:
            column_id, buffer = columns[ci]
            name = column_spec[si][0]
            decoders.append(
                {"columnId": column_id, "columnName": name, "decoder": decoder_by_column_id(column_id, buffer)}
            )
            ci += 1
            si += 1
    return decoders


def _decode_value_columns(columns, col_index, actor_ids, result):
    """Reads one value from columns[col_index]; returns number of columns
    consumed (columnar.js:339)."""
    col = columns[col_index]
    column_id = col["columnId"]
    name = col.get("columnName")
    if (
        column_id % 8 == ColumnType.VALUE_LEN
        and col_index + 1 < len(columns)
        and columns[col_index + 1]["columnId"] == column_id + 1
    ):
        size_tag = col["decoder"].read_value()
        raw = columns[col_index + 1]["decoder"].read_raw_bytes(size_tag >> 4)
        decoded = decode_value(size_tag, raw)
        result[name] = decoded["value"]
        if decoded.get("datatype") is not None:
            result[name + "_datatype"] = decoded["datatype"]
        return 2
    if column_id % 8 == ColumnType.ACTOR_ID:
        actor_num = col["decoder"].read_value()
        if actor_num is None:
            result[name] = None
        else:
            if actor_num >= len(actor_ids):
                raise DecodeError(f"No actor index {actor_num}")
            result[name] = actor_ids[actor_num]
    else:
        result[name] = col["decoder"].read_value()
    return 1


def decode_columns(columns, actor_ids, column_spec):
    """Decodes a full set of columns into a list of row dicts (columnar.js:577)."""
    columns = make_decoders(columns, column_spec)
    rows = []
    while any(not col["decoder"].done for col in columns):
        row = {}
        col = 0
        while col < len(columns):
            column_id = columns[col]["columnId"]
            group_id = column_id >> 4
            group_cols = 1
            while col + group_cols < len(columns) and columns[col + group_cols]["columnId"] >> 4 == group_id:
                group_cols += 1
            if column_id % 8 == ColumnType.GROUP_CARD:
                values = []
                count = columns[col]["decoder"].read_value()
                for _ in range(count or 0):
                    value = {}
                    offset = 1
                    while offset < group_cols:
                        offset += _decode_value_columns(columns, col + offset, actor_ids, value)
                    values.append(value)
                row[columns[col].get("columnName")] = values
                col += group_cols
            else:
                col += _decode_value_columns(columns, col, actor_ids, row)
        rows.append(row)
    return rows


def decode_column_info(decoder):
    """Reads the (columnId, bufferLen) table from a chunk (columnar.js:609)."""
    column_id_mask = ~COLUMN_TYPE_DEFLATE
    last = -1
    columns = []
    num_columns = decoder.read_uint53()
    for _ in range(num_columns):
        column_id = decoder.read_uint53()
        buffer_len = decoder.read_uint53()
        if (column_id & column_id_mask) <= (last & column_id_mask if last >= 0 else -1):
            raise DecodeError("Columns must be in ascending order")
        last = column_id
        columns.append({"columnId": column_id, "bufferLen": buffer_len})
    return columns


def encode_column_info(encoder, columns):
    """`columns` is a list of (column_id, buffer_bytes)."""
    non_empty = [(cid, buf) for cid, buf in columns if len(buf) > 0]
    encoder.append_uint53(len(non_empty))
    for cid, buf in non_empty:
        encoder.append_uint53(cid)
        encoder.append_uint53(len(buf))


def encode_container(chunk_type, body: bytes):
    """Wraps a chunk body with magic bytes, checksum, type and length
    (columnar.js:659). Returns (hash_hex, bytes)."""
    header = Encoder()
    header.append_byte(chunk_type)
    header.append_uint53(len(body))
    header_buf = header.buffer
    digest = sha256(header_buf + body).digest()
    out = MAGIC_BYTES + digest[:4] + header_buf + body
    return bytes_to_hex(digest), out


def decode_container_header(decoder, compute_hash):
    if decoder.read_raw_bytes(len(MAGIC_BYTES)) != MAGIC_BYTES:
        raise DecodeError("Data does not begin with magic bytes 85 6f 4a 83")
    expected_hash = decoder.read_raw_bytes(4)
    hash_start = decoder.offset
    chunk_type = decoder.read_byte()
    chunk_length = decoder.read_uint53()
    chunk_data = decoder.read_raw_bytes(chunk_length)
    header = {"chunkType": chunk_type, "chunkLength": chunk_length, "chunkData": chunk_data}
    if compute_hash:
        digest = sha256(decoder.buf[hash_start : decoder.offset]).digest()
        if digest[:4] != expected_hash:
            raise ChecksumError("checksum does not match data")
        header["hash"] = bytes_to_hex(digest)
    return header


def decode_change_header(decoder):
    num_deps = decoder.read_uint53()
    deps = [bytes_to_hex(decoder.read_raw_bytes(32)) for _ in range(num_deps)]
    change = {
        "actor": decoder.read_hex_string(),
        "seq": decoder.read_uint53(),
        "startOp": decoder.read_uint53(),
        "time": decoder.read_int53(),
        "message": decoder.read_prefixed_string(),
        "deps": deps,
    }
    actor_ids = [change["actor"]]
    num_actor_ids = decoder.read_uint53()
    for _ in range(num_actor_ids):
        actor_ids.append(decoder.read_hex_string())
    change["actorIds"] = actor_ids
    return change


def encode_change(change_obj) -> bytes:
    """Encodes a change (JS-object form) into the binary change format
    (columnar.js:710). Deflates if large."""
    changes, actor_ids = parse_all_op_ids([change_obj], True)
    change = changes[0]

    body = Encoder()
    deps = change.get("deps")
    if not isinstance(deps, list):
        raise TypeError("deps is not an array")  # amlint: disable=AM401 — argument-type validation
    body.append_uint53(len(deps))
    for h in sorted(deps):
        body.append_raw_bytes(hex_to_bytes(h))
    body.append_hex_string(change["actor"])
    body.append_uint53(change["seq"])
    body.append_uint53(change["startOp"])
    body.append_int53(change["time"])
    body.append_prefixed_string(change.get("message") or "")
    body.append_uint53(len(actor_ids) - 1)
    for actor in actor_ids[1:]:
        body.append_hex_string(actor)

    columns = encode_ops(change["ops"], False)
    column_buffers = [(cid, enc.buffer) for cid, _name, enc in columns]
    encode_column_info(body, column_buffers)
    for _cid, buf in column_buffers:
        body.append_raw_bytes(buf)
    if change.get("extraBytes"):
        body.append_raw_bytes(change["extraBytes"])

    hex_hash, data = encode_container(CHUNK_TYPE_CHANGE, body.buffer)
    if change_obj.get("hash") and change_obj["hash"] != hex_hash:
        raise ChecksumError(f"Change hash does not match encoding: {change_obj['hash']} != {hex_hash}")
    return deflate_change(data) if len(data) >= DEFLATE_MIN_SIZE else data


def decode_change_columns(buffer):
    """Decodes a binary change into header metadata plus raw column buffers
    (columnar.js:741)."""
    buffer = bytes(buffer)
    if buffer[8] == CHUNK_TYPE_DEFLATE:
        buffer = inflate_change(buffer)
    decoder = Decoder(buffer)
    header = decode_container_header(decoder, True)
    chunk = Decoder(header["chunkData"])
    if not decoder.done:
        raise DecodeError("Encoded change has trailing data")
    if header["chunkType"] != CHUNK_TYPE_CHANGE:
        raise DecodeError(f"Unexpected chunk type: {header['chunkType']}")

    change = decode_change_header(chunk)
    columns = decode_column_info(chunk)
    for col in columns:
        if col["columnId"] & COLUMN_TYPE_DEFLATE:
            raise DecodeError("change must not contain deflated columns")
        col["buffer"] = chunk.read_raw_bytes(col["bufferLen"])
    if not chunk.done:
        change["extraBytes"] = chunk.read_raw_bytes(len(chunk.buf) - chunk.offset)

    change["columns"] = columns
    change["hash"] = header["hash"]
    return change


_CHANGE_COLUMN_IDS = {cid: name for name, cid in CHANGE_COLUMNS}


def ops_from_column_arrays(arrs, actor_ids):
    """Backend-form change ops (op dicts) from dense column arrays: the
    views of ``op_records_from_column_arrays``' records, or None where it
    defers."""
    records = op_records_from_column_arrays(arrs, actor_ids)
    return None if records is None else [record_view(op) for op in records]


def op_records_from_column_arrays(arrs, actor_ids):
    """Assembles a change's op records (see ``change_record``) from dense
    column arrays (struct-of-arrays) — the shared back half of the
    array-at-a-time decode paths (native/codecs.cpp and the vectorized
    passes in tpu/decode.py).

    `arrs` maps column names (objActor, objCtr, keyActor, keyCtr, idActor,
    idCtr, action, valLen, chldActor, chldCtr, predNum, predActor, predCtr)
    to int64 arrays with nulls as ``NULL_SENTINEL``, plus "insert"
    (bool array), "keyStr" as a ``(blob bytes, offsets int64[n, 2])`` pair
    (``(-1, -1)`` rows are null) and "valRaw" raw bytes. Missing/short
    columns are padded with nulls exactly like the generic decoder chain
    reading exhausted columns. Returns a tuple of op records, or None when
    the arrays are degenerate for the fast path (the caller falls back to
    the per-op decoder chain, which raises the canonical error). Their
    views are identical to decode_ops(decode_columns(...)) —
    differentially tested."""
    empty_i = np.empty(0, np.int64)
    obj_actor = arrs.get("objActor", empty_i)
    obj_ctr = arrs.get("objCtr", empty_i)
    key_actor = arrs.get("keyActor", empty_i)
    key_ctr = arrs.get("keyCtr", empty_i)
    id_actor = arrs.get("idActor", empty_i)
    id_ctr = arrs.get("idCtr", empty_i)
    action = arrs.get("action", empty_i)
    val_len = arrs.get("valLen", empty_i)
    chld_actor = arrs.get("chldActor", empty_i)
    chld_ctr = arrs.get("chldCtr", empty_i)
    pred_num = arrs.get("predNum", empty_i)
    pred_actor = arrs.get("predActor", empty_i)
    pred_ctr = arrs.get("predCtr", empty_i)
    insert = arrs.get("insert", np.empty(0, bool))
    key_blob, key_offs = arrs.get("keyStr", (b"", np.empty((0, 2), np.int64)))
    val_raw = arrs.get("valRaw", b"")

    n_rows = max(
        obj_actor.size, obj_ctr.size, key_actor.size, key_ctr.size,
        id_actor.size, id_ctr.size, action.size, val_len.size,
        chld_actor.size, chld_ctr.size, pred_num.size, insert.size,
        key_offs.shape[0],
    )
    NULLS = NULL_SENTINEL

    def pad(arr, fill=NULLS):
        if arr.size >= n_rows:
            return arr
        out = np.full(n_rows, fill, arr.dtype)
        out[: arr.size] = arr
        return out

    obj_actor, obj_ctr = pad(obj_actor), pad(obj_ctr)
    key_actor, key_ctr = pad(key_actor), pad(key_ctr)
    action, val_len = pad(action), pad(val_len)
    chld_actor, chld_ctr = pad(chld_actor), pad(chld_ctr)
    pred_num = pad(pred_num)
    insert = (
        np.concatenate([insert, np.zeros(n_rows - insert.size, bool)])
        if insert.size < n_rows
        else insert
    )

    # valRaw slices: cumulative (valLen >> 4) with nulls contributing 0
    sizes = np.where(val_len == NULLS, 0, val_len >> 4)
    val_ends = np.cumsum(sizes)
    val_starts = val_ends - sizes
    if val_ends.size and val_ends[-1] > len(val_raw):
        return None

    num_actors = len(actor_ids)
    total_preds = int(np.sum(np.where(pred_num == NULLS, 0, pred_num)))
    if pred_actor.size < total_preds or pred_ctr.size < total_preds:
        return None

    # per-column masked value pass: every set/inc row's (valLen tag, valRaw
    # slice) pair decodes in bulk — varint payloads through one [rows, 8]
    # byte-matrix scan, doubles through one view cast — instead of a
    # Decoder object per row (decode_value). Rows the pass cannot prove
    # well-formed decode through decode_value itself, which raises the
    # canonical error.
    set_inc = (action == _ACTION_SET_IDX) | (action == _ACTION_INC_IDX)
    values = _decode_values_bulk(
        val_len, sizes, val_starts, val_raw, set_inc, NULLS
    )

    # pred column: the strings, actor-range check and ascending check all
    # run as one pass over the flat pred rows before any op materialises
    used_preds = pred_actor[:total_preds]
    used_pred_ctr = pred_ctr[:total_preds]
    if used_preds.size and int(used_preds.max()) >= num_actors:
        bad = int(used_preds[used_preds >= num_actors][0])
        raise DecodeError(f"No actor index {bad}")
    pred_strs = tuple(
        f"{c}@{actor_ids[a]}"
        for c, a in zip(used_pred_ctr.tolist(), used_preds.tolist())
    )
    pred_counts = np.where(pred_num == NULLS, 0, pred_num)
    pred_bounds = np.zeros(n_rows + 1, np.int64)
    np.cumsum(pred_counts, out=pred_bounds[1:])
    if total_preds:
        # ascending within each op's pred group, on (ctr, actorId string)
        row_of = np.repeat(np.arange(n_rows), pred_counts)
        same = row_of[1:] == row_of[:-1]
        for j in np.nonzero(same)[0]:
            a = (int(used_pred_ctr[j]), actor_ids[int(used_preds[j])])
            b = (int(used_pred_ctr[j + 1]), actor_ids[int(used_preds[j + 1])])
            if a >= b:
                raise DecodeError("operation IDs are not in ascending order")
    pred_bounds_l = pred_bounds.tolist()

    # plain-Python row materialisation: numpy scalar indexing costs more
    # than the record build itself at this row count, so columns convert
    # to lists once and the loop runs on ints
    obj_actor_l = obj_actor.tolist()
    obj_ctr_l = obj_ctr.tolist()
    key_actor_l = key_actor.tolist()
    key_ctr_l = key_ctr.tolist()
    action_l = action.tolist()
    chld_actor_l = chld_actor.tolist()
    chld_ctr_l = chld_ctr.tolist()
    insert_l = insert.tolist()
    key_offs_l = key_offs.tolist()
    num_actions = len(ACTIONS)

    ops = []
    key_n = len(key_offs_l)
    key_memo: dict = {}  # (start, end) -> decoded str: RLE keys repeat
    obj_memo: dict = {}
    for i in range(n_rows):
        oa, oc = obj_actor_l[i], obj_ctr_l[i]
        if oc == NULLS:
            obj = "_root"
        else:
            obj = obj_memo.get(oc * num_actors + oa if oa != NULLS else None)
            if obj is None:
                if oa == NULLS or oa >= num_actors:
                    raise DecodeError(f"No actor index {oa}")
                obj = f"{oc}@{actor_ids[oa]}"
                obj_memo[oc * num_actors + oa] = obj
        ks = None
        if i < key_n and key_offs_l[i][0] >= 0:
            span = (key_offs_l[i][0], key_offs_l[i][1])
            ks = key_memo.get(span)
            if ks is None:
                ks = key_blob[span[0]:span[1]].decode("utf-8", "surrogatepass")
                key_memo[span] = ks
        if ks is not None:
            elem_id = None
        elif key_ctr_l[i] != NULLS and key_ctr_l[i] == 0:
            elem_id = "_head"
        else:
            kc, ka = key_ctr_l[i], key_actor_l[i]
            if kc == NULLS or ka == NULLS:
                return None  # degenerate key row: defer to the generic path
            if ka >= num_actors:
                raise DecodeError(f"No actor index {ka}")
            elem_id = f"{kc}@{actor_ids[ka]}"
        act = action_l[i] if action_l[i] != NULLS else None
        act_name = ACTIONS[act] if act is not None and act < num_actions else act
        if elem_id is not None:
            op = [obj, elem_id, act_name, insert_l[i]]
            bits = _HAS_ELEM_ID
        else:
            op = [obj, ks, act_name, insert_l[i]]
            bits = 0
        if act_name in ("set", "inc"):
            value, datatype = values[i]
            op.append(value)
            bits |= _HAS_VALUE
            if datatype is not None:
                op.append(datatype)
                bits |= _HAS_DATATYPE
        cc, ca = chld_ctr_l[i], chld_actor_l[i]
        if (cc == NULLS) != (ca == NULLS):
            raise DecodeError(
                "Mismatched child columns: "
                f"{None if cc == NULLS else cc} and "
                f"{None if ca == NULLS else ca}"
            )
        if cc != NULLS:
            if ca >= num_actors:
                raise DecodeError(f"No actor index {ca}")
            op.append(f"{cc}@{actor_ids[ca]}")
            bits |= _HAS_CHILD
        op.append(pred_strs[pred_bounds_l[i]:pred_bounds_l[i + 1]])
        op.append(_OP_SHAPES[bits])
        ops.append(tuple(op))
    return tuple(ops)


_ACTION_SET_IDX = ACTIONS.index("set")
_ACTION_INC_IDX = ACTIONS.index("inc")

#: valLen type tags whose payload is a single LEB128 varint
_VARINT_TAG_DATATYPE = {
    ValueType.LEB128_UINT: "uint",
    ValueType.LEB128_INT: "int",
    ValueType.COUNTER: "counter",
    ValueType.TIMESTAMP: "timestamp",
}


def _decode_values_bulk(val_len, sizes, val_starts, val_raw, mask, NULLS):
    """Bulk decode_value over the (valLen, valRaw) columns: returns a list
    with ``(value, datatype)`` at every row where `mask` is set (None
    elsewhere). The varint-tagged rows decode through one masked byte-
    matrix pass; IEEE754 rows through one view cast; rows the vector pass
    cannot prove well-formed fall through to decode_value per row, which
    produces the canonical value or error."""
    n = val_len.shape[0]
    out = [None] * n
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return out
    tags = np.where(val_len == NULLS, 0, val_len)[idx]
    t = tags % 16
    starts = val_starts[idx]
    szs = sizes[idx]

    special = tags <= ValueType.TRUE  # NULL / FALSE / TRUE full tags
    for j in np.nonzero(special)[0]:
        out[idx[j]] = ((None, False, True)[tags[j]], None)

    is_varint = ~special & (
        (t == ValueType.LEB128_UINT) | (t == ValueType.LEB128_INT)
        | (t == ValueType.COUNTER) | (t == ValueType.TIMESTAMP)
    )
    hard = np.zeros(idx.shape[0], bool)
    raw_arr = np.frombuffer(val_raw, np.uint8)
    if is_varint.any() and raw_arr.size == 0:
        hard[is_varint] = True  # zero-size varint slices: canonical error
        is_varint[:] = False
    if is_varint.any():
        v = np.nonzero(is_varint)[0]
        cols = np.arange(8)
        pos = starts[v, None] + cols[None, :]
        in_slice = cols[None, :] < np.minimum(szs[v], 8)[:, None]
        b = np.where(
            in_slice, raw_arr[np.minimum(pos, raw_arr.size - 1)], 0
        ).astype(np.int64)
        is_end = ((b & 0x80) == 0) & in_slice
        has_end = is_end.any(axis=1)
        first_end = is_end.argmax(axis=1)
        keep = cols[None, :] <= first_end[:, None]
        payload = (b & 0x7F) * keep
        u = (payload << (7 * cols)[None, :]).sum(axis=1)
        lengths = first_end + 1
        last = b[np.arange(v.shape[0]), first_end]
        sgn = ((last & 0x40) != 0).astype(np.int64)
        s = u - (sgn << (7 * lengths))
        signed_tag = t[v] != ValueType.LEB128_UINT
        vals = np.where(signed_tag, s, u)
        in_range = np.where(
            signed_tag,
            (vals >= MIN_SAFE_INTEGER) & (vals <= MAX_SAFE_INTEGER),
            u <= MAX_SAFE_INTEGER,
        )
        ok = has_end & in_range
        hard[v[~ok]] = True
        vals_l = vals.tolist()
        for k, j in enumerate(v):
            if ok[k]:
                out[idx[j]] = (vals_l[k], _VARINT_TAG_DATATYPE[int(t[j])])

    is_f64 = ~special & (t == ValueType.IEEE754)
    if is_f64.any():
        v = np.nonzero(is_f64)[0]
        exact = szs[v] == 8
        hard[v[~exact]] = True  # canonical "Invalid length" via decode_value
        v = v[exact]
        if v.size:
            mat = raw_arr[starts[v, None] + np.arange(8)[None, :]]
            floats = mat.copy().view("<f8").ravel().tolist()
            for k, j in enumerate(v):
                out[idx[j]] = (floats[k], "float64")

    rest = ~special & ~is_varint & ~is_f64
    for j in np.nonzero(rest | hard)[0]:
        if out[idx[j]] is None or hard[j]:
            decoded = decode_value(
                int(tags[j]), val_raw[starts[j]:starts[j] + szs[j]]
            )
            out[idx[j]] = (decoded["value"], decoded.get("datatype"))
    return out


def _native_change_ops(cols, actor_ids):
    """Array-at-a-time change-op decoding through the native column codecs
    (native/codecs.cpp); returns None when the fast path does not apply
    (library missing, unknown columns present). ~20x faster than the
    per-op decoder chain for bulk applyChanges ingest: each column is
    decoded to a dense array in one native call and the op dicts are
    assembled by ops_from_column_arrays."""
    from . import native

    if not native.available():
        return None
    by_name = {}
    for cid, buf in cols:
        name = _CHANGE_COLUMN_IDS.get(cid)
        if name is None:
            return None  # unknown column: preserve via the generic path
        by_name[name] = bytes(buf)

    empty = b""

    def ints(name, kind, max_count=None):
        """Decodes an int column fully; returns int64 array (nulls =
        native.NULL_SENTINEL)."""
        buf = by_name.get(name, empty)
        if not buf:
            return np.empty(0, np.int64)
        cap = max_count
        for attempt in range(3):
            try:
                if kind == "delta":
                    return native.delta_decode(buf, max_count=cap)
                return native.rle_decode(buf, max_count=cap)
            except ValueError:
                if cap is None:
                    cap = max(1024, len(buf) * 64)
                cap *= 16
                if attempt == 2:
                    raise
        raise AssertionError

    try:
        arrs = {
            "objActor": ints("objActor", "rle"),
            "objCtr": ints("objCtr", "rle"),
            "keyActor": ints("keyActor", "rle"),
            "keyCtr": ints("keyCtr", "delta"),
            "idActor": ints("idActor", "rle"),
            "idCtr": ints("idCtr", "delta"),
            "action": ints("action", "rle"),
            "valLen": ints("valLen", "rle"),
            "chldActor": ints("chldActor", "rle"),
            "chldCtr": ints("chldCtr", "delta"),
            "predNum": ints("predNum", "rle"),
            "predActor": ints("predActor", "rle"),
            "predCtr": ints("predCtr", "delta"),
            "insert": (
                native.bool_decode(by_name["insert"])
                if by_name.get("insert")
                else np.empty(0, bool)
            ),
            "keyStr": (
                native.strrle_decode(by_name["keyStr"])
                if by_name.get("keyStr")
                else (b"", np.empty((0, 2), np.int64))
            ),
            "valRaw": by_name.get("valRaw", empty),
        }
    except ValueError:
        return None  # malformed for the fast path: let the generic path raise
    return ops_from_column_arrays(arrs, actor_ids)


# Vectorized decode backend (tpu/decode.py): registered by the device layer
# when it loads, so decode_change gains the masked-vector-pass fast path on
# hosts without the native library WITHOUT this host-only module importing
# tpu/ (amlint AM301). Signature matches _native_change_ops.
_VECTOR_DECODER = None


def set_vector_decoder(fn) -> None:
    """Registers `fn(cols, actor_ids) -> ops | None` as the vectorized
    change-op decode backend (see tpu/decode.py)."""
    global _VECTOR_DECODER
    _VECTOR_DECODER = fn


def decode_change(buffer):
    """Decodes one binary change into its object representation."""
    change = decode_change_columns(buffer)
    cols = [(c["columnId"], c["buffer"]) for c in change["columns"]]
    ops = _native_change_ops(cols, change["actorIds"])
    if ops is None and _VECTOR_DECODER is not None:
        ops = _VECTOR_DECODER(cols, change["actorIds"])
    if ops is None:
        ops = decode_ops(decode_columns(cols, change["actorIds"], CHANGE_COLUMNS), False)
    change["ops"] = ops
    del change["actorIds"]
    del change["columns"]
    return change


# ---------------------------------------------------------------------- #
# decoded-change records: the form the change LRU keeps. A record is a
# plain tuple whose items are atoms (str, int, float, bool, None, bytes) or
# plain tuples of the same. CPython's collector untracks such a tuple in a
# collection that finds every item untracked, one level of nesting a
# collection, so a record leaves the lists the collector walks within a
# few young collections of its making, and however many changes the LRU
# holds, a full collection does not walk them; dicts and lists stay
# tracked for life. A record holds its field values, then its shape: an
# int naming its field keys. A change record's fields are the header's,
# ``deps`` and ``ops`` as tuples; an op record's are the op's, ``pred`` as
# a tuple.

#: view source of the fields that are not atoms, by key
_FIELD_VIEWS = {
    "deps": "list(r[{i}])",
    "pred": "list(r[{i}])",
    "ops": "[views[op[-1]](op) for op in r[{i}]]",
}
_SHAPES: dict = {}       # field keys -> shape
_SHAPE_VIEWS: list = []  # shape -> the function building its view


def _shape(keys: tuple) -> int:
    """The shape of records with these field keys, made on first use with
    its view builder: a lambda whose body is a dict display with constant
    keys, CPython's fastest dict build (twice as fast as dict(zip()), and
    a view is built on every hit), compiled from the keys, which are
    decode_change's field names and never input data."""
    shape = _SHAPES.get(keys)
    if shape is None:
        items = ", ".join(
            f"{key!r}: " + _FIELD_VIEWS.get(key, "r[{i}]").format(i=i)
            for i, key in enumerate(keys)
        )
        _SHAPE_VIEWS.append(
            eval(f"lambda r: {{{items}}}", {"views": _SHAPE_VIEWS})
        )
        shape = _SHAPES[keys] = len(_SHAPE_VIEWS) - 1
    return shape


_HAS_ELEM_ID, _HAS_VALUE, _HAS_DATATYPE, _HAS_CHILD = 1, 2, 4, 8

#: op record shapes of the array decode, indexed by the _HAS_* bits
_OP_SHAPES = tuple(
    _shape(
        ("obj", "elemId" if bits & _HAS_ELEM_ID else "key", "action",
         "insert")
        + (("value",) if bits & _HAS_VALUE else ())
        + (("datatype",) if bits & _HAS_DATATYPE else ())
        + (("child",) if bits & _HAS_CHILD else ())
        + ("pred",)
    )
    for bits in range(16)
)

#: header fields that are no part of a decoded change (decode_change
#: drops them), and the one a record takes from elsewhere
_NOT_RECORDED = frozenset(("actorIds", "columns", "ops"))


def change_record(header, op_records: tuple) -> tuple:
    """The change LRU's record of a change: `header` is
    decode_change_columns' dict or decode_change's (its transport fields
    and ``ops`` are left out), `op_records` its ops as records."""
    keys = []
    values = []
    for key, value in header.items():
        if key not in _NOT_RECORDED:
            keys.append(key)
            values.append(tuple(value) if key == "deps" else value)
    keys.append("ops")
    values.append(op_records)
    values.append(_shape(tuple(keys)))
    return tuple(values)


def op_record(op: dict) -> tuple:
    """The record of one op dict of decode_change."""
    return (*(tuple(v) if k == "pred" else v for k, v in op.items()),
            _shape(tuple(op)))


def record_of_change(change: dict) -> tuple:
    """The record of decode_change's dict (a chunk the array paths left
    to the per-op decoder chain)."""
    return change_record(change, tuple(map(op_record, change["ops"])))


def record_view(record: tuple) -> dict:
    """The dict of a change or op record, as decode_change gives it, every
    container fresh."""
    return _SHAPE_VIEWS[record[-1]](record)


# ---------------------------------------------------------------------- #
# decode memoization: a change gossiped to N documents (the farm fans one
# delivery across a batch) or replayed across sync rounds (sync peers re-
# derive metadata for every candidate every round) is parsed ONCE. Keyed by
# the raw chunk bytes — the change hash is sha256 over those bytes, so the
# key identifies the change exactly. Both caches share one metric family:
# codecs.decode_cache.{hits,misses,evictions,bytes}. Entry counts bound the
# working set; AM_DECODE_CACHE_BYTES (default 64 MiB, split across both)
# bounds pinned host memory so a few huge chunks cannot exhaust it.

_DECODE_CACHE_BYTES = int(
    os.environ.get("AM_DECODE_CACHE_BYTES", str(64 << 20))
)
_DECODED_CHANGE_CACHE = DecodeCache(
    int(os.environ.get("AM_DECODE_CACHE_CHANGES", "8192")),
    max_bytes=_DECODE_CACHE_BYTES // 2,
)
_DECODED_META_CACHE = DecodeCache(
    int(os.environ.get("AM_DECODE_CACHE_METAS", "16384")),
    max_bytes=_DECODE_CACHE_BYTES // 2,
)


_M_VIEWS = get_metrics().counter(
    "codecs.decode_cache.views",
    "change dicts built from the change LRU's records (decode_change_cached)",
)


def decode_change_cached(buffer):
    """`decode_change` through the bounded decode LRU.

    Returns a fresh dict equal to ``decode_change(buffer)``, its ``ops``,
    op ``pred`` and ``deps`` fresh lists: the LRU keeps the change's record
    (``change_record``), and every call builds its view anew, so a caller
    may change what it gets."""
    key = bytes(buffer)
    record = _DECODED_CHANGE_CACHE.get(key)
    if record is None:
        change = decode_change(key)
        _DECODED_CHANGE_CACHE.put(key, record_of_change(change))
        return change
    _M_VIEWS.inc()
    return record_view(record)


def decode_change_meta_cached(buffer):
    """`decode_change_meta(buffer, compute_hash=True)` through the decode
    LRU. Returns a shallow copy; the shared ``deps``/``change`` values must
    be treated as immutable."""
    key = bytes(buffer)
    meta = _DECODED_META_CACHE.get(key)
    if meta is None:
        meta = decode_change_meta(key, True)
        _DECODED_META_CACHE.put(key, meta)
    return dict(meta)


def clear_decode_caches():
    """Empties both decode LRUs (testing hook; never required for
    correctness — entries are keyed by immutable bytes)."""
    _DECODED_CHANGE_CACHE.clear()
    _DECODED_META_CACHE.clear()


def decode_change_meta(buffer, compute_hash):
    """Decodes only the header fields of a binary change (columnar.js:783)."""
    buffer = bytes(buffer)
    if buffer[8] == CHUNK_TYPE_DEFLATE:
        buffer = inflate_change(buffer)
    header = decode_container_header(Decoder(buffer), compute_hash)
    if header["chunkType"] != CHUNK_TYPE_CHANGE:
        raise DecodeError("Buffer chunk type is not a change")
    meta = decode_change_header(Decoder(header["chunkData"]))
    meta["change"] = buffer
    if compute_hash:
        meta["hash"] = header["hash"]
    return meta


def deflate_change(buffer: bytes) -> bytes:
    header = decode_container_header(Decoder(buffer), False)
    if header["chunkType"] != CHUNK_TYPE_CHANGE:
        raise DecodeError(f"Unexpected chunk type: {header['chunkType']}")
    compressed = deflate_raw(header["chunkData"])
    out = Encoder()
    out.append_raw_bytes(buffer[:8])  # copy MAGIC_BYTES and checksum
    out.append_byte(CHUNK_TYPE_DEFLATE)
    out.append_uint53(len(compressed))
    out.append_raw_bytes(compressed)
    return out.buffer


def inflate_change(buffer: bytes) -> bytes:
    header = decode_container_header(Decoder(buffer), False)
    if header["chunkType"] != CHUNK_TYPE_DEFLATE:
        raise DecodeError(f"Unexpected chunk type: {header['chunkType']}")
    decompressed = inflate_raw(header["chunkData"])
    out = Encoder()
    out.append_raw_bytes(buffer[:8])
    out.append_byte(CHUNK_TYPE_CHANGE)
    out.append_uint53(len(decompressed))
    out.append_raw_bytes(decompressed)
    return out.buffer


def split_containers(buffer):
    """Splits concatenated binary chunks into a list of single-chunk buffers."""
    buffer = bytes(buffer)
    decoder = Decoder(buffer)
    chunks = []
    start = 0
    while not decoder.done:
        decode_container_header(decoder, False)
        chunks.append(buffer[start : decoder.offset])
        start = decoder.offset
    return chunks


def decode_changes(binary_changes):
    """Decodes a list of binary changes and/or documents into change objects."""
    decoded = []
    for binary_change in binary_changes:
        for chunk in split_containers(binary_change):
            if chunk[8] == CHUNK_TYPE_DOCUMENT:
                decoded.extend(decode_document(chunk))
            elif chunk[8] in (CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE):
                decoded.append(decode_change(chunk))
            # ignore chunks of unknown type
    return decoded


def _sort_op_ids_key(op_id):
    if op_id == "_root":
        return (-1, "")
    p = parse_op_id(op_id)
    return (p.counter, p.actor_id)


def group_change_ops(changes, ops):
    """Reconstructs per-change op lists from a document's flat op set
    (columnar.js:876). Mutates `changes`."""
    changes_by_actor = {}
    for change in changes:
        change["ops"] = []
        changes_by_actor.setdefault(change["actor"], [])
        if change["seq"] != len(changes_by_actor[change["actor"]]) + 1:
            raise DecodeError(
                f"Expected seq = {len(changes_by_actor[change['actor']]) + 1}, got {change['seq']}"
            )
        if change["seq"] > 1 and changes_by_actor[change["actor"]][change["seq"] - 2]["maxOp"] > change["maxOp"]:
            raise DecodeError("maxOp must increase monotonically per actor")
        changes_by_actor[change["actor"]].append(change)

    ops_by_id = {}
    for op in ops:
        if op["action"] == "del":
            raise DecodeError("document should not contain del operations")
        op["pred"] = ops_by_id[op["id"]]["pred"] if op["id"] in ops_by_id else []
        ops_by_id[op["id"]] = op
        for succ in op["succ"]:
            if succ not in ops_by_id:
                if op.get("elemId") is not None:
                    elem_id = op["id"] if op["insert"] else op["elemId"]
                    ops_by_id[succ] = {
                        "id": succ, "action": "del", "obj": op["obj"], "elemId": elem_id, "pred": []
                    }
                else:
                    ops_by_id[succ] = {
                        "id": succ, "action": "del", "obj": op["obj"], "key": op["key"], "pred": []
                    }
            ops_by_id[succ]["pred"].append(op["id"])
        del op["succ"]
    for op in ops_by_id.values():
        if op["action"] == "del":
            ops.append(op)

    for op in ops:
        p = parse_op_id(op["id"])
        actor_changes = changes_by_actor[p.actor_id]
        left, right = 0, len(actor_changes)
        while left < right:
            index = (left + right) // 2
            if actor_changes[index]["maxOp"] < p.counter:
                left = index + 1
            else:
                right = index
        if left >= len(actor_changes):
            raise DecodeError(f"Operation ID {op['id']} outside of allowed range")
        actor_changes[left]["ops"].append(op)

    for change in changes:
        change["ops"].sort(key=lambda op: _sort_op_ids_key(op["id"]))
        change["startOp"] = change["maxOp"] - len(change["ops"]) + 1
        del change["maxOp"]
        for i, op in enumerate(change["ops"]):
            expected_id = f"{change['startOp'] + i}@{change['actor']}"
            if op["id"] != expected_id:
                raise DecodeError(f"Expected opId {expected_id}, got {op['id']}")
            del op["id"]


def decode_document_changes(changes, expected_heads):
    """Finalises changes decoded from a document: resolves dep indexes into
    hashes, re-encodes each change to compute its hash (columnar.js:945)."""
    heads = {}
    for i, change in enumerate(changes):
        change["deps"] = []
        for dep in change["depsNum"]:
            index = dep["depsIndex"]
            if index >= len(changes) or "hash" not in changes[index]:
                raise DecodeError(f"No hash for index {index} while processing index {i}")
            h = changes[index]["hash"]
            change["deps"].append(h)
            heads.pop(h, None)
        change["deps"].sort()
        del change["depsNum"]

        if change.get("extraLen_datatype") != ValueType.BYTES:
            raise DecodeError(f"Bad datatype for extra bytes: {ValueType.BYTES}")
        change["extraBytes"] = change["extraLen"]
        change.pop("extraLen_datatype", None)
        change.pop("extraLen", None)
        change.pop("extraRaw", None)

        changes[i] = decode_change(encode_change(change))
        heads[changes[i]["hash"]] = True

    actual_heads = sorted(heads.keys())
    if actual_heads != sorted(expected_heads):
        raise ChecksumError(
            f"Mismatched heads hashes: expected {', '.join(expected_heads)}, "
            f"got {', '.join(actual_heads)}"
        )


def encode_document_header(doc) -> bytes:
    """Encodes a document chunk. `doc` is a dict with keys changesColumns,
    opsColumns (lists of (column_id, buffer)), actorIds, heads, headsIndexes,
    extraBytes (columnar.js:983)."""
    changes_columns = [list(c) for c in doc["changesColumns"]]
    ops_columns = [list(c) for c in doc["opsColumns"]]
    for col in changes_columns:
        _deflate_column(col)
    for col in ops_columns:
        _deflate_column(col)

    body = Encoder()
    body.append_uint53(len(doc["actorIds"]))
    for actor in doc["actorIds"]:
        body.append_hex_string(actor)
    heads = sorted(doc["heads"])
    body.append_uint53(len(heads))
    for head in heads:
        body.append_raw_bytes(hex_to_bytes(head))
    encode_column_info(body, [(c[0], c[1]) for c in changes_columns])
    encode_column_info(body, [(c[0], c[1]) for c in ops_columns])
    for _cid, buf in changes_columns:
        body.append_raw_bytes(buf)
    for _cid, buf in ops_columns:
        body.append_raw_bytes(buf)
    for index in doc.get("headsIndexes", []):
        body.append_uint53(index)
    if doc.get("extraBytes"):
        body.append_raw_bytes(doc["extraBytes"])
    _hash, data = encode_container(CHUNK_TYPE_DOCUMENT, body.buffer)
    return data


def decode_document_header(buffer):
    doc_decoder = Decoder(bytes(buffer))
    header = decode_container_header(doc_decoder, True)
    decoder = Decoder(header["chunkData"])
    if not doc_decoder.done:
        raise DecodeError("Encoded document has trailing data")
    if header["chunkType"] != CHUNK_TYPE_DOCUMENT:
        raise DecodeError(f"Unexpected chunk type: {header['chunkType']}")

    actor_ids = [decoder.read_hex_string() for _ in range(decoder.read_uint53())]
    num_heads = decoder.read_uint53()
    heads = [bytes_to_hex(decoder.read_raw_bytes(32)) for _ in range(num_heads)]
    heads_indexes = []

    changes_columns = decode_column_info(decoder)
    ops_columns = decode_column_info(decoder)
    for col in changes_columns:
        col["buffer"] = decoder.read_raw_bytes(col["bufferLen"])
        _inflate_column(col)
    for col in ops_columns:
        col["buffer"] = decoder.read_raw_bytes(col["bufferLen"])
        _inflate_column(col)
    if not decoder.done:
        for _ in range(num_heads):
            heads_indexes.append(decoder.read_uint53())

    extra_bytes = decoder.read_raw_bytes(len(decoder.buf) - decoder.offset)
    return {
        "changesColumns": [(c["columnId"], c["buffer"]) for c in changes_columns],
        "opsColumns": [(c["columnId"], c["buffer"]) for c in ops_columns],
        "actorIds": actor_ids,
        "heads": heads,
        "headsIndexes": heads_indexes,
        "extraBytes": extra_bytes,
    }


def decode_document(buffer):
    """Decodes a document chunk into the list of changes it contains."""
    doc = decode_document_header(buffer)
    changes = decode_columns(doc["changesColumns"], doc["actorIds"], DOCUMENT_COLUMNS)
    ops = decode_ops(decode_columns(doc["opsColumns"], doc["actorIds"], DOC_OPS_COLUMNS), True)
    group_change_ops(changes, ops)
    decode_document_changes(changes, doc["heads"])
    return changes


def _deflate_column(column):
    if len(column[1]) >= DEFLATE_MIN_SIZE:
        column[1] = deflate_raw(column[1])
        column[0] |= COLUMN_TYPE_DEFLATE


def _inflate_column(column):
    if column["columnId"] & COLUMN_TYPE_DEFLATE:
        column["buffer"] = inflate_raw(column["buffer"])
        column["columnId"] ^= COLUMN_TYPE_DEFLATE

"""A frozen encoder of Automerge's binary change format for the change
shapes the traffic makes: root-map changes of string keys (``set`` of
strings, ``set`` of a new counter, ``inc`` of a counter).

It writes the bytes that ``backend/columnar.js`` (``encodeChange``) writes
for such changes, without calling the system under test: the generator
must cost little and no later change to the program may move it. The
column encodings follow ``backend/encoding.js``: RLE runs (a repeated
value as ``count, value``; consecutive distinct values as one literal
``-n, v1..vn``; nulls as ``0, count``; a column of nulls only is empty),
deltas as RLE over successive differences, booleans as alternating run
lengths starting with false. Changes of 256 bytes or more are deflated
(raw DEFLATE, level 6), keeping the checksum of the uncompressed chunk.
"""
from __future__ import annotations

import functools
import hashlib
import itertools
import zlib

MAGIC = bytes([0x85, 0x6F, 0x4A, 0x83])
CHUNK_CHANGE, CHUNK_DEFLATE = 1, 2
DEFLATE_MIN_SIZE = 256

# column ids (columnId << 4 | column type), ascending
KEY_STR, INSERT, ACTION, VAL_LEN, VAL_RAW = 0x15, 0x34, 0x42, 0x56, 0x57
PRED_NUM, PRED_ACTOR, PRED_CTR = 0x70, 0x71, 0x73

ACTION_SET, ACTION_INC = 1, 5
TAG_INT, TAG_UTF8, TAG_COUNTER = 4, 6, 8


def _uleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _sleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if (v == 0 and not b & 0x40) or (v == -1 and b & 0x40):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


_SMALL = 1 << 14
_ULEB = [_uleb(v) for v in range(_SMALL)]
_SLEB = [_sleb(v) for v in range(-_SMALL, _SMALL)]


def uleb(v: int) -> bytes:
    """Unsigned LEB128."""
    return _ULEB[v] if v < _SMALL else _uleb(v)


def sleb(v: int) -> bytes:
    """Signed LEB128."""
    return _SLEB[v + _SMALL] if -_SMALL <= v < _SMALL else _sleb(v)


def utf8(v: str) -> bytes:
    """A length-prefixed UTF-8 string (an RLE column's string value)."""
    data = v.encode("utf-8")
    return uleb(len(data)) + data


def rle(values, raw=uleb) -> bytes:
    """RLE column of `values` (no nulls), each value written by `raw`
    (`uleb` for a uint column, `sleb` for an int column, `utf8`)."""
    out = []
    literal = []
    for v, group in itertools.groupby(values):
        n = len(list(group))
        if n == 1:
            literal.append(v)
            continue
        if literal:
            out.append(sleb(-len(literal)))
            out.extend(map(raw, literal))
            literal = []
        out.append(sleb(n))
        out.append(raw(v))
    if literal:
        out.append(sleb(-len(literal)))
        out.extend(map(raw, literal))
    return b"".join(out)


def delta(values) -> bytes:
    """Delta column: an int RLE of the differences from the previous
    value (from 0)."""
    diffs, last = [], 0
    for v in values:
        diffs.append(v - last)
        last = v
    return rle(diffs, sleb)


def boolean_false(n: int) -> bytes:
    """A boolean column of `n` false values."""
    return uleb(n) if n else b""


def container(body: bytes) -> tuple[str, bytes]:
    """Wraps a change body: magic, checksum, chunk type, length. Returns
    (hash hex, change bytes), deflated when 256 bytes or more."""
    header = bytes([CHUNK_CHANGE]) + uleb(len(body))
    digest = hashlib.sha256(header + body).digest()
    data = MAGIC + digest[:4] + header + body
    if len(data) >= DEFLATE_MIN_SIZE:
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        packed = comp.compress(body) + comp.flush()
        data = MAGIC + digest[:4] + bytes([CHUNK_DEFLATE]) + uleb(
            len(packed)) + packed
    return digest.hex(), data


def change_head(actor: bytes, seq: int, start_op: int, deps: list[bytes],
                others: list[bytes]) -> bytes:
    """The change header: sorted deps, author, seq, startOp, time 0, an
    empty message, the other actors the ops name."""
    parts = [uleb(len(deps))]
    parts.extend(sorted(deps))
    parts.append(uleb(len(actor)) + actor)
    parts.append(uleb(seq) + uleb(start_op) + b"\x00\x00")
    parts.append(uleb(len(others)))
    for a in others:
        parts.append(uleb(len(a)) + a)
    return b"".join(parts)


def columns_blob(columns) -> bytes:
    """Column info and buffers of `columns` [(id, bytes)] in ascending id
    order; empty columns are left out."""
    cols = [(cid, buf) for cid, buf in columns if buf]
    info = [uleb(len(cols))]
    for cid, buf in cols:
        info.append(uleb(cid) + uleb(len(buf)))
    return b"".join(info) + b"".join(buf for _, buf in cols)


def set_ops_blob(keys, values, preds) -> bytes:
    """Columns of a change of ``set`` ops on the root map, one per key:
    op j sets ``keys[j]`` (the key's length-prefixed UTF-8, as `utf8`
    makes it) to the string whose UTF-8 bytes are ``values[j]``, over the
    preds ``preds[j]``: [(counter, index in the change's actor table)],
    in ascending (counter, actor id) order."""
    n = len(keys)
    flat = [p for ps in preds for p in ps]
    return columns_blob([
        (KEY_STR, rle(keys, bytes)),
        (INSERT, boolean_false(n)),
        (ACTION, _rle_cached((ACTION_SET,) * n)),
        (VAL_LEN, rle([len(v) << 4 | TAG_UTF8 for v in values])),
        (VAL_RAW, b"".join(values)),
        (PRED_NUM, rle([len(ps) for ps in preds])),
        (PRED_ACTOR, rle([a for _, a in flat])),
        (PRED_CTR, delta([c for c, _ in flat])),
    ])


@functools.lru_cache(maxsize=1 << 16)
def _rle_cached(values: tuple) -> bytes:
    return rle(values)


def counter_set_blob(key: str) -> bytes:
    """Columns of a change that sets root `key` to a new counter at 0."""
    return columns_blob([
        (KEY_STR, rle([key], utf8)),
        (INSERT, boolean_false(1)),
        (ACTION, rle([ACTION_SET])),
        (VAL_LEN, rle([1 << 4 | TAG_COUNTER])),
        (VAL_RAW, b"\x00"),
        (PRED_NUM, rle([0])),
    ])


def counter_incs_blob(key: str, n: int, pred_actor: int,
                      pred_ctr: int) -> bytes:
    """Columns of a change of `n` ``inc`` ops of 1 on root `key`, each
    with the one pred ``pred_ctr``@(actor index `pred_actor`)."""
    return columns_blob([
        (KEY_STR, rle([key] * n, utf8)),
        (INSERT, boolean_false(n)),
        (ACTION, rle([ACTION_INC] * n)),
        (VAL_LEN, rle([1 << 4 | TAG_INT] * n)),
        (VAL_RAW, b"\x01" * n),
        (PRED_NUM, rle([1] * n)),
        (PRED_ACTOR, rle([pred_actor] * n)),
        (PRED_CTR, delta([pred_ctr] * n)),
    ])

"""Shared helpers for the automerge_tpu framework.

Mirrors the semantics of the reference implementation's shared utilities
(the reference implementation's src/common.js) with Python idioms.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations

import re
from functools import lru_cache

_OPID_RE = re.compile(r"^(\d+)@(.*)$")


class OpId:
    """A parsed operation ID (Lamport timestamp): counter@actorId.

    Reference: the reference implementation's src/common.js:22 (parseOpId).
    """

    __slots__ = ("counter", "actor_id")

    def __init__(self, counter: int, actor_id: str):
        self.counter = counter
        self.actor_id = actor_id

    def __repr__(self):
        return f"OpId({self.counter}@{self.actor_id})"

    def __eq__(self, other):
        return (
            isinstance(other, OpId)
            and self.counter == other.counter
            and self.actor_id == other.actor_id
        )

    def __hash__(self):
        return hash((self.counter, self.actor_id))

    def __str__(self):
        return f"{self.counter}@{self.actor_id}"


def parse_op_id(op_id: str) -> OpId:
    m = _OPID_RE.match(op_id)
    if not m:
        raise ValueError(f"Not a valid opId: {op_id}")
    return OpId(int(m.group(1)), m.group(2))


def op_id_sort_key(op_id: str):
    """Sort key for string opIds in Lamport order (counter, then actorId).

    '_root' sorts before everything (reference columnar.js:859 sortOpIds).
    """
    if op_id == "_root":
        return (-1, "")
    p = parse_op_id(op_id)
    return (p.counter, p.actor_id)


def lamport_compare_key(ts: str):
    """Sort key matching the frontend's lamportCompare
    (the reference implementation's frontend/apply_patch.js:33): strings that are not
    opIds are treated as {counter: 0, actorId: ts}.
    """
    m = _OPID_RE.match(ts)
    if m:
        return (int(m.group(1)), m.group(2))
    return (0, ts)


@lru_cache(maxsize=8192)
def utf16_key(s: str) -> bytes:
    """Sort key giving JavaScript's UTF-16 code-unit string ordering.

    The reference engine compares map keys with JS `<` (UTF-16 code units,
    see the reference implementation's backend/new.js:1156); comparing the UTF-16-BE
    encoding byte-wise is equivalent. Cached: the farm's run-segmentation
    pass compares the same few map keys once per op (pure function of the
    string, so a bounded LRU is always safe).
    """
    return s.encode("utf-16-be", "surrogatepass")


def check_actor_id(actor_id) -> None:
    """Validate an actor ID (lowercase hex, even length).

    Reference: the reference implementation's frontend/index.js:17.
    """
    if not isinstance(actor_id, str):
        raise TypeError(f"Unsupported type of actorId: {type(actor_id)}")
    if not re.fullmatch(r"[0-9a-f]+", actor_id):
        raise ValueError("actorId must consist only of lowercase hex digits")
    if len(actor_id) % 2 != 0:
        raise ValueError("actorId must consist of an even number of digits")

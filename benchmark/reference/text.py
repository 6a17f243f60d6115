"""The reference's reading of ``schemas/text.py``'s op records: plain
Automerge.Text semantics, in plain Python.

A document holds its text object's elements in document order,
tombstones included, each an op id (counter, actor hex), which Python's
tuple order compares as backend/new.js compares op ids (counter first,
then actor). An insert goes after the element it names (the start for
``_head``), past every element of greater id: backend/new.js:144-163. A
delete makes its element a tombstone, for good: nothing in the traffic
sets an element again. The clock, heads and maxOp are the change
records'. A client copy is the visible (elemId, value) sequence after the
list edits of the patches a client applies in order (`apply_edits`)."""
from __future__ import annotations


def opid(op) -> str:
    return f"{op[0]}@{op[1]}"


class TextDoc:
    """One document's state. `ascending` is the control's broken
    guarantee: an element's children stand in ascending id order (an
    insert goes past the subtree of every child of its reference element
    with a smaller id), against new.js's descending order."""

    __slots__ = ("obj", "elems", "values", "deleted", "clock", "heads",
                 "max_op", "ascending", "_hint", "_depth")

    def __init__(self, ascending: bool = False):
        self.obj = None            # (counter, actor) of the text object
        self.elems: list = []      # document order, tombstones included
        self.values: dict = {}     # element -> character
        self.deleted: set = set()
        self.clock: dict = {}
        self.heads: set = set()
        self.max_op = 0
        self.ascending = ascending
        self._hint = (None, -1)    # the last element inserted, its index
        self._depth: dict = {}     # the control's: element -> tree depth

    def _index(self, elem) -> int:
        last, at = self._hint
        if elem == last:
            return at
        return self.elems.index(elem)

    def insert(self, op, ref) -> None:
        elems = self.elems
        i = 0 if ref is None else self._index(ref) + 1
        if self.ascending:
            depth = self._depth
            child = 1 if ref is None else depth[ref] + 1
            while i < len(elems):
                d = depth[elems[i]]
                if d < child or (d == child and elems[i] > op):
                    break
                i += 1
            depth[op] = child
        else:
            while i < len(elems) and elems[i] > op:
                i += 1
        elems.insert(i, op)
        self._hint = (op, i)

    def sequence(self) -> list:
        """The visible text: [(elemId, value)] in document order."""
        return [(opid(e), self.values[e]) for e in self.elems
                if e not in self.deleted]

    def text_id(self):
        return None if self.obj is None else opid(self.obj)


def commit(doc: TextDoc, ch, i) -> None:
    """Commits change `i` of the records `ch` to `doc`."""
    actor, start = ch.actor[i], ch.start_op[i]
    doc.clock[actor] = max(doc.clock.get(actor, 0), ch.seq[i])
    doc.heads.difference_update(ch.deps[i])
    doc.heads.add(ch.hash[i])
    doc.max_op = max(doc.max_op, start + ch.nops[i] - 1)
    chars = iter(ch.chars[i])
    for j, (kind, ref) in enumerate(zip(ch.kinds[i], ch.refs[i])):
        op = (start + j, actor)
        if kind == "m":
            doc.obj = op
        elif kind == "i":
            doc.insert(op, ref)
            doc.values[op] = next(chars)
        else:
            doc.deleted.add(ref)


def apply_edits(copy: list, edits) -> None:
    """Applies a patch's list edits (``insert``, ``multi-insert``,
    ``update``, ``remove``) to a client's copy, [(elemId, value)], as a
    client applies them (backend/new.js's edit forms)."""
    for e in edits:
        action, index = e["action"], e["index"]
        if not 0 <= index <= len(copy) - (action in ("update", "remove")):
            raise IndexError(f"{action} at {index} of {len(copy)} elements")
        if action == "remove" and index + e["count"] > len(copy):
            raise IndexError(f"remove of {e['count']} at {index} of "
                             f"{len(copy)} elements")
        if action == "insert":
            copy.insert(index, (e["elemId"], e["value"].get("value")))
        elif action == "multi-insert":
            ctr, _, actor = e["elemId"].partition("@")
            copy[index:index] = [(f"{int(ctr) + k}@{actor}", v)
                                 for k, v in enumerate(e["values"])]
        elif action == "update":
            copy[index] = (copy[index][0], e["value"].get("value"))
        elif action == "remove":
            del copy[index:index + e["count"]]
        else:
            raise ValueError(f"unknown list edit {action!r}")

"""The plain reference of the benchmark: documents worked out again from
the generator's op records, in plain Python. It imports nothing of the
system under test and of its JAX original. Each schema has a module of
its own here (``reference/<schema>.py``) that reads its op records into
the operations of `RootMap`: ``commit(doc, ch, i)``, and ``ops(ch, i)``,
the root key and the id of each op of change ``i``.

Semantics (Automerge's root map with conflicts, backend/new.js): an op is
``(counter, actor)``; a ``set`` overwrites exactly the ops it names as
pred, and every set op that no op names stays visible, so concurrent sets
of one key are all visible (a conflict); an ``inc`` adds its value to the
counter it names and overwrites nothing. A document's clock maps each
actor to its highest committed seq, its heads are the committed changes
no committed change depends on, and its maxOp is the highest op counter
committed. The visible state does not depend on the order in which a
causally closed set of changes commits, which is what lets a sync
deliver changes in any causal order."""
from __future__ import annotations


def opid(ctr: int, actor: str) -> str:
    return f"{ctr}@{actor}"


class RootMap:
    """One document's state under the reference semantics."""

    __slots__ = ("props", "clock", "heads", "max_op", "lww")

    def __init__(self, lww: bool = False):
        # key -> {(ctr, actor): [value, datatype or None]}
        self.props: dict[str, dict] = {}
        self.clock: dict[str, int] = {}
        self.heads: set[str] = set()
        self.max_op = 0
        # the control's broken guarantee: a set keeps only the value that
        # arrived last (conflicts dropped), an inc replaces its counter's
        # value instead of adding to it (and is lost with a replaced one)
        self.lww = lww

    def header(self, ch, i) -> None:
        """Commits the clock, heads and maxOp of change `i` of the
        records `ch`."""
        actor = ch.actor[i]
        self.clock[actor] = max(self.clock.get(actor, 0), ch.seq[i])
        self.heads.difference_update(ch.deps[i])
        self.heads.add(ch.hash[i])
        self.max_op = max(self.max_op, ch.start_op[i] + ch.nops[i] - 1)

    def set(self, key, op, value, datatype, preds) -> None:
        cell = self.props.setdefault(key, {})
        if self.lww:
            cell.clear()
        for pred in preds:
            cell.pop(pred, None)
        cell[op] = [value, datatype]

    def inc(self, key, target, by) -> None:
        if self.lww:
            entry = self.props.get(key, {}).get(target)
            if entry is not None:  # a counter another set replaced
                entry[0] = by
            return
        self.props[key][target][0] += by

    def diff(self, key, op):
        """The patch entry of visible op `op` ((ctr, actor)) of `key`, or
        None when the op is not visible."""
        entry = self.props.get(key, {}).get(op)
        if entry is None:
            return None
        value, datatype = entry
        if datatype is None:
            return {"type": "value", "value": value}
        return {"type": "value", "value": value, "datatype": datatype}

    def visible(self, key) -> dict:
        """Every visible value of `key`: {opId: patch entry}."""
        return {opid(*op): self.diff(key, op)
                for op in self.props.get(key, {})}

    def whole(self) -> dict:
        """Every visible value: {key: {opId: patch entry}}."""
        return {key: self.visible(key) for key, cell in self.props.items()
                if cell}

"""The reference's reading of ``schemas/dense.py``'s op rows, in plain
NumPy: every document's op table and visible state worked out again from
all the rows handed to it, in the dense engine's layout (rows sorted by
key, then op id, the rows of one op in the order handed; the unused rows
after them).

Semantics (backend/new.js's root map): an op's preds are the preds of all
its rows (a set names one, each marker row of the op one more); an op is
overwritten when a set or delete of its document names it as pred; a set
that is not overwritten is visible, so concurrent sets of one key stay
visible side by side; the winner of a key is its visible set of greatest
id. The rows of this schema are sets and their markers (an increment is
refused).

With ``lww`` the control's broken guarantee: the op that arrives last on a
key overwrites every earlier op of it, so a conflict keeps one value."""
from __future__ import annotations

import numpy as np

PAD_KEY = 2**31 - 1
ACTION_SET, ACTION_DEL = 0, 2
#: bits of an op id in a row's sort key (a counter below 2**20), and of
#: the actor in an op id
OP_BITS = 40
ACTOR_BITS = 20
ACTOR_MASK = (1 << ACTOR_BITS) - 1
#: op ids shift left by this much beside a document index
DOC_SHIFT = 44

STATE = ("key", "op", "action", "value", "pred", "overwritten", "num_ops")
VISIBLE = ("vis.key", "vis.op", "visible", "winner", "value_total")


def merge(key, op, action, value, pred, capacity, lww=False):
    """Every document's state from all its rows (five [docs, n] arrays,
    in the order handed; padding rows have the key ``PAD_KEY``), as a dict
    of the engine's 7 state columns and 5 visibility columns (`STATE`,
    `VISIBLE`), each [docs, capacity] but ``num_ops`` [docs]."""
    docs, n = key.shape
    real = key != PAD_KEY
    if ((action != ACTION_SET) & (action != ACTION_DEL) & real).any():
        raise ValueError("the dense reference reads sets and markers only")
    # a row's sort key: (key, op id, the order handed), one int64
    idx_bits = max(n - 1, 1).bit_length()
    key_bits = 63 - OP_BITS - idx_bits
    if real.any() and (key[real].max() >= (1 << key_bits) - 1
                       or op[real].max() >= 1 << OP_BITS):
        raise ValueError("a key or an op id overflows the reference's "
                         "sort key")
    sort_key = np.where(real, key.astype(np.int64), (1 << key_bits) - 1)
    sort_key = (((sort_key << OP_BITS) | np.where(real, op, 0)) << idx_bits
                | np.arange(n))
    order = np.sort(sort_key, axis=1) & ((1 << idx_bits) - 1)
    key, op, action, value, pred, real = (
        np.take_along_axis(c, order, axis=1)
        for c in (key, op, action, value, pred, real))
    num_ops = real.sum(axis=1)
    if num_ops.max(initial=0) > capacity:
        raise ValueError(f"{num_ops.max()} rows a document overflow "
                         f"{capacity}")
    if lww:
        # every op of a key but its last (greatest) is overwritten: a
        # row's op against the op of its key's last row
        end = np.ones((docs, n), bool)
        end[:, :-1] = key[:, :-1] != key[:, 1:]
        last = np.where(end, np.arange(n), n)
        last = np.minimum.accumulate(last[:, ::-1], axis=1)[:, ::-1]
        over = (op != np.take_along_axis(op, last, axis=1)) & real
    else:
        # a table of each document's op ids, (counter, actor), marked
        # where a row names the op as pred
        ids = op[real]
        actors = int((ids & ACTOR_MASK).max(initial=0)) + 1
        counters = int((ids >> ACTOR_BITS).max(initial=0)) + 1

        def slot(ids):
            return (np.arange(docs)[:, None] * (counters * actors)
                    + (ids >> ACTOR_BITS) * actors + (ids & ACTOR_MASK))

        named = real & (pred >= 0)
        if (pred[named] >> ACTOR_BITS >= counters).any() or (
                pred[named] & ACTOR_MASK >= actors).any():
            raise ValueError("a pred names no op of the rows handed")
        table = np.zeros(docs * counters * actors, bool)
        table[slot(pred)[named]] = True
        over = table[np.where(real, slot(op), 0)] & real
    doc = np.arange(docs, dtype=np.int64)[:, None] << DOC_SHIFT
    visible = real & (action == ACTION_SET) & ~over
    # the winner of a key: its last visible row (rows sorted by op id)
    flat = np.flatnonzero(visible)
    group = ((doc | key.astype(np.int64)).reshape(-1))[flat]
    last = np.ones(flat.size, bool)
    last[:-1] = group[1:] != group[:-1]
    winner = np.zeros(docs * n, bool)
    winner[flat[last]] = True
    winner = winner.reshape(docs, n)

    def fit(c, fill):
        """`c` with its padding rows set to `fill`, cut or padded to the
        capacity."""
        c = np.where(real, c, np.asarray(fill, c.dtype))
        if n >= capacity:
            return np.ascontiguousarray(c[:, :capacity])
        out = np.full((docs, capacity), fill, c.dtype)
        out[:, :n] = c
        return out

    state = [fit(key, PAD_KEY), fit(op, 0), fit(action, ACTION_SET),
             fit(value, 0), fit(pred, -1), fit(over, False),
             num_ops.astype(np.int32)]
    vis = [state[0], state[1], fit(visible, False), fit(winner, False),
           fit(np.where(visible, value, 0), 0)]
    return dict(zip(STATE + VISIBLE, state + vis))

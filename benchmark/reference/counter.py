"""The reference's reading of ``schemas/counter.py``'s op records: a
change of one op at counter 1 makes the root counter; every other change
is ``nops`` incs of 1 of the counter its creator made."""
from __future__ import annotations


def ops(ch, i) -> list:
    """[(key, (counter, actor))] of the ops of change `i`."""
    actor, start = ch.actor[i], ch.start_op[i]
    return [(ch.counter_key, (start + j, actor)) for j in range(ch.nops[i])]


def commit(doc, ch, i) -> None:
    """Commits change `i` of the records `ch` to `doc` (a RootMap)."""
    doc.header(ch, i)
    key = ch.counter_key
    if ch.nops[i] == 1 and ch.start_op[i] == 1:
        doc.set(key, (1, ch.actor[i]), 0, "counter", ())
    elif doc.lww:
        doc.inc(key, (1, ch.creator[i]), 1)
    else:
        doc.inc(key, (1, ch.creator[i]), ch.nops[i])

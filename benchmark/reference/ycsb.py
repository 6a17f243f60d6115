"""The reference's reading of ``schemas/ycsb.py``'s op records: each op
sets root key ``field<k>`` to a string over the preds it names."""
from __future__ import annotations


def ops(ch, i) -> list:
    """[(key, (counter, actor))] of the ops of change `i`."""
    actor, start = ch.actor[i], ch.start_op[i]
    return [(f"field{k}", (start + j, actor))
            for j, k in enumerate(ch.keys[i])]


def commit(doc, ch, i) -> None:
    """Commits change `i` of the records `ch` to `doc` (a RootMap)."""
    doc.header(ch, i)
    actor, start = ch.actor[i], ch.start_op[i]
    for j, (k, value, preds) in enumerate(zip(ch.keys[i], ch.values[i],
                                              ch.preds[i])):
        doc.set(f"field{k}", (start + j, actor), value, None,
                [tuple(p) for p in preds])

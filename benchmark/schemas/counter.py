"""Counter documents (a configuration's ``schema`` "counter", BASELINE
configs[2]): per document, its creator (actor 0) makes the root counter
``key``; then ``changes_per_actor`` rounds, each every actor's next change
of ``incs_per_change`` incs of 1, in an order drawn from the seed. Every
document has ``actors`` actors of its own. Steps take the traffic's
``docs_per_step`` documents at a time through all their rounds, one
delivery a step."""
from __future__ import annotations

import numpy as np

from harness import encoder as E
from harness import traffic
from harness.traffic import Changes, Stream, actor_id, run_jobs

#: op records of a change: the actor whose op made the counter
OP_FIELDS = ("creator",)


def make_stream(cfg: dict, mix: dict, seed: int) -> Stream:
    rng = np.random.default_rng(seed)
    docs, nact = cfg["docs"], cfg["actors"]
    rounds, group = cfg["changes_per_actor"], mix["docs_per_step"]
    if docs % group:
        raise ValueError("docs must be a multiple of docs_per_step")
    order = np.argsort(rng.random((docs, rounds, nact)), axis=-1)
    per_doc = 1 + rounds * nact
    nworkers = traffic.workers(docs * per_doc)
    jobs = [(seed, list(range(d0, docs, nworkers)), nact, rounds,
             cfg["incs_per_change"], cfg["key"])
            for d0 in range(nworkers)]
    rows = [None] * (docs * per_doc)
    for part in run_jobs(encode_group, jobs):
        for d, doc_rows in part:
            rows[d * per_doc:(d + 1) * per_doc] = doc_rows
    ch = Changes("counter", OP_FIELDS)
    ch.fill(rows)
    ch.counter_key = cfg["key"]
    steps = []
    for g in range(0, docs, group):
        for r in range(rounds + 1):
            delivery = []
            for d in range(g, g + group):
                base = d * per_doc
                if r == 0:
                    delivery.append(base)
                else:
                    delivery.extend(base + 1 + (r - 1) * nact + int(a)
                                    for a in order[d, r - 1])
            steps.append([(0, delivery)])
    return Stream(steps, ch, docs, 1)


def encode_group(job):
    """Encodes every change of a group of counter documents: per document
    [(doc, actor, seq, startOp, nops, deps, hash, bytes, creator)], the
    creator's change first, then round by round in actor order."""
    seed, docs, nact, rounds, nincs, key = job
    create_blob = E.counter_set_blob(key)
    incs_other = E.counter_incs_blob(key, nincs, 1, 1)
    incs_self = E.counter_incs_blob(key, nincs, 0, 1)
    out = []
    for d in docs:
        ids = [actor_id(seed, d, a, 8) for a in range(nact)]
        hexes = [a.hex() for a in ids]
        creator = ids[0]
        hx, data = E.container(E.change_head(creator, 1, 1, [], [])
                               + create_blob)
        rows = [(d, hexes[0], 1, 1, 1, [], hx, data, hexes[0])]
        last = [hx] * nact
        for r in range(rounds):
            start = 2 + r * nincs
            for a in range(nact):
                s = r + 1 + (a == 0)
                dep = bytes.fromhex(last[a])
                if a == 0:
                    body = E.change_head(creator, s, start, [dep], []) \
                        + incs_self
                else:
                    body = E.change_head(ids[a], s, start, [dep],
                                         [creator]) + incs_other
                hx, data = E.container(body)
                rows.append((d, hexes[a], s, start, nincs, [last[a]], hx,
                             data, hexes[0]))
                last[a] = hx
        out.append((d, rows))
    return out

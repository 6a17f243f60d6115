"""YCSB's core-workload records as Automerge map documents (a
configuration's ``schema`` "ycsb"). A document is one record: a root map
of ``fields`` string fields ``field0``, ``field1``, ..., each of
``field_length`` bytes of printable ASCII (YCSB's defaults: 10 fields of
100 bytes). A load change inserts a record with all its fields; an update
sets one field, drawn uniformly, to a new value (YCSB's
``writeallfields=false``). Documents are drawn Zipfian over a seeded
permutation (``zipf_theta``, YCSB's 0.99), and each change comes from one
of ``replicas`` replicas, each with an actor of its own per document.

Views: at the start of every step a replica has seen every change of the
earlier steps (the cell's sync, or the server's relay between flushes,
brought them); within a step it sees its own changes. So a replica's first
change on a document in a step depends on the document's heads at the
step's start, and its ops take counters above the document's maxOp; an
update names as pred the ops of its field visible in its view: the
step-start set (which resolves the conflicts of earlier steps), or its own
last set of the field in the step. Updates of one field by two replicas in
one step stay visible as a conflict until a later step overwrites them.

Traffic keys (``traffic/<mix>.json``): ``steps``, ``shape_seed``, ``load``
(a first step in which replica d mod replicas inserts document d: YCSB's
load phase) and either ``changes_per_replica`` (epochs: every replica
makes that many updates, delivered per replica) or ``dirty_docs``
(flushes: updates from uniformly drawn replicas until that many distinct
documents are dirty). The traffic's ``shape_seed`` draws the shape of the
work (which popularity rank, replica and field each update takes);
``--seed`` draws which document holds each rank, the actor ids and the
values. So every seed does the same work on other documents and data."""
from __future__ import annotations

import numpy as np

from harness import encoder as E
from harness import traffic
from harness.traffic import Changes, Stream, actor_id, run_jobs, zipf_probs

#: op records of a change: per op its field index, value and preds
OP_FIELDS = ("keys", "values", "preds")
#: YCSB's RandomByteIterator draws its bytes from these 64 characters
VALUE_CHARS = (32, 96)


def field_name(f: int) -> str:
    return f"field{f}"


def _events(cfg, mix, shape, probs, perm):
    """[(doc, replica)] per step, and how many steps lead as loads."""
    docs, replicas, steps = cfg["docs"], cfg["replicas"], mix["steps"]
    out = []
    if "changes_per_replica" in mix:
        per = mix["changes_per_replica"]
        d = perm[shape.choice(docs, size=(steps, replicas, per), p=probs)]
        out = [[(int(d[s, r, i]), r) for r in range(replicas)
                for i in range(per)] for s in range(steps)]
    elif "dirty_docs" in mix:
        dirty = mix["dirty_docs"]
        chunk = max(4 * dirty, 1024)
        d = perm[shape.choice(docs, size=chunk, p=probs)]
        r = shape.integers(0, replicas, size=chunk)
        pos = 0
        for _ in range(steps):
            seen, step = set(), []
            while len(seen) < dirty:
                if pos == len(d):
                    d = perm[shape.choice(docs, size=chunk, p=probs)]
                    r = shape.integers(0, replicas, size=chunk)
                    pos = 0
                seen.add(int(d[pos]))
                step.append((int(d[pos]), int(r[pos])))
                pos += 1
            out.append(step)
    else:
        raise ValueError("a ycsb mix gives changes_per_replica or "
                         "dirty_docs")
    loads = 0
    if mix.get("load"):
        out.insert(0, sorted(((k, k % replicas) for k in range(docs)),
                             key=lambda e: (e[1], e[0])))
        loads = 1
    return out, loads


def make_stream(cfg: dict, mix: dict, seed: int) -> Stream:
    shape = np.random.default_rng(mix["shape_seed"])
    rng = np.random.default_rng(seed)
    docs, replicas, fields = cfg["docs"], cfg["replicas"], cfg["fields"]
    perm = rng.permutation(docs)
    events, loads = _events(cfg, mix, shape,
                            zipf_probs(docs, cfg["zipf_theta"]), perm)
    ev_doc = np.array([d for step in events for d, _ in step], np.int64)
    ev_rep = np.array([r for step in events for _, r in step], np.int64)
    ev_step = np.repeat(np.arange(len(events)), [len(s) for s in events])
    total = len(ev_doc)
    ev_load = ev_step < loads
    ev_field = shape.integers(0, fields, size=total)
    nops = np.where(ev_load, fields, 1)
    offsets = np.concatenate([[0], np.cumsum(nops)])
    values = rng.integers(*VALUE_CHARS, size=(int(offsets[-1]),
                                              cfg["field_length"]),
                          dtype=np.uint8)
    jobs = []
    nworkers = traffic.workers(total)
    for g in range(nworkers):
        idx = np.nonzero(ev_doc % nworkers == g)[0]
        rows = np.concatenate([np.arange(offsets[i], offsets[i + 1])
                               for i in idx]) if len(idx) else \
            np.zeros(0, np.int64)
        jobs.append((seed, fields, idx, ev_doc[idx], ev_rep[idx],
                     ev_step[idx], ev_load[idx], ev_field[idx],
                     values[rows]))
    rows = [None] * total
    for part in run_jobs(encode_group, jobs):
        for row in part:
            rows[row[0]] = row[1:]
    ch = Changes("ycsb", OP_FIELDS)
    ch.fill(rows)
    steps, i = [], 0
    for step in events:
        per_source = {}
        for j in range(i, i + len(step)):
            per_source.setdefault(int(ev_rep[j]), []).append(j)
        i += len(step)
        steps.append(sorted(per_source.items()))
    return Stream(steps, ch, docs, replicas)


def encode_group(job):
    """Encodes the changes of one group of documents, in generation order;
    all state is per document, so groups are independent. Returns
    [(change index, doc, actor, seq, startOp, nops, deps, hash, bytes,
    field indices, values, preds)]."""
    (seed, fields, idx, ev_doc, ev_rep, ev_step, ev_load, ev_field,
     values) = job
    keys = [E.utf8(field_name(f)) for f in range(fields)]
    actors, hexes, seq, own_head, own_last = {}, {}, {}, {}, {}
    heads, max_op, visible = {}, {}, {}      # per doc, at the step start
    touched, mine, new_field = {}, {}, {}    # this step's
    out = []
    step, row = None, 0
    for n, i in enumerate(idx.tolist()):
        d, r, s = int(ev_doc[n]), int(ev_rep[n]), int(ev_step[n])
        if s != step:
            for td, rs in touched.items():
                heads[td] = [own_head[(td, tr)] for tr in sorted(rs)]
                max_op[td] = max(max_op.get(td, 0),
                                 *(own_last[(td, tr)] for tr in rs))
                vis = visible.setdefault(td, {})
                for f, per in new_field[td].items():
                    vis[f] = sorted((c, hexes[(td, tr)])
                                    for tr, c in per.items())
            touched, mine, new_field, step = {}, {}, {}, s
        a = (d, r)
        if a not in actors:
            actors[a] = actor_id(seed, d, r, 16)
            hexes[a] = actors[a].hex()
        me = hexes[a]
        if r not in touched.get(d, ()):
            deps = list(heads.get(d, []))
            start = max_op.get(d, 0) + 1
        else:
            deps = [own_head[a]]
            start = own_last[a] + 1
        seq[a] = seq.get(a, 0) + 1
        op_fields = list(range(fields)) if ev_load[n] else [int(ev_field[n])]
        own = mine.setdefault(a, {})
        vis = visible.get(d, {})
        preds = [[(own[f], me)] if f in own else list(vis.get(f, ()))
                 for f in op_fields]
        others = sorted({act for ps in preds for _, act in ps} - {me})
        slot = {me: 0, **{act: k + 1 for k, act in enumerate(others)}}
        vals = [values[row + j].tobytes() for j in range(len(op_fields))]
        row += len(op_fields)
        body = E.change_head(actors[a], seq[a], start, deps,
                             [bytes.fromhex(x) for x in others]) + \
            E.set_ops_blob([keys[f] for f in op_fields], vals,
                           [[(c, slot[act]) for c, act in ps]
                            for ps in preds])
        hx, data = E.container(body)
        own_head[a] = bytes.fromhex(hx)
        own_last[a] = start + len(op_fields) - 1
        touched.setdefault(d, set()).add(r)
        per_field = new_field.setdefault(d, {})
        for j, f in enumerate(op_fields):
            own[f] = start + j
            per_field.setdefault(f, {})[r] = start + j
        out.append((i, d, me, seq[a], start, len(op_fields),
                    [x.hex() for x in deps], hx, data, op_fields,
                    [v.decode("ascii") for v in vals], preds))
    return out

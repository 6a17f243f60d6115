"""Collaborative text documents (a configuration's ``schema`` "text",
BASELINE configs[1]: Automerge.Text, 2-actor concurrent insert/delete,
10k ops). Per document, actor 0 makes the root text object ``key`` and
types ``seed_chars`` characters as one change; then ``rounds`` rounds, in
each of which both actors make one change of ``ops_per_change`` ops. An
actor's change of round r depends on both actors' changes of round r - 1
(the seed change for round 0): the two editors sync through the server
between rounds, so the two changes of a round are concurrent and take
the same op counters (ties broken by actor id).

An actor edits with a cursor, an element of the text or ``_head``, and
sees the text of the round's start with its own ops of the round. An op
first keeps the cursor (``run_share``) or jumps it to a live element
drawn uniformly (``_head`` if none is live), then inserts (``insert_share``)
or deletes. An insert goes after the cursor and becomes the cursor. A
delete is a backspace: it removes the last live element at or before the
cursor, and the cursor moves to the live element before that one (or
``_head``); with no live element there it removes the first live element
after the cursor, and with none at all it inserts instead. Both cursors
start at the end of the seed text. Both actors may delete one element
concurrently and may insert after an element the other has just deleted.

Traffic keys (``traffic/<mix>.json``): ``docs_per_step`` documents go
together through all their rounds, one step a round (the seed change
rides round 0); ``shape_seed`` draws the shape of the work (which ops
insert and which jump), ``--seed`` the actor ids, the jump targets, the
characters and the order of a round's two changes in its delivery. So
every seed does the same work on other data.

Op records of a change (`OP_FIELDS`): ``kinds``, one letter an op (``m``
makes the text, ``i`` inserts, ``d`` deletes); ``refs``, per op the
element it names as (counter, actor hex): the element an insert goes
after (None for ``_head``) or the element a delete removes (None for
``m``); ``chars``, the inserted characters in op order. The records
carry the text's root key as ``text_key``."""
from __future__ import annotations

import itertools

import numpy as np

from harness import encoder as E
from harness import traffic
from harness.traffic import Changes, Stream, actor_id, run_jobs

OP_FIELDS = ("kinds", "refs", "chars")
HEAD = -1

# column ids of a change's ops (backend/columnar.js), ascending
OBJ_ACTOR, OBJ_CTR = 0x01, 0x02
KEY_ACTOR, KEY_CTR, KEY_STR = 0x11, 0x13, 0x15
INSERT, ACTION, VAL_LEN, VAL_RAW = 0x34, 0x42, 0x56, 0x57
PRED_NUM, PRED_ACTOR, PRED_CTR = 0x70, 0x71, 0x73
ACTION_SET, ACTION_DEL, ACTION_MAKE_TEXT = 1, 3, 4
TAG_UTF8 = 6


# ---------------------------------------------------------------------- #
# the frozen encoder of text changes


def rle_nullable(values, raw=E.uleb) -> bytes:
    """RLE column of `values`, None for a null: each run of nulls as ``0,
    count``, the values between as ``harness/encoder.rle`` writes them. A
    column of nulls only is empty."""
    if all(v is None for v in values):
        return b""
    out = []
    for null, group in itertools.groupby(values, key=lambda v: v is None):
        group = list(group)
        out.append(E.sleb(0) + E.uleb(len(group)) if null
                   else E.rle(group, raw))
    return b"".join(out)


def delta_nullable(values) -> bytes:
    """Delta column with nulls: each value as its difference from the
    previous non-null value (from 0), nulls as nulls."""
    diffs, last = [], 0
    for v in values:
        if v is None:
            diffs.append(None)
        else:
            diffs.append(v - last)
            last = v
    return rle_nullable(diffs, E.sleb)


def boolean(values) -> bytes:
    """Boolean column: alternating run lengths, starting with false."""
    out, last, count = [], False, 0
    for v in values:
        if v == last:
            count += 1
        else:
            out.append(E.uleb(count))
            last, count = v, 1
    if count:
        out.append(E.uleb(count))
    return b"".join(out)


def text_ops_blob(ops, actor_index) -> bytes:
    """Columns of a change's ops on one text object. `ops`: per op
    (kind, obj, ref, char) with `kind` "m" (makeText at root key
    ``ref``), "i" (insert `char` after element `ref`, None for
    ``_head``) or "d" (delete element `ref`); `obj` and element refs are
    (counter, actor hex); `actor_index` maps actor hex to its index in
    the change's actor table."""
    obj_actor, obj_ctr, key_actor, key_ctr, key_str = [], [], [], [], []
    insert, action, val_len, raw = [], [], [], []
    pred_num, pred_actor, pred_ctr = [], [], []
    for kind, obj, ref, char in ops:
        if kind == "m":
            obj_actor.append(None)
            obj_ctr.append(None)
            key_actor.append(None)
            key_ctr.append(None)
            key_str.append(ref)
            insert.append(False)
            action.append(ACTION_MAKE_TEXT)
            val_len.append(0)
            pred_num.append(0)
            continue
        obj_actor.append(actor_index[obj[1]])
        obj_ctr.append(obj[0])
        key_str.append(None)
        if ref is None:
            key_actor.append(None)
            key_ctr.append(0)
        else:
            key_actor.append(actor_index[ref[1]])
            key_ctr.append(ref[0])
        if kind == "i":
            data = char.encode("utf-8")
            insert.append(True)
            action.append(ACTION_SET)
            val_len.append(len(data) << 4 | TAG_UTF8)
            raw.append(data)
            pred_num.append(0)
        else:
            insert.append(False)
            action.append(ACTION_DEL)
            val_len.append(0)
            pred_num.append(1)
            pred_actor.append(actor_index[ref[1]])
            pred_ctr.append(ref[0])
    return E.columns_blob([
        (OBJ_ACTOR, rle_nullable(obj_actor)),
        (OBJ_CTR, rle_nullable(obj_ctr)),
        (KEY_ACTOR, rle_nullable(key_actor)),
        (KEY_CTR, delta_nullable(key_ctr)),
        (KEY_STR, rle_nullable(key_str, E.utf8)),
        (INSERT, boolean(insert)),
        (ACTION, rle_nullable(action)),
        (VAL_LEN, rle_nullable(val_len)),
        (VAL_RAW, b"".join(raw)),
        (PRED_NUM, rle_nullable(pred_num)),
        (PRED_ACTOR, rle_nullable(pred_actor)),
        (PRED_CTR, delta_nullable(pred_ctr)),
    ])


def encode_text_change(actor: str, seq: int, start_op: int, deps, ops):
    """(hash hex, bytes) of a change of `actor` (hex) whose ops are
    `ops` (as `text_ops_blob` takes them), on `deps` (hex hashes). Its
    actor table is the author, then every other actor its ops name, in
    sorted order."""
    others = sorted({a for _, obj, ref, _ in ops
                     for a in ((obj or (0, actor))[1],
                               (ref if isinstance(ref, tuple)
                                else (0, actor))[1])} - {actor})
    index = {a: i for i, a in enumerate([actor] + others)}
    head = E.change_head(bytes.fromhex(actor), seq, start_op,
                         [bytes.fromhex(h) for h in deps],
                         [bytes.fromhex(a) for a in others])
    return E.container(head + text_ops_blob(ops, index))


# ---------------------------------------------------------------------- #
# the editors


class _Editor:
    """One actor's view of one document in one round: the round's start
    text (`order`, element codes in document order, tombstones included;
    `live` over codes) with the actor's own ops of the round."""

    def __init__(self, order, live, n_live, cursor, rng):
        self.view = list(order)
        self.live = live
        self.born = set()      # own inserts of the round still live
        self.dead = set()      # own deletes of the round
        self.n_live = n_live
        self.rng = rng
        self.at = -1 if cursor == HEAD else self.view.index(cursor)

    def alive(self, code) -> bool:
        return code in self.born or (self.live[code]
                                     and code not in self.dead)

    def jump(self):
        if self.n_live == 0:
            self.at = -1
            return
        view, rng = self.view, self.rng
        while True:
            i = int(rng.integers(len(view)))
            if self.alive(view[i]):
                self.at = i
                return

    def delete(self):
        """The element a delete removes (its code), or None where none is
        live."""
        view = self.view
        t = self.at
        while t >= 0 and not self.alive(view[t]):
            t -= 1
        if t >= 0:
            p = t - 1
            while p >= 0 and not self.alive(view[p]):
                p -= 1
            self.at = p
        else:
            t = self.at + 1
            while t < len(view) and not self.alive(view[t]):
                t += 1
            if t == len(view):
                return None
        code = view[t]
        self.born.discard(code)
        self.dead.add(code)
        self.n_live -= 1
        return code

    def insert(self, code):
        """Puts a new element (`code`, the greatest so far) after the
        cursor; returns the code of the element it goes after."""
        ref = HEAD if self.at < 0 else self.view[self.at]
        self.at += 1
        self.view.insert(self.at, code)
        self.born.add(code)
        self.n_live += 1
        return ref


def _merge(first_view, inserts):
    """The document order after a round: `first_view` (the start order
    with one actor's inserts) with the other actor's `inserts`, [(code,
    ref code)] in op order, placed by backend/new.js's rule (after the
    reference element, past every element of greater id)."""
    merged = list(first_view)
    last_code = last_at = None
    for code, ref in inserts:
        if ref == HEAD:
            i = 0
        elif ref == last_code:
            i = last_at + 1
        else:
            i = merged.index(ref) + 1
        while i < len(merged) and merged[i] > code:
            i += 1
        merged.insert(i, code)
        last_code, last_at = code, i
    return merged


def make_doc(cfg, doc, seed, shape_seed):
    """Every change of document `doc`: [(doc, actor, seq, startOp, nops,
    deps, hash, bytes, kinds, refs, chars)], the seed change first, then
    round by round actor 0's and actor 1's; and per round the order of
    its two changes in the delivery."""
    shape = np.random.default_rng([shape_seed, doc])
    size = (cfg["rounds"], 2, cfg["ops_per_change"])
    shape_ins = shape.random(size) < cfg["insert_share"]
    shape_jump = shape.random(size) >= cfg["run_share"]
    rng = np.random.default_rng([seed, doc])
    alphabet = cfg["alphabet"]
    hexes = [actor_id(seed, doc, a, 16).hex() for a in range(2)]
    bit = [int(hexes[a] > hexes[1 - a]) for a in range(2)]
    nseed, nops, rounds = cfg["seed_chars"], cfg["ops_per_change"], \
        cfg["rounds"]
    obj = (1, hexes[0])

    def opid(code):
        return None if code == HEAD else (code >> 1,
                                          hexes[0] if (code & 1) == bit[0]
                                          else hexes[1])

    total = 2 + nseed + rounds * nops
    live = bytearray(2 * (total + 1))
    draw = rng.integers(len(alphabet), size=nseed + rounds * 2 * nops)
    text = "".join(alphabet[c] for c in draw)
    ops = [("m", None, cfg["key"], None)]
    order = []
    for j in range(nseed):
        ctr = 2 + j
        ops.append(("i", obj, None if j == 0 else (ctr - 1, hexes[0]),
                    text[j]))
        code = ctr << 1 | bit[0]
        order.append(code)
        live[code] = 1
    hx, data = encode_text_change(hexes[0], 1, 1, [], ops)
    rows = [(doc, hexes[0], 1, 1, len(ops), [], hx, data,
             "m" + "i" * nseed, [None] + [o[2] for o in ops[1:]],
             text[:nseed])]
    heads = [hx]
    cursor = [order[-1], order[-1]]
    n_live, pos = nseed, nseed
    swaps = rng.random(rounds) < 0.5
    for r in range(rounds):
        start = 2 + nseed + r * nops
        editors, inserts, hashes = [], [], []
        for a in range(2):
            ed = _Editor(order, live, n_live, cursor[a], rng)
            kinds, refs, ops, mine = [], [], [], []
            typed = ""
            for j in range(nops):
                if shape_jump[r, a, j]:
                    ed.jump()
                code = (start + j) << 1 | bit[a]
                gone = None if shape_ins[r, a, j] else ed.delete()
                if gone is None:
                    ref = ed.insert(code)
                    typed += text[pos]
                    ops.append(("i", obj, opid(ref), text[pos]))
                    mine.append((code, ref))
                    pos += 1
                else:
                    ops.append(("d", obj, opid(gone), None))
                kinds.append(ops[-1][0])
                refs.append(ops[-1][2])
            cursor[a] = HEAD if ed.at < 0 else ed.view[ed.at]
            seq = r + 1 + (a == 0)
            hx, data = encode_text_change(hexes[a], seq, start, heads, ops)
            rows.append((doc, hexes[a], seq, start, nops, list(heads), hx,
                         data, "".join(kinds), refs, typed))
            editors.append(ed)
            inserts.append(mine)
            hashes.append(hx)
        heads = sorted(hashes)
        order = _merge(editors[0].view, inserts[1])
        gone = editors[0].dead | editors[1].dead
        n_live -= sum(live[code] for code in gone)
        for ed in editors:
            n_live += len(ed.born)
            for code in gone:
                live[code] = 0
            for code in ed.born:
                live[code] = 1
    return rows, swaps


def make_docs(job):
    """{doc: `make_doc`'s (rows, order of each round's changes)} of a
    group of documents."""
    cfg, seed, docs, shape_seed = job
    return {d: make_doc(cfg, d, seed, shape_seed) for d in docs}


def make_stream(cfg: dict, mix: dict, seed: int) -> Stream:
    docs, rounds, group = cfg["docs"], cfg["rounds"], mix["docs_per_step"]
    if docs % group:
        raise ValueError("docs must be a multiple of docs_per_step")
    per_doc = 1 + 2 * rounds
    nworkers = traffic.workers(docs * per_doc * cfg["ops_per_change"])
    jobs = [(cfg, seed, list(range(d0, docs, nworkers)), mix["shape_seed"])
            for d0 in range(nworkers)]
    by_doc = {}
    for part in run_jobs(make_docs, jobs):
        by_doc.update(part)
    rows, swaps = [], []
    for d in range(docs):
        rows.extend(by_doc[d][0])
        swaps.append(by_doc[d][1])
    ch = Changes("text", OP_FIELDS)
    ch.fill(rows)
    ch.text_key = cfg["key"]
    steps = []
    for g in range(0, docs, group):
        for r in range(rounds):
            delivery = []
            for d in range(g, g + group):
                base = d * per_doc
                if r == 0:
                    delivery.append(base)
                pair = [base + 1 + 2 * r, base + 2 + 2 * r]
                delivery.extend(pair[::-1] if swaps[d][r] else pair)
            steps.append([(0, delivery)])
    return Stream(steps, ch, docs, 1)

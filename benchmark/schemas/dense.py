"""Dense map documents (a configuration's ``schema`` "dense"): BASELINE's
batched merge as the port's dense engine takes it, op rows already
columnar. An epoch fills every one of ``docs`` documents from empty to
``rows_per_doc`` rows (about ``ops_per_doc`` ops), in rounds of the
traffic's ``rows_per_round`` rows a document.

The ops are those of ``actors`` replicas of each document that sync with
the server every round (a tick): within a round each replica edits from
the state at the round's start and sees only its own new ops. Per op: a
root key uniform in [0, ``keys``), an actor uniform among the document's,
op id ``counter << 20 | actor`` with counters running on across the
epoch's rounds, action SET, a value uniform below ``max_value``. Its preds
are what backend/new.js's frontend names: every op of the key visible to
its actor, that is the actor's own earlier op of the key in this round
where it has one, else every op of the key visible at the round's start.
Concurrent sets of a key by several actors in one round stay visible side
by side (a conflict) until a later round's op names them all.

An op with several preds takes one row per pred, as the port's farm lays
it out (``tpu/farm.py``): the set names its least pred, and a marker row
(action DEL, value 0, the same op id) follows it for each further pred, so
the marker records that succ edge and is never visible itself. A round of
a document takes the longest run of drawn ops whose rows fit in
``rows_per_round``; the rest of the round is padding rows (``PAD_KEY``).

The rows of one epoch are drawn where the loop runs (`Epoch.draw`: on the
card, by a ``torch.Generator`` there, into pinned host memory), from the
seed, and every epoch of the stream merges them again from empty. The
stream's steps are one a round: (round, sample), where the sample, every
``visibility_every`` rounds and on an epoch's last round, is the
``sample_docs`` documents drawn from the seed whose visible rows the loop
reads back."""
from __future__ import annotations

import numpy as np

from harness.traffic import Changes, Stream

ACTOR_BITS = 20
ACTION_SET, ACTION_DEL = 0, 2
PAD_KEY = 2**31 - 1
#: a row index shifts left by this much beside an op id (below 2**40)
ROW_SHIFT = 41


class Epoch:
    """The rounds of an epoch. Once drawn (`draw`), ``arrays`` holds them
    as five [rounds, docs, rows_per_round] host arrays (key int32, op
    int64, action int32, value int64, pred int64) and ``rounds[r]`` is
    round ``r``, a tuple of five views; ``ops[r]`` and ``rows[r]`` count
    the ops and the rows (padding left out) of that round over all
    documents."""

    def __init__(self, cfg, mix, seed):
        self.docs, self.capacity = cfg["docs"], cfg["rows_per_doc"]
        self.keys, self.actors = cfg["keys"], cfg["actors"]
        self.max_value = cfg["max_value"]
        self.width = mix["rows_per_round"]
        self.rounds_per_epoch = self.capacity // self.width
        self.seed = seed
        self.arrays = self.rounds = self.ops = self.rows = None

    def draw(self, device) -> "Epoch":
        """Draws the rounds on `device`; on the card the host arrays are
        pinned, so that the loop's uploads read pinned memory."""
        import torch

        pin = torch.device(device).type == "cuda"
        cols, self.ops = _draw_epoch(torch, self.seed, device, pin, self)
        self.arrays = tuple(c.numpy() for c in cols)
        self.rows = (self.arrays[0] != PAD_KEY).sum(axis=(1, 2))
        self.rounds = [tuple(c[r] for c in self.arrays)
                       for r in range(self.rounds_per_epoch)]
        return self

    def columns(self, upto, docs=None):
        """The first `upto` rounds side by side: five [docs, upto *
        rows_per_round] arrays, of the documents `docs` (all where
        None)."""
        out = []
        for c in self.arrays:
            part = c[:upto] if docs is None else c[:upto, docs]
            out.append(np.ascontiguousarray(
                part.transpose(1, 0, 2)).reshape(part.shape[1], -1))
        return out


def _draw_epoch(torch, seed, device, pin, epoch):
    """One epoch's rounds drawn on `device` by a generator seeded with
    `seed`: (five [rounds, docs, width] host tensors, ops a round)."""
    docs, width = epoch.docs, epoch.width
    keys, actors = epoch.keys, epoch.actors
    rounds = epoch.rounds_per_epoch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    i64 = dict(dtype=torch.int64, device=device)
    host = [torch.empty((rounds, docs, width), dtype=t, pin_memory=pin)
            for t in (torch.int32, torch.int64, torch.int32, torch.int64,
                      torch.int64)]
    # the op of each actor that is visible on each key (-1: none)
    visible = torch.full((docs, keys, actors), -1, **i64)
    drow = torch.arange(docs, **i64)[:, None]
    col = torch.arange(width, **i64)
    idx_bits = width.bit_length()
    grp_bits = (keys * actors).bit_length()
    n_ops = []
    for r in range(rounds):
        key = torch.randint(0, keys, (docs, width), generator=gen, **i64)
        actor = torch.randint(0, actors, (docs, width), generator=gen, **i64)
        value = torch.randint(0, epoch.max_value, (docs, width),
                              generator=gen, **i64)
        op = actor | ((r * width + 1 + col) << ACTOR_BITS)
        # an actor's ops of one key in this round, in order (one flat sort
        # of (document, group, index)): the first names what was visible
        # at the round's start, each later one the actor's previous op
        group = key * actors + actor
        packed = (drow << (grp_bits + idx_bits)) | (group << idx_bits) | col
        order = packed.reshape(-1).sort().values.reshape(docs, width) & (
            (1 << idx_bits) - 1)
        g = group.gather(1, order)
        o = op.gather(1, order)
        same = g[:, 1:] == g[:, :-1]
        first_s = torch.ones_like(g, dtype=torch.bool)
        first_s[:, 1:] = ~same
        prev_s = torch.full_like(o, -1)
        prev_s[:, 1:] = o[:, :-1]
        first = torch.empty_like(first_s).scatter_(1, order, first_s)
        prev = torch.empty_like(prev_s).scatter_(1, order, prev_s)
        nseen = (visible >= 0).sum(2).gather(1, key)
        nrows = torch.where(first, nseen.clamp(min=1), 1)
        end = nrows.cumsum(1)
        keep = end <= width
        at = end - nrows
        out_key = torch.full((docs, width), PAD_KEY, **i64)
        out_op = torch.zeros((docs, width), **i64)
        out_action = torch.full((docs, width), ACTION_SET, **i64)
        out_value = torch.zeros((docs, width), **i64)
        out_pred = torch.full((docs, width), -1, **i64)
        d, i = keep.nonzero(as_tuple=True)
        slot = at[d, i]
        out_key[d, slot] = key[d, i]
        out_op[d, slot] = op[d, i]
        out_value[d, slot] = value[d, i]
        out_pred[d, slot] = torch.where(first[d, i], -1, prev[d, i])
        # a first op of a key with something visible: its preds, the
        # visible ops in ascending order (one flat sort, each op's row
        # apart), the least on the set and one on each marker after it
        d, i = (keep & first & (nseen > 0)).nonzero(as_tuple=True)
        seen = visible[d, key[d, i]]            # [n, actors], -1: none
        row = torch.arange(len(d), **i64)[:, None] << ROW_SHIFT
        seen = ((row | (seen + 1)).reshape(-1).sort().values.reshape(
            seen.shape) & ((1 << ROW_SHIFT) - 1)) - 1       # -1 first
        n = nseen[d, i]
        slot = at[d, i]
        for j in range(actors):
            has = n > j
            dj, sj = d[has], slot[has] + j
            out_pred[dj, sj] = seen[has, actors - n[has] + j]
            if j:
                out_key[dj, sj] = key[d[has], i[has]]
                out_action[dj, sj] = ACTION_DEL
                out_op[dj, sj] = op[d[has], i[has]]
        n_ops.append(keep.sum())
        # the visible ops after the round: on each key an op touched, the
        # last op of each actor that touched it (every first op named all
        # that was visible before)
        d, i = keep.nonzero(as_tuple=True)
        touched = torch.zeros((docs, keys), dtype=torch.bool, device=device)
        touched[d, key[d, i]] = True
        visible[touched] = -1
        keep_s = keep.gather(1, order)
        nxt_kept = torch.zeros_like(keep_s)
        nxt_kept[:, :-1] = keep_s[:, 1:] & same
        d, j = (keep_s & ~nxt_kept).nonzero(as_tuple=True)
        gs = g[d, j]
        visible[d, gs // actors, gs % actors] = o[d, j]
        for h, c in zip(host, (out_key, out_op, out_action, out_value,
                               out_pred)):
            h[r].copy_(c)
    return host, np.array([int(n) for n in n_ops], np.int64)


def make_stream(cfg: dict, mix: dict, seed: int) -> Stream:
    capacity, width = cfg["rows_per_doc"], mix["rows_per_round"]
    rounds = capacity // width
    if not rounds:
        raise ValueError("a round's rows overflow rows_per_doc")
    epoch_seq, sample_seq = np.random.SeedSequence(seed).spawn(2)
    # a generator's seed below 2**63, from the seed whatever its size
    draw_seed = int(epoch_seq.generate_state(1, np.uint64)[0]) >> 1
    epoch = Epoch(cfg, mix, draw_seed)
    rng = np.random.default_rng(sample_seq)
    ch = Changes("dense")
    ch.epoch = epoch
    docs = cfg["docs"]
    nsample = min(mix["sample_docs"], docs)
    every = mix["visibility_every"]
    steps = []
    for _ in range(mix["epochs"]):
        for r in range(rounds):
            sample = None
            if (r + 1) % every == 0 or r == rounds - 1:
                sample = np.sort(rng.choice(docs, nsample, replace=False))
            steps.append((r, sample))
    return Stream(steps, ch, docs, 1)

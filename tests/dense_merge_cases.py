"""Cases of the dense merge kernel (``csrc/dense_merge.cu``) and a NumPy
mirror of its algorithm, shared by ``test_torch_dense_merge.py`` (the
mirror and the wrapper on the CPU) and ``test_torch_dense_merge_card.py``
(the kernel on the card). The rounds are the dense-100k cell's own traffic,
drawn by its generator (``benchmark/schemas/dense.py``), at the cases'
sizes; a thin layer over it adds what the cell does not send: increments,
documents idle in a round, rows handed out of order and rows handed
again. Imports neither JAX nor the JAX package."""
from __future__ import annotations

import bisect
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import plugins  # noqa: E402

SCHEMA = plugins.load(ROOT, "schemas", "dense")

PAD = 2**31 - 1
I64_MAX = 2**63 - 1
OP_BITS = 44
ACTION_SET, ACTION_INC = 0, 1

#: name -> (docs, capacity, rounds, width, options of `case_rounds`)
CASES = {
    "empty_state": (6, 64, 1, 16, {}),
    "idle_docs": (8, 96, 4, 16, {"idle_share": 0.5}),
    "markers_handed_order": (6, 128, 6, 24, {"keys": 4, "shuffle": True}),
    "in_round_hides": (6, 128, 5, 20, {"keys": 2, "actors": 2}),
    "increments": (6, 128, 5, 20, {"keys": 4, "inc_share": 0.3}),
    "past_capacity": (5, 40, 5, 16, {"keys": 6}),
    "odd_width": (7, 128, 8, 13, {"keys": 8}),
    "wide_round": (3, 1024, 3, 300, {"keys": 16, "shuffle": True}),
    "single_row": (4, 8, 10, 1, {"keys": 3}),
    # rows of the round before handed again: merge keys equal to held ones
    "redelivered": (6, 256, 5, 24, {"keys": 6, "redeliver": True}),
}


def cell_rounds(docs, rounds, width, seed, keys=64, actors=8,
                device="cpu"):
    """`rounds` rounds of `width` rows a document of the dense-100k cell's
    traffic (``Epoch`` of its schema: markers, hides inside a round,
    padding as ``make_empty_state`` pads) over `docs` documents, drawn on
    `device`: a list of (key, op, action, value, pred) host arrays."""
    cfg = {"docs": docs, "rows_per_doc": rounds * width, "keys": keys,
           "actors": actors, "max_value": 10**6}
    epoch = SCHEMA.Epoch(cfg, {"rows_per_round": width}, seed).draw(device)
    return [tuple(np.array(c) for c in rnd) for rnd in epoch.rounds]


def case_rounds(name, seed):
    """(docs, capacity, rounds) of case `name`: the cell's rounds
    (`cell_rounds`), then, by the case's options, ``inc_share`` of the rows
    that name a pred made increments (which hide nothing), each document
    left idle (all padding) in a round with ``idle_share``, each
    document's rows of a round permuted (``shuffle``: padding and markers
    too), and (``redeliver``) each round after the first handing the first
    half of the round before in place of its own second half."""
    docs, capacity, rounds, width, opts = CASES[name]
    opts = dict(opts)
    inc_share = opts.pop("inc_share", 0.0)
    idle_share = opts.pop("idle_share", 0.0)
    shuffle = opts.pop("shuffle", False)
    redeliver = opts.pop("redeliver", False)
    out = cell_rounds(docs, rounds, width, seed, **opts)
    rng = np.random.default_rng(seed)
    for key, op, action, value, pred in out:
        inc = ((key != PAD) & (action == ACTION_SET) & (pred >= 0)
               & (rng.random(key.shape) < inc_share))
        action[inc] = ACTION_INC
        idle = rng.random(docs) < idle_share
        for col, pad in zip((key, op, action, value, pred),
                            (PAD, 0, ACTION_SET, 0, -1)):
            col[idle] = pad
    if shuffle:
        for r, cols in enumerate(out):
            perm = np.argsort(rng.random((docs, width)), axis=1)
            out[r] = tuple(np.take_along_axis(c, perm, 1) for c in cols)
    if redeliver:
        half = width // 2
        for r in range(len(out) - 1, 0, -1):
            for cur, before in zip(out[r], out[r - 1]):
                cur[:, half:] = before[:, :width - half]
    return docs, capacity, out


def empty_state_np(docs, capacity):
    """make_empty_state's padding as NumPy columns."""
    shape = (docs, capacity)
    return [np.full(shape, PAD, np.int32), np.zeros(shape, np.int64),
            np.zeros(shape, np.int32), np.zeros(shape, np.int64),
            np.full(shape, -1, np.int64), np.zeros(shape, bool),
            np.zeros(docs, np.int32)]


def _merge_keys(key, op):
    mk = (key.astype(np.int64) << OP_BITS) | op
    return np.where(key == PAD, I64_MAX, mk)


def mirror_merge(state, changes, tile=5):
    """The kernel's steps on NumPy columns, one document at a time, in
    place: ranks, insertion points, the hides' first rows and the live
    length; hides of the rows before the first output slot where they lie;
    then the rows from that slot to h + real rebuilt a tile of `tile` rows
    at a time from the top, each tile's sources read before it writes."""
    key, op, action, value, pred, over, num_ops = state
    c_key, c_op, c_action, c_value, c_pred = changes
    docs, n = key.shape
    m = c_key.shape[1]
    for d in range(docs):
        u_mkey = _merge_keys(c_key[d], c_op[d])
        hides = (c_action[d] != ACTION_INC) & (c_pred[d] >= 0)
        u_hide = np.where(
            hides, (c_key[d].astype(np.int64) << OP_BITS) | c_pred[d],
            I64_MAX)
        n_real = int((c_key[d] != PAD).sum())
        if n_real == 0:
            continue
        n_hides = int(hides.sum())
        src = sorted(range(m), key=lambda j: (int(u_mkey[j]), j))
        hide = sorted(int(x) for x in u_hide)
        s_mkey = [int(x) for x in _merge_keys(key[d], op[d])]
        pos = [bisect.bisect_left(s_mkey, int(x)) for x in u_mkey]
        hide_at = [bisect.bisect_left(s_mkey, int(x)) if x != I64_MAX
                   else n for x in u_hide]
        h = int((key[d] != PAD).sum())
        slot = [pos[src[r]] + r for r in range(n_real)]
        end = min(h + n_real, n)
        start = min(slot[0], end)
        for j in range(m):
            i = hide_at[j]
            while i < start and s_mkey[i] == u_hide[j]:
                over[d, i] = True
                i += 1
        hi = end
        while hi > start:
            lo = max(hi - tile, start)
            rows = []
            for t in range(lo, hi):
                k = bisect.bisect_right(slot, t)
                if k > 0 and slot[k - 1] == t:
                    j = src[k - 1]
                    rows.append((c_key[d, j], c_op[d, j], c_action[d, j],
                                 c_value[d, j], c_pred[d, j], False))
                else:
                    i = t - k
                    rows.append((key[d, i], op[d, i], action[d, i],
                                 value[d, i], pred[d, i], over[d, i]))
            for t, (k_, o_, a_, v_, p_, ov) in zip(range(lo, hi), rows):
                mk = I64_MAX if k_ == PAD else (
                    int(np.int64(k_) << np.int64(OP_BITS)) | int(o_))
                hit = mk != I64_MAX and mk in hide[:n_hides]
                key[d, t], op[d, t], action[d, t] = k_, o_, a_
                value[d, t], pred[d, t], over[d, t] = v_, p_, ov or hit
            hi = lo
        num_ops[d] += n_real
    return state

"""The ``dense`` loop: a sound CPU run of ``dense-100k`` (cut to 64
documents of 48 rows) passes its own check, the generator names the preds
each actor sees, the plain reference agrees with a per-document walk, and
the control and every planted fault fail the check."""
import numpy as np
import pytest

import control
import run
from harness import plugins

SEED = 2**33 + 4242
CELL = "dense-100k"
#: rounds of a tiny epoch (48 rows a document, 6 a round), and the window
#: steps of a tiny run: two whole epochs
ROUNDS = 8
STEPS = 16
#: readbacks of a tiny epoch (every 2 rounds) and documents a readback
READBACKS, SAMPLE = 4, 8
PAD_KEY = 2**31 - 1
SET, DEL = 0, 2


def _run(root, plant=None, steps=STEPS, **kw):
    return run.run_cell(CELL, SEED, 0.0, False, device="cpu", root=root,
                        plant=plant, steps=steps, **kw)


def _epoch(root, seed):
    from harness.traffic import make_stream

    _, _, cfg, mix = run.load_cell(CELL, root)
    stream = make_stream(cfg, mix, seed, root)
    return stream.changes.epoch.draw("cpu"), stream, cfg


@pytest.mark.parametrize("block", [1024, 5])
def test_a_cpu_run_agrees_with_the_reference(tiny_root, block, monkeypatch):
    monkeypatch.setattr(plugins.load(tiny_root, "loops", "dense"),
                        "CHECK_BLOCK", block)
    result, check, info = _run(tiny_root)
    assert result["correct"], check.notes
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert info["states_checked"] == 64
    # the warm-up epoch's readbacks and the window's two epochs'
    assert info["patches_checked"] == 3 * READBACKS * SAMPLE
    assert result["attempted"] == STEPS * 64 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "dense_merged_ops_per_s",
                                      "dense_round_p95_ms"}
    assert info["apply_ms"]["n"] == STEPS
    epoch, _, _ = _epoch(tiny_root, SEED)
    assert info["rows"] == 2 * int(epoch.rows.sum())


def test_the_last_epoch_is_merged_to_its_end_before_the_check(tiny_root):
    result, check, info = _run(tiny_root, steps=STEPS - 3)
    assert result["correct"], check.notes
    assert info["steps"] == STEPS
    assert result["attempted"] == (STEPS - 3) * 64


def test_the_preds_are_what_each_actor_sees(tiny_root):
    """A walk of every document, round by round: each op's rows name as
    preds its actor's own earlier op of the key in the round where it has
    one, else every op of the key visible at the round's start."""
    epoch, _, cfg = _epoch(tiny_root, SEED)
    key, op, action, value, pred = epoch.arrays
    width = key.shape[2]
    conflicts = 0
    for d in range(cfg["docs"]):
        visible = {}
        for r in range(ROUNDS):
            start = {k: set(v) for k, v in visible.items()}
            mine, ops, i = {}, [], 0
            while i < width and key[r, d, i] != PAD_KEY:
                o, k = int(op[r, d, i]), int(key[r, d, i])
                assert action[r, d, i] == SET
                preds = {int(pred[r, d, i])}
                i += 1
                while i < width and op[r, d, i] == o and \
                        key[r, d, i] != PAD_KEY:
                    assert action[r, d, i] == DEL and value[r, d, i] == 0
                    preds.add(int(pred[r, d, i]))
                    i += 1
                preds.discard(-1)
                actor = o & (2**20 - 1)
                want = ({mine[k, actor]} if (k, actor) in mine
                        else start.get(k, set()))
                assert preds == want, (d, r, o)
                mine[k, actor] = o
                ops.append((k, o, preds))
            assert (key[r, d, i:] == PAD_KEY).all()
            for k, o, preds in ops:
                visible[k] = (visible.get(k, set()) - preds) | {o}
        conflicts += sum(len(v) > 1 for v in visible.values())
    assert conflicts > 0


def _walk(key, op, action, value, pred, lww):
    """One document by a plain walk over its ops in the order handed (an
    op's rows side by side): {op: (key, value, overwritten)}."""
    ops = {}
    for k, o, a, v, p in zip(key, op, action, value, pred):
        if k == PAD_KEY:
            continue
        if o not in ops:
            if lww:
                for other, (k2, v2, _) in ops.items():
                    if k2 == k:
                        ops[other] = (k2, v2, True)
            ops[o] = (k, v if a == SET else None, False)
        elif a == DEL:
            assert ops[o][1] is not None
        if not lww and p >= 0 and p in ops:
            k2, v2, _ = ops[p]
            ops[p] = (k2, v2, True)
    return ops


@pytest.mark.parametrize("lww", [False, True])
def test_the_reference_agrees_with_a_walk(tiny_root, lww):
    ref = plugins.load(tiny_root, "reference", "dense")
    epoch, _, cfg = _epoch(tiny_root, SEED + 9)
    cols = epoch.columns(ROUNDS)
    out = ref.merge(*cols, capacity=epoch.capacity, lww=lww)
    multi = 0
    for d in range(cfg["docs"]):
        ops = _walk(*(c[d] for c in cols), lww=lww)
        real = [(int(k), int(o)) for k, o in zip(cols[0][d], cols[1][d])
                if k != PAD_KEY]
        n = len(real)
        assert out["num_ops"][d] == n
        assert list(zip(out["key"][d, :n], out["op"][d, :n])) == sorted(
            real, key=lambda ko: (ko[0], ko[1]))
        assert (out["key"][d, n:] == PAD_KEY).all()
        winners = {}
        for o, (k, v, over) in ops.items():
            if not over:
                winners[k] = max(winners.get(k, -1), o)
        for i in range(n):
            o = int(out["op"][d, i])
            k, v, over = ops[o]
            marker = out["action"][d, i] == DEL
            multi += marker
            assert out["overwritten"][d, i] == over
            assert out["visible"][d, i] == (not over and not marker)
            assert out["winner"][d, i] == (
                not marker and winners.get(k) == o)
            assert out["value_total"][d, i] == (
                0 if over or marker else v)
    assert multi > 0


def _wrap(farms, name, fn):
    engine = farms[0]
    setattr(engine, name, fn(getattr(engine, name)))


def _edit_batch(farms, edit):
    """Plants `edit(batch)` on every uploaded batch (a copy: on the CPU the
    batch shares the stream's arrays)."""

    def upload(original):
        def fn(columns):
            batch = original(columns)
            return edit(batch._replace(**{f: getattr(batch, f).clone()
                                          for f in batch._fields}))
        return fn

    _wrap(farms, "upload", upload)


def plant_stale(farms, syncs):
    """A step that returns its state unchanged: no merge happens."""
    _wrap(farms, "apply", lambda original: lambda state, batch: state)


def plant_skipped_round(farms, syncs):
    """One round of each epoch left out: the fourth merge of every 8."""
    calls = []

    def apply(original):
        def fn(state, batch):
            calls.append(1)
            return (state if len(calls) % ROUNDS == 4
                    else original(state, batch))
        return fn

    _wrap(farms, "apply", apply)


def plant_half(farms, syncs):
    """Half of the batch left out: every other document's rows."""

    def edit(batch):
        batch.key[1::2] = PAD_KEY
        return batch

    _edit_batch(farms, edit)


def plant_dropped_row(farms, syncs):
    """The first row of every document's round dropped."""

    def edit(batch):
        batch.key[:, 0] = PAD_KEY
        return batch

    _edit_batch(farms, edit)


def plant_preds_ignored(farms, syncs):
    """Every row handed without its pred: nothing is overwritten."""

    def edit(batch):
        batch.pred.fill_(-1)
        return batch

    _edit_batch(farms, edit)


def plant_markers_ignored(farms, syncs):
    """Every op's further preds dropped: its marker rows handed as
    padding, so the conflicts they resolve stay visible."""

    def edit(batch):
        batch.key[batch.action == DEL] = PAD_KEY
        return batch

    _edit_batch(farms, edit)


def plant_wrong_winner(farms, syncs):
    """The winner flag of every document's first row flipped."""

    def visible(original):
        def fn(state):
            key, op, vis, winner, total = original(state)
            winner = winner.clone()
            winner[:, 0] = ~winner[:, 0]
            return key, op, vis, winner, total
        return fn

    _wrap(farms, "visible", visible)


def plant_altered(farms, syncs):
    """An answer altered where it is produced: the first read-back value
    of every readback plus one."""

    def read(original):
        def fn(vis, docs):
            rows = original(vis, docs)
            rows[4] = rows[4].copy()
            rows[4][0, 0] += 1
            return rows
        return fn

    _wrap(farms, "read", read)


FAULTS = [plant_stale, plant_skipped_round, plant_half, plant_dropped_row,
          plant_preds_ignored, plant_markers_ignored, plant_wrong_winner,
          plant_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_fails_the_check(tiny_root, fault):
    result, check, _ = _run(tiny_root, plant=fault)
    assert not result["correct"], result["checks"]


def test_the_readback_alone_catches_an_altered_answer(tiny_root):
    result, _, _ = _run(tiny_root, plant=plant_altered)
    checks = result["checks"]
    assert checks["patch_mismatches"]["value"] == 3 * READBACKS
    assert checks["state_mismatches"]["value"] == 0


def test_a_lost_op_counts_every_document_it_hits(tiny_root, monkeypatch):
    monkeypatch.setattr(plugins.load(tiny_root, "loops", "dense"),
                        "CHECK_BLOCK", 5)
    result, _, _ = _run(tiny_root, plant=plant_half)
    checks = result["checks"]
    assert checks["failed_changes"]["value"] == 32 == result["failed"]
    assert checks["state_mismatches"]["value"] == 32


def test_the_control_fails_the_check(tiny_root):
    result, check, _ = _run(
        tiny_root, make_farms=control.control_farms(tiny_root),
        driver_cls=control.control_driver(CELL, tiny_root))
    assert not result["correct"]
    assert check.state_mismatches > 0 and check.patch_mismatches > 0


def test_a_traced_cpu_run_hands_the_readers_the_loop(tiny_root,
                                                     monkeypatch):
    seen = []
    original = run.read_metric

    def spy(name, readings, root=run.ROOT):
        seen.append(readings)
        return original(name, readings, root)

    monkeypatch.setattr(run, "read_metric", spy)
    result, _, _ = run.run_cell(CELL, SEED, 0.0, True, device="cpu",
                                root=tiny_root, steps=STEPS)
    assert result["correct"]
    loop = seen[0]["loop"]
    # the one step traced: a merge into a document half full or less
    assert loop["merges"] == 1 and loop["merge_bytes"] > 0
    assert loop["passes"] in (0, 1)
    assert (loop["visibility_bytes"] > 0) == (loop["passes"] == 1)
    # the host alone is traced off the card: no device time to read, and
    # the idle share alone reads the host's trace
    assert set(result["metrics"]) == {"dense.idle_pct"}


def test_the_rounds_are_made_from_the_seed(tiny_root):
    a, sa, _ = _epoch(tiny_root, SEED)
    b, sb, _ = _epoch(tiny_root, SEED)
    c, _, _ = _epoch(tiny_root, SEED + 1)
    for x, y in zip(a.arrays, b.arrays):
        assert np.array_equal(x, y)
    samples = [[s[1] for s in st.steps if s[1] is not None]
               for st in (sa, sb)]
    assert all(np.array_equal(x, y) for x, y in zip(*samples))
    assert not np.array_equal(a.arrays[1], c.arrays[1])
    # the same sizes for every seed: 8 rounds of 6 rows a document, the
    # counters running on, the actors among 4
    key, op, action, value, pred = a.arrays
    assert key.shape == (ROUNDS, 64, 6)
    real = key != PAD_KEY
    assert np.isin(action[real], (SET, DEL)).all()
    counter = op >> 20
    for r in range(ROUNDS):
        assert ((counter[r][real[r]] > r * 6)
                & (counter[r][real[r]] <= (r + 1) * 6)).all()
        assert ((pred[r] == -1) | ((pred[r] >> 20) <= (r + 1) * 6)).all()
    assert ((op[real] & (2**20 - 1)) < 4).all()
    assert (a.rows == real.sum(axis=(1, 2))).all()
    assert (a.ops == (real & (action == SET)).sum(axis=(1, 2))).all()

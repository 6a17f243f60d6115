"""The dense whole-state merge and its entry points, the port against the
JAX package on the CPU: ``batched_apply_ops`` and ``batched_visible_state``
over seeded numpy batches (sets, deletes, counters and their increments,
counter ties among three actors, with and without an actor-rank table)
must leave every state column and every visibility column equal to the
JAX program's, round by round; rows past the capacity drop as JAX drops
them. Beside them: ``transcode.rows``, the transcoder's interner caps,
the ``engine.apply_batch`` fault point, the entry points' default to the
card, the ``engine.apply_ops`` dispatch count, phase 20's dense driver at
a small size, and the four sites where both packages assert."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from automerge_tpu.obs import metrics as jax_metrics
from automerge_tpu.obs import prof as jax_prof
from automerge_tpu.tpu import engine as jax_engine
from automerge_tpu.tpu import transcode as jax_transcode
from automerge_tpu_torch.errors import PackingLimitError
from automerge_tpu_torch.obs import metrics as port_metrics
from automerge_tpu_torch.obs import prof as port_prof
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.tpu import engine
from automerge_tpu_torch.tpu import transcode

PAD = engine.PAD_KEY
STATE = ("key", "op", "action", "value", "pred", "overwritten", "num_ops")
VISIBLE = ("key", "op", "visible", "winner", "value_total")


def seeded_batches(docs, rounds, width, seed, counters=True, keys=6):
    """Per round a [docs, width] change batch of a random number of real
    rows each: op = (counter << 20 | actor) with three actors sharing each
    counter (ties for the rank table), sets with and without a pred,
    deletes, counter sets and increments of them. Pads fill the rest."""
    rng = np.random.default_rng(seed)
    last = [dict() for _ in range(docs)]      # key -> last op
    counter = [dict() for _ in range(docs)]   # key -> counter set op
    out = []
    for r in range(rounds):
        key = np.full((docs, width), PAD, np.int32)
        op = np.zeros((docs, width), np.int64)
        action = np.zeros((docs, width), np.int32)
        value = np.zeros((docs, width), np.int64)
        pred = np.full((docs, width), -1, np.int64)
        for d in range(docs):
            for i in range(int(rng.integers(0, width + 1))):
                k = int(rng.integers(0, keys))
                oid = ((r * width + i // 3 + 1) << engine.ACTOR_BITS) | (i % 3)
                key[d, i], op[d, i] = k, oid
                value[d, i] = int(rng.integers(-50, 1000))
                roll = rng.random()
                if k in counter[d]:
                    action[d, i], pred[d, i] = engine.ACTION_INC, counter[d][k]
                    continue
                if roll < 0.1 and k in last[d]:
                    action[d, i], pred[d, i] = engine.ACTION_DEL, last[d][k]
                    del last[d][k]
                    continue
                if counters and roll < 0.25:
                    counter[d][k] = oid
                elif k in last[d] and roll < 0.8:
                    pred[d, i] = last[d][k]
                last[d][k] = oid
        out.append((key, op, action, value, pred))
    return out


def run_jax(docs, capacity, batches, actor_rank=None):
    state = jax_engine.make_empty_state(docs, capacity)
    states = []
    for b in batches:
        state = jax_engine.batched_apply_ops(
            state, jax_engine.ChangeOpsBatch(*[jnp.asarray(x) for x in b]))
        states.append([np.asarray(c) for c in state])
    vis = jax_engine.batched_visible_state(state, actor_rank)
    return states, [np.asarray(c) for c in vis]


def run_port(docs, capacity, batches, actor_rank=None):
    state = engine.make_empty_state(docs, capacity, device="cpu")
    states = []
    for b in batches:
        out = engine.batched_apply_ops(
            state, engine.changes_from_numpy(*b, device="cpu"))
        assert out is state  # merged in place (JAX donates the state)
        states.append([c.numpy().copy() for c in state])
    vis = engine.batched_visible_state(state, actor_rank)
    return states, [c.numpy() for c in vis]


def assert_columns_equal(got, want, names, what):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, name)


@pytest.mark.parametrize("rounds,counters,ranked", [
    (1, False, False), (3, True, False), (8, True, True), (8, False, True)])
def test_dense_merge_and_visibility_match_jax(rounds, counters, ranked):
    docs, width, capacity = 5, 8, 64
    batches = seeded_batches(docs, rounds, width, 10 + rounds, counters)
    rank = np.array([2, 0, 1], np.int32) if ranked else None
    jax_states, jax_vis = run_jax(docs, capacity, batches, rank)
    port_states, port_vis = run_port(docs, capacity, batches, rank)
    for r, (got, want) in enumerate(zip(port_states, jax_states)):
        assert_columns_equal(got, want, STATE, f"round {r}")
    assert_columns_equal(port_vis, jax_vis, VISIBLE, "visibility")
    assert port_vis[3].any() and (rounds == 1 or port_states[-1][5].any())


def test_capacity_overflow_drops_the_same_rows_as_jax():
    """Capacity 16 and 20 real rows in one batch: the merge keeps the 16
    lowest merge keys and drops the rest, as the JAX program does, and
    ``num_ops`` counts every row merged (20, past the capacity)."""
    rng = np.random.default_rng(3)
    docs, width, capacity = 3, 20, 16
    key = rng.integers(0, 5, (docs, width)).astype(np.int32)
    op = ((np.arange(1, width + 1) << engine.ACTOR_BITS) | 1)[None, :] \
        .repeat(docs, 0).astype(np.int64)
    batch = (key, op, np.zeros((docs, width), np.int32),
             rng.integers(0, 100, (docs, width)).astype(np.int64),
             np.full((docs, width), -1, np.int64))
    second = seeded_batches(docs, 1, 4, 9, counters=False, keys=5)[0]
    jax_states, jax_vis = run_jax(docs, capacity, [batch, second])
    port_states, port_vis = run_port(docs, capacity, [batch, second])
    for got, want in zip(port_states, jax_states):
        assert_columns_equal(got, want, STATE, "overflow")
    assert_columns_equal(port_vis, jax_vis, VISIBLE, "overflow visibility")
    assert (port_states[0][6] == width).all()
    assert (port_states[0][0] != PAD).all()  # every slot holds a kept row


def test_unpack_opid_inverts_pack_opid_as_jax():
    ctr = np.array([0, 1, 77, (1 << 24) - 1], np.int64)
    actor = np.array([0, 5, (1 << 20) - 1, 3], np.int64)
    packed = engine.pack_opid(torch.from_numpy(ctr), torch.from_numpy(actor))
    want = jax_engine.pack_opid(ctr, actor)
    assert np.array_equal(packed.numpy(), np.asarray(want))
    for got, ref in zip(engine.unpack_opid(packed),
                        jax_engine.unpack_opid(want)):
        assert np.array_equal(got.numpy(), np.asarray(ref))


def _stream_rows(docs=4, rounds=3):
    stream, counters = chip_smoke.transcoder_stream(docs, rounds, 6, 5)
    return [[[(op, start + i, actor) for i, op in enumerate(ops)]
             for actor, _seq, start, ops in per_doc] for per_doc in stream]


def test_transcode_rows_counts_as_jax():
    counts = {}
    for name, mod, metrics, kwargs in (
            ("jax", jax_transcode, jax_metrics, {}),
            ("port", transcode, port_metrics, {"device": "cpu"})):
        tr = mod.BatchTranscoder()
        row = metrics.get_metrics().counter("transcode.rows")
        with metrics.enabled_metrics():
            before = row.value
            for rows in _stream_rows():
                tr.changes_to_batch(rows, **kwargs)
            counts[name] = row.value - before
    assert counts["port"] == counts["jax"] > 0


def test_transcoder_interner_caps_match_jax():
    """The interner-cap guard (tests/test_farm_regressions.py): a capped
    table refuses a new entry past its cap and keeps resolving old ones;
    the transcoder caps slots at 2^19 and actors at 2^20 and refuses an op
    counter past the merge-key packing range, as the JAX transcoder."""
    for mod in (jax_transcode, transcode):
        interner = mod._Interner(max_size=2, name="slot")
        assert interner.intern("a") == 0 and interner.intern("b") == 1
        assert interner.intern("a") == 0
        with pytest.raises(ValueError, match="slot table overflow"):
            interner.intern("c")
        tr = mod.BatchTranscoder()
        assert tr.slots.max_size == 1 << 19
        assert tr.actors.max_size == 1 << 20
        assert tr.values.max_size is None
        with pytest.raises(ValueError, match="packing range"):
            tr.op_row({"action": "set", "key": "k", "value": 1}, 1 << 24,
                      "aaaaaaaa")
    with pytest.raises(PackingLimitError):
        transcode.BatchTranscoder().pack_opid_str(f"{1 << 24}@aaaaaaaa")


def test_engine_apply_batch_fault_point_fires():
    eng = engine.BatchedMapEngine(1, 8, device="cpu")
    tr = transcode.BatchTranscoder()
    batch = tr.changes_to_batch(
        [[({"action": "set", "obj": "_root", "key": "k", "value": 1,
            "pred": []}, 1, "aaaaaaaa")]], device="cpu")
    with faults.inject("engine.apply_batch", faults.fail_always()):
        with pytest.raises(RuntimeError, match="injected"):
            eng.apply_batch(batch)
    assert eng.version == 0 and eng.lengths[0] == 0
    eng.apply_batch(batch)  # hook removed on exit
    assert eng.version == 1 and eng.lengths[0] == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_make_empty_state_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.make_empty_state(2, 8)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_changes_to_batch_defaults_to_the_card():
    tr = transcode.BatchTranscoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.changes_to_batch([[]])


def test_apply_ops_dispatches_equal_merges_as_jax():
    """Each ``batched_apply_ops`` is one ``engine.apply_ops`` dispatch and
    each ``batched_visible_state`` one ``engine.visible_cmp``, in both
    packages' observatories."""
    batches = seeded_batches(2, 3, 4, 1)
    tables = {}
    for name, prof, run in (("jax", jax_prof, run_jax),
                            ("port", port_prof, run_port)):
        obs = prof.get_observatory()
        with prof.enabled_observatory():
            obs.reset()
            run(2, 16, batches)
            tables[name] = {n: r["dispatches"] for n, r in obs.table().items()}
            obs.reset()
    assert tables["port"] == tables["jax"] == {
        "engine.apply_ops": 3, "engine.visible_cmp": 1}


def test_phase20_dense_driver_matches_jax():
    """Phase 20's drivers at 24 docs x 3 rounds x 16 ops: bench.py's draws
    (``dense_batches``) through ``run_dense`` on the CPU equal the JAX
    program on the same batches, and ``check_dense`` passes."""
    batches = chip_smoke.dense_batches(24, 3, 16, 0)
    state, vis, elapsed = chip_smoke.run_dense("cpu", batches, 48)
    assert elapsed > 0
    jax_states, jax_vis = run_jax(24, 48, batches)
    got = chip_smoke.dense_columns(state, vis, 24)
    assert_columns_equal(got[:7], jax_states[-1], STATE, "phase 20 state")
    assert_columns_equal(got[7:], jax_vis, VISIBLE, "phase 20 visibility")
    assert chip_smoke.check_dense("cpu", batches, 48, state, vis, "t") == 24
    assert (got[6] == 48).all()


# ---------------------------------------------------------------------- #
# the four sites where the JAX package asserts (engine.py:473, :688;
# farm.py:1293, :2031): both packages raise AssertionError


def test_apply_batch_with_fewer_rows_than_docs_asserts():
    eng = engine.BatchedMapEngine(2, 8, device="cpu")
    batch = engine.changes_from_numpy(
        *[x[:1] for x in seeded_batches(2, 1, 4, 0)[0]], device="cpu")
    with pytest.raises(AssertionError):
        jax_engine.BatchedMapEngine(2, 8).apply_batch(
            jax_engine.changes_from_numpy(
                *[x[:1] for x in seeded_batches(2, 1, 4, 0)[0]]))
    with pytest.raises(AssertionError):
        eng.apply_batch(batch)


def test_adopt_rows_into_an_occupied_doc_asserts():
    rows = ([0], [1 << 20], [0], [5], [-1], [False])
    for eng in (jax_engine.BatchedMapEngine(1, 8),
                engine.BatchedMapEngine(1, 8, device="cpu")):
        eng.adopt_rows(0, *[np.asarray(r) for r in rows])
        with pytest.raises(AssertionError, match="occupied doc"):
            eng.adopt_rows(0, *[np.asarray(r) for r in rows])


def _farms():
    from automerge_tpu.tpu.farm import TpuDocFarm
    from automerge_tpu_torch.tpu.farm import TorchDocFarm

    return TpuDocFarm(2, capacity=8), TorchDocFarm(2, capacity=8,
                                                   device="cpu")


def test_apply_changes_needs_one_buffer_list_per_doc():
    for farm in _farms():
        with pytest.raises(AssertionError):
            farm.apply_changes([[]])


def test_adopt_doc_into_an_occupied_slot_asserts():
    from automerge_tpu_torch.columnar import encode_change

    buf = encode_change({"actor": "aaaaaaaa", "seq": 1, "startOp": 1,
                         "time": 0, "deps": [], "ops": [
                             {"action": "set", "obj": "_root", "key": "k",
                              "value": 1, "pred": []}]})
    for farm in _farms():
        farm.apply_changes([[buf], []])
        with pytest.raises(AssertionError, match="empty doc slot"):
            farm.adopt_doc(0, farm.export_doc(0))

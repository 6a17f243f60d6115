"""Engine parity: the PyTorch merge/visibility programs of
automerge_tpu_torch against the JAX programs of automerge_tpu, on the same
numpy-seeded slabs and change batches, on the CPU. Every output column must
be equal (integer and boolean columns: exact, no tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.tpu import engine as jeng
from automerge_tpu.tpu import paging as jpag
from automerge_tpu_torch.tpu import engine as teng
from automerge_tpu_torch.tpu import paging as tpag
from automerge_tpu_torch.tpu.farm import TorchDocFarm

PAD = teng.PAD_KEY
SET, INC, DEL = teng.ACTION_SET, teng.ACTION_INC, teng.ACTION_DEL


def _batch(rng, a, m, first, n_actors=4):
    """Change batch [a, m] with PAD tails of random length. The first batch
    holds SET rows only (some counters); later ones hold SET/DEL rows that
    overwrite earlier ops and INC rows that target earlier SETs, with
    counter ties across actors."""
    key = np.full((a, m), PAD, np.int32)
    op = np.zeros((a, m), np.int64)
    action = np.zeros((a, m), np.int32)
    value = np.zeros((a, m), np.int64)
    pred = np.full((a, m), -1, np.int64)
    for d in range(a):
        real = int(rng.integers(1, m + 1))
        base = 1 if first is None else 100
        for i in range(real):
            k = int(rng.integers(0, 4))
            ctr = base + i // 2  # pairs share a counter: tie on actor
            actor = int(rng.integers(0, n_actors))
            key[d, i] = k
            op[d, i] = (ctr << teng.ACTOR_BITS) | actor
            value[d, i] = int(rng.integers(0, 50))
            if first is None:
                continue
            fk, fop, fact = first[0][d], first[1][d], first[2][d]
            same = np.nonzero((fk == k) & (fact == SET))[0]
            r = rng.random()
            if r < 0.4 and len(same):
                action[d, i] = INC
                pred[d, i] = int(fop[rng.choice(same)])
            elif r < 0.8 and len(same):
                action[d, i] = SET if rng.random() < 0.7 else DEL
                pred[d, i] = int(fop[rng.choice(same)])
    return key, op, action, value, pred


def _state_after(batches, a, n):
    """Dense [a, n] state built by merging `batches` with the JAX program
    from an empty table (so it is sorted exactly as the engine keeps it)."""
    state = [
        np.full((a, n), PAD, np.int32), np.zeros((a, n), np.int64),
        np.zeros((a, n), np.int32), np.zeros((a, n), np.int64),
        np.full((a, n), -1, np.int64), np.zeros((a, n), bool),
    ]
    merge = jax.jit(jax.vmap(jeng._merge_one_doc))
    for b in batches:
        out = merge(*state, np.zeros(a, np.int32), *b)
        state = [np.asarray(x) for x in out[:6]]
    return state


def _t(arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, n, m = 4, 32, 8
    first = _batch(rng, a, m, None)
    state = _state_after([first], a, n)
    second = _batch(rng, a, m, first)
    want = jax.vmap(jeng._merge_one_doc)(*state, np.zeros(a, np.int32),
                                         *second)
    got = teng.merge_docs(*_t(state), *_t(second))
    _eq(got, want[:6])
    assert got[5].any(), "the batch must overwrite something"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_visible_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, n, m = 4, 32, 8
    first = _batch(rng, a, m, None)
    second = _batch(rng, a, m, first)
    state = _state_after([first, second], a, n)
    rank = rng.permutation(4).astype(np.int32)
    cmp = np.asarray(jeng.remap_opid_actors(jnp.asarray(state[1]), rank))
    want = jax.vmap(jeng._visible_state_one_doc)(*state, cmp)
    tcmp = teng.remap_opid_actors(torch.from_numpy(state[1].copy()),
                                  torch.from_numpy(rank))
    np.testing.assert_array_equal(tcmp.numpy(), cmp)
    np.testing.assert_array_equal(
        teng.pack_opid(torch.arange(5), torch.arange(5) * 3).numpy(),
        np.asarray(jeng.pack_opid(jnp.arange(5), jnp.arange(5) * 3)),
    )
    got = teng.visible_docs(*_t(state), tcmp)
    _eq(got, want)
    assert (state[2] == INC).any() and got[4].any()


def _slab_case(seed, page_size=8):
    """A slab holding 3 docs' pages (shuffled), their page maps, and a
    change batch for them padded to 4 rows (the pad row's write drops)."""
    rng = np.random.default_rng(seed)
    a, n, m = 4, 32, 8
    first = _batch(rng, a, m, None)
    state = _state_after([first], a, n)
    second = _batch(rng, a, m, first)
    npg = n // page_size
    num_pages = 1 + 2 * a * npg
    perm = rng.permutation(np.arange(1, num_pages))
    gather = np.zeros((a, npg), np.int64)
    dest = np.full((a, npg), num_pages, np.int64)
    slab = [np.tile(np.asarray([fill], dtype), num_pages * page_size)
            for fill, dtype in ((PAD, np.int32), (0, np.int64),
                                (0, np.int32), (0, np.int64),
                                (-1, np.int64), (False, bool))]
    for d in range(a - 1):
        gather[d] = perm[d * npg:(d + 1) * npg]
        dest[d] = perm[(a + d) * npg:(a + d + 1) * npg]
        for col, s in zip(slab, state):
            col.reshape(-1, page_size)[gather[d]] = s[d].reshape(npg, page_size)
    second = [x.copy() for x in second]
    second[0][a - 1] = PAD  # the pow2 pad doc carries no rows
    return slab, gather, dest, second, page_size


@pytest.mark.parametrize("seed", [3, 4])
def test_paged_apply_matches_jax(seed):
    slab, gather, dest, changes, P = _slab_case(seed)
    want = jpag.paged_apply_ops(
        jpag.SlabState(*map(jnp.asarray, slab)), jnp.asarray(gather),
        jeng.ChangeOpsBatch(*map(jnp.asarray, changes)),
        jnp.asarray(dest), page_size=P,
    )
    tslab = tpag.SlabState(*_t(slab))
    before = [c.clone() for c in tslab]
    probe = tpag.paged_probe_ops(tslab, torch.from_numpy(gather),
                                 teng.ChangeOpsBatch(*_t(changes)),
                                 page_size=P)
    _eq(tslab, before)  # the probe never mutates the slab
    got = tpag.paged_apply_ops(tslab, torch.from_numpy(gather),
                               teng.ChangeOpsBatch(*_t(changes)),
                               torch.from_numpy(dest), page_size=P)
    _eq(got, want)
    # the probe's rows are what the apply wrote to the destination pages
    for col, p in zip(got, probe):
        np.testing.assert_array_equal(
            col.view(-1, P)[torch.from_numpy(dest[:3])].reshape(3, -1).numpy(),
            p[:3].numpy(),
        )


@pytest.mark.parametrize("seed", [5, 6])
def test_paged_visible_and_patch_columns_match_jax(seed):
    slab, gather, _dest, _changes, P = _slab_case(seed)
    rng = np.random.default_rng(seed)
    rank = rng.permutation(4).astype(np.int32)
    want = jpag.paged_visible_ranked(
        jpag.SlabState(*map(jnp.asarray, slab)), jnp.asarray(gather),
        jnp.asarray(rank), page_size=P,
    )
    got = tpag.paged_visible_ranked(
        tpag.SlabState(*_t(slab)), torch.from_numpy(gather),
        torch.from_numpy(rank), page_size=P,
    )
    _eq(got, want)
    idx = rng.integers(0, got[0].numel(), size=16).astype(np.int64)
    cut = rng.choice(
        [-1, np.iinfo(np.int64).max, 100 << 20, 3 << 20], size=16
    ).astype(np.int64)
    _k, op, visible, _w, totals = want
    want_cols = jpag.patch_column_rows(visible, totals, op, jnp.asarray(rank),
                                       jnp.asarray(idx), jnp.asarray(cut))
    got_cols = tpag.patch_column_rows(got[2], got[4], got[1],
                                      torch.from_numpy(rank),
                                      torch.from_numpy(idx),
                                      torch.from_numpy(cut))
    _eq(got_cols, want_cols)


def _pages_consistent(farm):
    """The allocator's view must match the per-doc page tables exactly:
    every allocated page is owned by exactly one document."""
    owned = [p for d in range(farm.num_docs) for p in farm.engine.page_table[d]]
    assert len(owned) == len(set(owned)), "page owned twice"
    assert 0 not in owned, "PAD page handed out"
    assert len(owned) == farm.engine.pages.allocated
    for d in range(farm.num_docs):
        need = farm.engine.pages.pages_for(int(farm.engine.lengths[d]))
        assert len(farm.engine.page_table[d]) == need


def test_page_allocator_leaks_nothing_under_quarantine():
    from bench import _make_change_stream

    from automerge_tpu.testing import faults

    stream = _make_change_stream(3, 8, 0)
    farm = TorchDocFarm(4, capacity=32, quarantine_threshold=None,
                        page_size=8, device="cpu")
    farm.apply_changes([[stream[0]]] * 4)
    _pages_consistent(farm)
    before = list(farm.engine.page_table[2])
    bad = bytes(faults.truncated(stream[1]))
    result = farm.apply_changes(
        [[stream[1]], [stream[1]], [bad], [stream[1]]]
    )
    assert 2 in result.quarantined
    assert farm.engine.page_table[2] == before
    _pages_consistent(farm)
    # a packing-limit failure in the gate phase restores pages too
    big = faults.make_change("cccccccc", 1, 1 << 24, [],
                             [faults.set_op("k", 1)])
    result = farm.apply_changes([[big], [stream[2]], [], []])
    assert 0 in result.quarantined and 1 not in result.quarantined
    _pages_consistent(farm)
    farm.evict_doc(1)
    _pages_consistent(farm)

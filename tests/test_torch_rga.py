"""The port's batched RGA rank against the JAX package's, exactly, on the
CPU: random insertion forests and the adversarial shapes (a 500-deep
chain, all inserts at the head, counter ties under a non-lexicographic
actor intern order, invalid slots), plus the sequential oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.tpu.rga import batched_rga_rank as jax_rank
from automerge_tpu_torch.errors import PackingLimitError
from automerge_tpu_torch.tpu import rga
from automerge_tpu_torch.tpu.text_engine import HostDocOrder

ACTORS = ["cc", "aa", "dd", "bb"]        # intern order
RANK = np.array([2, 0, 3, 1], np.int32)  # lexicographic rank per index


def _both(parent, opid, valid, actor_rank=RANK):
    want = np.asarray(jax_rank(jnp.asarray(parent), jnp.asarray(opid),
                               jnp.asarray(valid), jnp.asarray(actor_rank)))
    got = rga.batched_rga_rank(
        torch.from_numpy(parent), torch.from_numpy(opid),
        torch.from_numpy(valid), torch.from_numpy(actor_rank),
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    return want


def _forest(rng, docs, width, ties):
    """Causal forests: a node's counter exceeds its parent's. With `ties`,
    pairs of nodes share a counter and differ in the actor."""
    parent = np.full((docs, width), -1, np.int32)
    opid = np.zeros((docs, width), np.int64)
    valid = np.zeros((docs, width), bool)
    for d in range(docs):
        n = int(rng.integers(0, width + 1))
        valid[d, :n] = True
        for i in range(n):
            ctr = i // 2 + 1 if ties else i + 1
            lo = 2 * (i // 2) if ties else i
            if lo and rng.random() < 0.8:
                parent[d, i] = int(rng.integers(0, lo))
            actor = (i % 2) if ties else int(rng.integers(0, len(ACTORS)))
            opid[d, i] = (ctr << 20) | actor
    return parent, opid, valid


def _host_order(parent, opid, valid):
    """Ranks from the sequential scan, inserting in slot (causal) order."""
    order = HostDocOrder()
    names = {}
    for i in np.nonzero(valid)[0]:
        i = int(i)
        names[i] = f"{int(opid[i]) >> 20}@{ACTORS[int(opid[i]) & 0xFFFFF]}"
        ref = "_head" if parent[i] < 0 else names[int(parent[i])]
        order.insert(names[i], ref)
    pos = order.ranks()
    return {i: pos[n] for i, n in names.items()}


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_random_forests_match_jax_and_oracle(seed, ties):
    rng = np.random.default_rng(seed)
    parent, opid, valid = _forest(rng, 6, 48, ties)
    ranks = _both(parent, opid, valid)
    for d in range(6):
        for i, r in _host_order(parent[d], opid[d], valid[d]).items():
            assert ranks[d, i] == r
        assert (ranks[d][~valid[d]] == 48).all()


def test_deep_chain_and_head_inserts():
    e = 512
    parent = np.full((2, e), -1, np.int32)
    opid = np.zeros((2, e), np.int64)
    valid = np.zeros((2, e), bool)
    # doc 0: a 500-deep chain, each element after the previous one
    valid[0, :500] = True
    parent[0, 1:500] = np.arange(499)
    opid[0, :500] = (np.arange(1, 501) << 20) | 1
    # doc 1: 500 inserts, all at the head: reverse arrival order
    valid[1, :500] = True
    opid[1, :500] = (np.arange(1, 501) << 20) | 2
    ranks = _both(parent, opid, valid)
    assert ranks[0, :500].tolist() == list(range(500))
    assert ranks[1, :500].tolist() == list(range(499, -1, -1))


def test_counter_ties_break_on_the_actor_string():
    # four concurrent head inserts with one counter: order by actor string
    # descending ("dd" > "cc" > "bb" > "aa"), not by intern index
    parent = np.full((1, 4), -1, np.int32)
    opid = np.array([[(5 << 20) | a for a in range(4)]], np.int64)
    valid = np.ones((1, 4), bool)
    ranks = _both(parent, opid, valid)
    by_rank = [ACTORS[i] for i in np.argsort(ranks[0])]
    assert by_rank == ["dd", "cc", "bb", "aa"]


def test_invalid_slots_rank_last():
    rng = np.random.default_rng(7)
    parent, opid, valid = _forest(rng, 3, 32, ties=False)
    valid[:, 20:] = False  # a dead tail (the next insert overwrites it)
    parent[:, 25] = 3      # dead rows may hold stale links
    ranks = _both(parent, opid, valid)
    assert (ranks[:, 20:] == 32).all()


def test_element_limit_raises():
    big = np.zeros((1, rga.MAX_ELEMS + 1), np.int32)
    with pytest.raises(PackingLimitError):
        rga.batched_rga_rank(torch.from_numpy(big),
                             torch.zeros(1, big.shape[1], dtype=torch.int64),
                             torch.zeros(1, big.shape[1], dtype=torch.bool),
                             torch.from_numpy(RANK))

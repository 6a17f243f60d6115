"""Bloom kernels' plain versions (automerge_tpu_torch.tpu.bloom_kernels, the
path a CPU tensor takes) against the JAX package: its Pallas kernels in
interpret mode (as tests/test_pallas.py runs them) and its XLA twins in
sync_batch, on the same numpy-seeded inputs. Words, moduli and membership
bits must be identical (no tolerance). The CUDA kernels themselves run
only on the card: chip_smoke.py holds them against these plain versions."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu import sync as jsync
from automerge_tpu.tpu import sync_batch as jbatch
from automerge_tpu.tpu.pallas_kernels import bloom_build, bloom_query
from automerge_tpu_torch.tpu import bloom_kernels as bk
from automerge_tpu_torch.tpu import sync_batch as tbatch

# (batch, entries, num_words, candidates, counts): random shapes, the
# Pallas multi-tile grid, and the edge shapes — empty and one-entry
# filters, a word count that is not a multiple of 32, a candidate count
# that is not a power of two
CASES = {
    "small": (5, 12, 16, 9, [12, 7, 1, 0, 3]),
    "edge_counts_0_1": (4, 3, 1, 5, [0, 1, 0, 1]),
    "words_not_mult_32": (3, 64, 20, 33, [64, 40, 0]),
    "cands_not_pow2": (2, 30, 37, 45, [30, 29]),
    "multi_tile": (2, 293, 640, 275, [293, 243]),
}


def _inputs(case, seed=0):
    batch, entries, num_words, cands, counts = CASES[case]
    rng = np.random.default_rng(seed)
    xyz = rng.integers(0, 2**32, size=(batch, entries, 3), dtype=np.uint32)
    other = rng.integers(0, 2**32, size=(batch, cands, 3), dtype=np.uint32)
    # the first half of the candidates are members
    half = min(cands // 2, entries)
    query = other.copy()
    query[:, :half] = xyz[:, :half]
    return xyz, np.asarray(counts, np.int32), num_words, query


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_matches_pallas_and_xla(case):
    xyz, counts, num_words, _ = _inputs(case)
    words, modulo = bk.bloom_build(_t(xyz), _t(counts), num_words)
    got = words.numpy().view(np.uint32)
    p_words, p_mod = bloom_build(jnp.asarray(xyz), jnp.asarray(counts),
                                 num_words, interpret=True)
    x_words, x_mod = jbatch.build_filters(jnp.asarray(xyz),
                                          jnp.asarray(counts), num_words)
    np.testing.assert_array_equal(got, np.asarray(p_words))
    np.testing.assert_array_equal(got, np.asarray(x_words))
    np.testing.assert_array_equal(modulo.numpy(), np.asarray(p_mod))
    np.testing.assert_array_equal(modulo.numpy(), np.asarray(x_mod))


@pytest.mark.parametrize("case", sorted(CASES))
def test_query_matches_pallas_and_xla(case):
    xyz, counts, num_words, query = _inputs(case, seed=1)
    j_words, j_mod = jbatch.build_filters(jnp.asarray(xyz),
                                          jnp.asarray(counts), num_words)
    words = np.asarray(j_words)
    modulo = np.asarray(j_mod)
    got = bk.bloom_query(_t(words), _t(modulo), _t(counts), _t(query))
    want_p = bloom_query(j_words, j_mod, jnp.asarray(counts),
                         jnp.asarray(query), interpret=True)
    want_x = jbatch.query_filters(j_words, j_mod, jnp.asarray(counts),
                                  jnp.asarray(query))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_x))
    half = min(query.shape[1] // 2, xyz.shape[1])
    for b, count in enumerate(counts):
        assert got[b, : min(half, count)].all()  # members are always found


def _hashes(n, seed):
    return [hashlib.sha256(f"{seed}:{i}".encode()).hexdigest()
            for i in range(n)]


def test_ten_thousand_entry_filter_matches_wire_reference():
    """A 10,000-entry filter (3,125 words): serialised plain-version words
    equal the sequential BloomFilter's wire bytes, and queries equal the
    JAX XLA query (the one-hot build reference would need ~1 GB here)."""
    members = _hashes(10_000, "m")
    xyz, counts = tbatch.pack_hashes([members])
    num_words = 3125
    words, modulo = tbatch.build_filters(_t(xyz), _t(counts), num_words)
    blob = tbatch.filters_to_bytes(words, modulo, counts)[0]
    assert blob == jsync.BloomFilter(members).bytes
    cands = members[:500] + _hashes(501, "c")
    q, _ = tbatch.pack_hashes([cands])
    got = tbatch.query_filters(words, modulo, _t(counts), _t(q)).numpy()
    want = jbatch.query_filters(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(modulo.numpy()),
        jnp.asarray(counts), jnp.asarray(q),
    )
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0, :500].all()


@pytest.mark.parametrize("n", [0, 1, 7, 64])
def test_wire_bytes_and_packing_match_jax(n):
    hashes = _hashes(n, n)
    t_xyz, t_counts = tbatch.pack_hashes([hashes, hashes[: n // 2]], width=64)
    j_xyz, j_counts = jbatch.pack_hashes([hashes, hashes[: n // 2]], width=64)
    np.testing.assert_array_equal(t_xyz, np.asarray(j_xyz))
    np.testing.assert_array_equal(t_counts, np.asarray(j_counts))
    words, modulo = tbatch.build_filters(_t(t_xyz), _t(t_counts), 20)
    j_words, j_mod = jbatch.build_filters(j_xyz, j_counts, 20)
    assert tbatch.filters_to_bytes(words, modulo, t_counts) == \
        jbatch.filters_to_bytes(j_words, j_mod, j_counts)
    if n:
        assert tbatch.filters_to_bytes(words, modulo, t_counts)[0] == \
            jsync.BloomFilter(hashes).bytes


def test_cpu_path_never_counts_a_launch():
    bk.reset_launch_counts()
    xyz, counts, num_words, query = _inputs("small")
    words, modulo = bk.bloom_build(_t(xyz), _t(counts), num_words)
    bk.bloom_query(words, modulo, _t(counts), _t(query))
    assert bk.LAUNCHES == {"bloom_build": 0, "bloom_query": 0}

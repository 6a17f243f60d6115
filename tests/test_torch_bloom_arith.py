"""The Bloom kernels' integer arithmetic on the CPU: the plain versions
(automerge_tpu_torch.tpu.bloom_kernels, the path a CPU tensor takes)
against the JAX package where the modulo or the count is at an edge (bit
31 set, negative counts), and a NumPy mirror of the CUDA kernels' probe
arithmetic (Lemire's fast remainder, the conditional subtraction)
against the plain probes. The CUDA kernels themselves run only on the
card: chip_smoke.py holds them against the plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.tpu import sync_batch as jbatch
from automerge_tpu.tpu.pallas_kernels import bloom_build, bloom_query
from automerge_tpu_torch.sync import NUM_PROBES
from automerge_tpu_torch.tpu import bloom_kernels as bk


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("modulo", [-8, -2**31, 2**31 - 8])
def test_query_reads_modulo_as_uint32(modulo):
    """A modulo with bit 31 set is the uint32 value, as in the JAX package
    (sync_batch.py:73, pallas_kernels.py:90), not a negative number
    clamped to 1. 2**31 - 8 is the control below bit 31."""
    rng = np.random.default_rng(0)
    query = rng.integers(0, 2**32, size=(1, 8, 3), dtype=np.uint32)
    words = np.zeros((1, 4), np.uint32)
    words[0, 0] = 1
    mod = np.array([modulo], np.int32)
    counts = np.array([5], np.int32)
    got = bk.bloom_query(_t(words), _t(mod), _t(counts), _t(query)).numpy()
    args = (jnp.asarray(words), jnp.asarray(mod), jnp.asarray(counts),
            jnp.asarray(query))
    np.testing.assert_array_equal(got, np.asarray(jbatch.query_filters(*args)))
    np.testing.assert_array_equal(
        got, np.asarray(bloom_query(*args, interpret=True)))


def test_build_negative_counts_match_jax():
    """A negative count builds an empty row and the modulo JAX's ceil
    gives (8 * ceil(10 * count / 8), negative)."""
    rng = np.random.default_rng(3)
    xyz = rng.integers(0, 2**32, size=(4, 8, 3), dtype=np.uint32)
    counts = np.array([-1, 3, -9, -2**20], np.int32)
    words, modulo = bk.bloom_build(_t(xyz), _t(counts), 4)
    x_words, x_mod = jbatch.build_filters(jnp.asarray(xyz),
                                          jnp.asarray(counts), 4)
    p_words, p_mod = bloom_build(jnp.asarray(xyz), jnp.asarray(counts), 4,
                                 interpret=True)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(x_words))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(p_words))
    np.testing.assert_array_equal(modulo.numpy(), np.asarray(x_mod))
    np.testing.assert_array_equal(modulo.numpy(), np.asarray(p_mod))


_LOW32 = 0xFFFFFFFF


def _kernel_probes(xyz, m):
    """NumPy mirror of the CUDA kernels' probe arithmetic (csrc/bloom.cu:
    ``fast_mod_of<true>``, ``seed_mod<true>`` and ``probes``, the split
    build's path; the other kernels take the seeds with a plain ``%``).
    xyz [N, 3] uint32, m the modulo's uint32 value -> [NUM_PROBES, N]
    uint64.

    The three seed reductions use Lemire's remainder, ``a % m ==
    umulhi64(M * a mod 2^64, m)`` with ``M = (2^64 - 1) // m + 1`` (0 for
    m = 1); the 64x32-bit high product is taken on 32-bit limbs so that
    every uint64 product stays exact. The recurrence steps subtract m once
    when m <= 2^31 (x + y < 2^32 cannot wrap there) and otherwise take the
    uint32-wrapped sum modulo m."""
    m = max(m, 1)
    big_m = np.uint64(((1 << 64) - 1) // m + 1 & ((1 << 64) - 1))
    mm = np.uint64(m)

    def fast_mod(a):
        low = big_m * a  # mod 2^64
        hi, lo = low >> np.uint64(32), low & np.uint64(_LOW32)
        return (hi * mm + ((lo * mm) >> np.uint64(32))) >> np.uint64(32)

    h = xyz.astype(np.uint64)
    x, y, z = fast_mod(h[:, 0]), fast_mod(h[:, 1]), fast_mod(h[:, 2])
    out = [x]
    for _ in range(NUM_PROBES - 1):
        if m <= 2**31:
            s = (x + y) & np.uint64(_LOW32)
            t = (y + z) & np.uint64(_LOW32)
            x = np.where(s >= mm, s - mm, s)
            y = np.where(t >= mm, t - mm, t)
        else:
            x = ((x + y) & np.uint64(_LOW32)) % mm
            y = ((y + z) & np.uint64(_LOW32)) % mm
        out.append(x)
    return np.stack(out)


@pytest.mark.parametrize("modulo", [1, 8, 16, 88, 640, 100_000, 2**31 - 8,
                                    2**31, 2**31 + 8, 2**32 - 8])
def test_kernel_probe_arithmetic_matches_plain(modulo):
    """The kernels' fast remainder and conditional subtraction give the
    plain version's probe positions exactly, on both sides of 2^31."""
    xyz = np.random.default_rng(0).integers(0, 2**32, size=(10_000, 3),
                                            dtype=np.uint32)
    mod = torch.tensor([modulo], dtype=torch.int64).to(torch.int32)
    want = bk._probes(_t(xyz[None]), mod)[:, 0].numpy()
    got = _kernel_probes(xyz, modulo)
    np.testing.assert_array_equal(got.astype(np.int64), want)

"""Kernel 3 of the port on the CPU: the plain LEB128 segmented sum against
the JAX package's Pallas kernel (interpret mode), and the port's device
varint scan against the JAX device scan and the NumPy pass, exactly.
Inputs are made from numpy seeds; the CUDA kernel itself runs only on the
card (chip_smoke.py phases 5 and 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.codecs import Encoder
from automerge_tpu.tpu import decode as jdec
from automerge_tpu.tpu.pallas_kernels import leb128_segment_sum as pallas_segsum
from automerge_tpu_torch.tpu import decode as tdec
from automerge_tpu_torch.tpu import leb_kernels as lk

# (N, V, ids): the edge shapes chip_smoke.py phase 5 runs on the card
_CASES = [
    (1, 1, "sorted"),
    (13, 5, "sorted"),          # N and V not multiples of 8
    (37, 11, "out_of_range"),   # -1 and >= V ids
    (29, 7, "unsorted"),
    (1300, 300, "unsorted"),    # N > 512 and V > 128: crosses the TPU tiles
    (700, 130, "out_of_range"),
]


def _inputs(n, v, ids, seed):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 1 << 14, (n, 4)).astype(np.float32)
    seg = np.sort(rng.integers(0, v, n)).astype(np.int32)
    if ids == "unsorted":
        rng.shuffle(seg)
    elif ids == "out_of_range":
        bad = rng.random(n) < 0.3
        seg[bad] = rng.choice([-1, v, v + 3, 10 * v], int(bad.sum()))
    return planes, seg


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_plain_segment_sum_matches_pallas_interpret(case):
    n, v, ids = _CASES[case]
    planes, seg = _inputs(n, v, ids, seed=case)
    want = np.asarray(pallas_segsum(jnp.asarray(planes), jnp.asarray(seg), v,
                                    interpret=True))
    got = lk.leb128_segment_sum(torch.from_numpy(planes),
                                torch.from_numpy(seg), v)
    assert got.dtype == torch.float32 and tuple(got.shape) == (v, 4)
    assert np.array_equal(got.numpy(), want)


def test_cpu_path_never_counts_a_launch():
    lk.reset_launch_counts()
    planes, seg = _inputs(20, 6, "sorted", seed=1)
    lk.leb128_segment_sum(torch.from_numpy(planes), torch.from_numpy(seg), 6)
    assert lk.LAUNCHES == {"leb128_segment_sum": 0}


def _stream(seed, signed):
    """1- to 8-byte varints (and negative values when `signed`)."""
    rng = np.random.default_rng(seed)
    enc = Encoder()
    vals = []
    for k in range(400):
        bits = int(rng.integers(0, 53))
        v = int(rng.integers(0, 1 << bits)) if bits else 0
        if signed and k % 2:
            v = -v
        vals.append(v)
        if signed:
            enc.append_int53(v)
        else:
            enc.append_uint53(v)
    return np.frombuffer(enc.buffer, np.uint8), vals


def _check_scan(data):
    want = tdec.leb128_scan(data)
    jax_out = jdec.leb128_scan_device(data)
    got = tdec.leb128_scan_device(torch.from_numpy(data.copy()))
    for g, j, w in zip(got, jax_out, want):
        assert g.dtype == np.int64
        assert np.array_equal(g, np.asarray(j))
        assert np.array_equal(g, w)
    return got


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_matches_jax_device_scan_and_numpy(seed, signed):
    data, vals = _stream(seed, signed)
    starts, lengths, unsigned, signed_out = _check_scan(data)
    assert (signed_out if signed else unsigned).tolist() == vals
    assert set(lengths.tolist()) >= {1, 8}


def test_scan_of_empty_input():
    e = tdec.leb128_scan_device(torch.zeros(0, dtype=torch.uint8))
    assert all(a.shape == (0,) and a.dtype == np.int64 for a in e)
    j = jdec.leb128_scan_device(np.zeros(0, np.uint8))
    assert all(np.asarray(a).shape == (0,) for a in j)


def test_scan_fallbacks_match_jax():
    trailing = np.frombuffer(bytes([0x05, 0x80, 0x81]), np.uint8)
    wide = np.frombuffer(bytes([0x01] + [0x80] * 8 + [0x01]), np.uint8)
    for data in (trailing, wide):
        with pytest.raises(jdec._Fallback) as jerr:
            jdec.leb128_scan_device(data)
        with pytest.raises(tdec._Fallback) as terr:
            tdec.leb128_scan_device(torch.from_numpy(data.copy()))
        with pytest.raises(tdec._Fallback):
            tdec.leb128_scan(data)
        assert str(terr.value) == str(jerr.value)

"""The Hopper design of kernel 3 (``automerge_tpu_torch/csrc/leb128.cu``)
on the CPU: a NumPy mirror of its per-row algorithm (run heads, forward
run sums, gap zero-fill, the descending-pair flag and the guarded general
pass), held exactly against the JAX package's Pallas kernel in interpret
mode and against the port's plain version, at the edge cases the sorted
pass must get right. The CUDA kernels themselves run only on the card
(chip_smoke.py phases 5 and 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.codecs import Encoder
from automerge_tpu.tpu.pallas_kernels import leb128_segment_sum as pallas_segsum
from automerge_tpu_torch.tpu import leb_kernels as lk


def mirror(planes, seg, v):
    """The kernels' algorithm, one loop step per thread of the sorted pass
    (rows 0..N-1 and the virtual row N, whose id is V). Returns (out,
    flagged, writes): `writes[r]` counts the sorted pass's stores to
    output row r. The output starts as NaN, as torch.empty may. The
    kernel's block vote (a block in which any row sees a descending pair
    stores nothing) only skips stores that the general pass redoes, so
    the mirror leaves it out."""
    n, p = planes.shape
    out = np.full((v, p), np.nan, np.float32)
    writes = np.zeros(v, np.int64)

    def cid(j):  # clamped id; rows at or past N read as V
        if j >= n:
            return v
        return -1 if seg[j] < 0 else min(int(seg[j]), v)

    flagged = False
    for i in range(n + 1):
        c = cid(i)
        prev = -1 if i == 0 else cid(i - 1)
        if prev > c:  # a descending pair: the flag, and nothing else
            flagged = True
            continue
        if c == prev or c < 0:
            continue
        lo = 0 if prev < 0 else prev + 1
        out[lo:c] = 0.0
        writes[lo:c] += 1
        if c == v:
            continue
        acc = planes[i].copy()
        j = i + 1
        while cid(j) == c:
            acc += planes[j]
            j += 1
        out[c] = acc
        writes[c] += 1
    if flagged:  # the guarded general pass: zero, then add every row
        out[:] = 0.0
        keep = (seg >= 0) & (seg < v)
        np.add.at(out, seg[keep], planes[keep])
    return out, flagged, writes


def _stream_inputs(seed):
    """Planes and ids of a stream of 1- to 8-byte varints, computed as
    ``tpu/decode.leb128_scan_device`` computes them."""
    rng = np.random.default_rng(seed)
    enc = Encoder()
    for _ in range(400):
        bits = int(rng.integers(0, 53))
        enc.append_uint53(int(rng.integers(0, 1 << bits)) if bits else 0)
    data = np.frombuffer(enc.buffer, np.uint8).astype(np.int64)
    is_end = (data & 0x80) == 0
    seg = np.cumsum(is_end) - is_end
    ends = np.nonzero(is_end)[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    assert set((ends + 1 - starts).tolist()) >= {1, 8}
    pos = np.arange(len(data)) - starts[seg]
    contrib = (data & 0x7F) << (7 * pos)
    planes = np.stack([(contrib >> (14 * k)) & 0x3FFF for k in range(4)], 1)
    return planes.astype(np.float32), seg.astype(np.int32), int(seg[-1]) + 1


def _case(name, seed=0):
    """(planes, seg_ids, V, whether the general pass must run)."""
    rng = np.random.default_rng(seed)

    def planes(n, high=1 << 14):
        return rng.integers(0, high, (n, 4)).astype(np.float32)

    if name == "empty":
        return planes(0), np.zeros(0, np.int32), 5, False
    if name == "all_minus_one":
        return planes(40), np.full(40, -1, np.int32), 7, False
    if name == "all_at_or_above_v":
        seg = np.sort(rng.choice([7, 8, 70], 40)).astype(np.int32)
        return planes(40), seg, 7, False
    if name == "edges_and_gaps":
        mid = np.sort(rng.choice(np.arange(3, 190, 2), 120)).astype(np.int32)
        seg = np.concatenate([np.full(9, -1), mid, [200, 200, 203, 2000]])
        return planes(len(seg)), seg.astype(np.int32), 200, False
    if name == "dropped_runs_unordered":
        # descending inside the -1 prefix and the >= V suffix: both clamp
        # to one dropped run, so the ids still count as sorted
        seg = np.array([-1, -7, -2, 0, 0, 2, 5, 9, 6, 50, 6], np.int32)
        return planes(len(seg)), seg, 6, False
    if name == "one_long_run":
        n = 20_000  # 20,000 x 799 < 2^24
        seg = np.ones(n, np.int32)
        return planes(n, 800), seg, 3, False
    if name == "descending_first_pair":
        seg = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
        seg[0] = seg[1] + 1
        return planes(300), seg, 60, True
    if name == "descending_last_pair":
        seg = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
        seg[-1] = seg[-2] - 1
        return planes(300), seg, 50, True
    if name == "shuffled":
        seg = np.sort(rng.integers(0, 300, 1300)).astype(np.int32)
        rng.shuffle(seg)
        return planes(1300), seg, 300, True
    if name == "varint_stream":
        p, seg, v = _stream_inputs(seed)
        return p, seg, v, False
    raise ValueError(name)


_CASES = ["empty", "all_minus_one", "all_at_or_above_v", "edges_and_gaps",
          "dropped_runs_unordered", "one_long_run", "descending_first_pair",
          "descending_last_pair", "shuffled", "varint_stream"]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", _CASES)
def test_mirror_matches_pallas_interpret_and_plain(name):
    planes, seg, v, _ = _case(name)
    got, _, _ = mirror(planes, seg, v)
    want = np.asarray(pallas_segsum(jnp.asarray(planes), jnp.asarray(seg), v,
                                    interpret=True))
    plain = lk.leb128_segment_sum_plain(torch.from_numpy(planes),
                                        torch.from_numpy(seg), v).numpy()
    assert got.shape == want.shape == plain.shape == (v, 4)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(plain))


@pytest.mark.parametrize("name", _CASES)
def test_sorted_pass_tiles_the_output_once_or_flags(name):
    """Sorted ids (clamped) leave the flag clear and store every output
    row exactly once, with no other zeroing; a descending pair sets it."""
    planes, seg, v, general = _case(name)
    _, flagged, writes = mirror(planes, seg, v)
    assert flagged == general
    if not general:
        assert np.array_equal(writes, np.ones(v, np.int64))


@pytest.mark.parametrize("name", ["varint_stream", "shuffled", "empty"])
def test_wrapper_on_cpu_runs_the_plain_version(name):
    planes, seg, v, _ = _case(name, seed=3)
    lk.reset_launch_counts()
    out, path = lk.leb128_segment_sum_path(torch.from_numpy(planes),
                                           torch.from_numpy(seg), v)
    assert path == "plain" and lk.LAUNCHES["leb128_segment_sum"] == 0
    assert np.array_equal(_bits(out.numpy()), _bits(mirror(planes, seg, v)[0]))


def test_flag_generations_are_fresh_quiet_nan_patterns():
    gens = [lk._next_gen() for _ in range(3)]
    assert len(set(gens)) == 3
    for g in gens:
        assert 0x7FC00000 <= g <= 0x7FFFFFFF
        assert np.isnan(np.array([g], np.int32).view(np.float32)[0])

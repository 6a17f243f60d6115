"""The sync v2 fingerprint reduction and the farm's mixed-protocol sweep,
the port against the JAX package on the CPU: ``reduce_ranges`` bit for
bit against the JAX ``sync.fingerprint_ranges`` program on seeded words
(empty, full and padded spans, bit 31 set), the ``FingerprintIndex``
against the JAX index and the host ``HashIndex``, and a ``SyncFarm``
sweep that mixes v1 and v2 channels: equal messages and patches sweep by
sweep, and one reduction per generate call with v2 queries, as many as
the JAX observatory counts and the port's own observatory counts."""
import hashlib

import numpy as np
import pytest
import torch

from automerge_tpu.obs.prof import enabled_observatory, get_observatory
from automerge_tpu.tpu import fingerprint as jax_fingerprint
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu.tpu.sync_farm import SyncFarm as JaxSyncFarm
from automerge_tpu_torch import SyncFarm, TorchDocFarm
from automerge_tpu_torch import sync_v2 as V2
from automerge_tpu_torch.obs import prof as port_prof
from automerge_tpu_torch.tpu import fingerprint

import chip_smoke

MIN, MAX = V2.MIN_HASH, V2.MAX_HASH


def fake_hash(i) -> str:
    return hashlib.sha256(str(i).encode()).hexdigest()


# ---------------------------------------------------------------------- #
# the fingerprint reduction


def _reduction_inputs(batch, width, seed):
    """Seeded [B, E, 8] uint32 words (bit 31 set on about half), with row
    spans covering the cases: empty (start == end), the full row, padded
    rows (start == end == 0) and random spans."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(batch, width, 8), dtype=np.uint64)
    words = words.astype(np.uint32)
    starts = np.zeros(batch, np.int32)
    ends = np.zeros(batch, np.int32)
    for b in range(batch):
        kind = b % 4
        if kind == 0:
            starts[b] = ends[b] = rng.integers(0, width + 1)
        elif kind == 1:
            starts[b], ends[b] = 0, width
        elif kind == 2:
            continue  # padded row
        else:
            lo, hi = sorted(rng.integers(0, width + 1, size=2))
            starts[b], ends[b] = lo, hi
    return words, starts, ends


@pytest.mark.parametrize("batch,width,seed", [
    (1, 1, 0), (4, 8, 1), (16, 64, 2), (8, 256, 3), (32, 16, 4)])
def test_reduction_bit_identical_to_jax(batch, width, seed):
    words, starts, ends = _reduction_inputs(batch, width, seed)
    assert (words >> 31).any()
    want = np.asarray(jax_fingerprint.fingerprint_ranges_kernel(
        words, starts, ends))
    got = fingerprint.reduce_ranges(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(starts),
        torch.from_numpy(ends)).numpy().view(np.uint32)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not got[2::4].any()  # padded rows reduce to zero


def test_reduction_refuses_a_width_that_is_not_a_power_of_two():
    """A width that is not a power of two is not refused, as the JAX
    program refuses none: the entry axis pads to the next power of two
    inside ``reduce_ranges`` and the padding reduces to nothing."""
    words = torch.arange(24, dtype=torch.int32).reshape(1, 3, 8)
    got = fingerprint.reduce_ranges(words, torch.zeros(1, dtype=torch.int32),
                                    torch.full((1,), 3, dtype=torch.int32))
    assert torch.equal(got[0], words[0, 0] ^ words[0, 1] ^ words[0, 2])


@pytest.mark.parametrize("width", [1, 3, 6, 100, 1024])
def test_reduction_any_width_matches_jax(width):
    """Entry widths that are not powers of two reduce bit-identically to
    the JAX ``sync.fingerprint_ranges`` program; padded rows reduce to
    zero."""
    words, starts, ends = _reduction_inputs(12, width, 100 + width)
    want = np.asarray(jax_fingerprint.fingerprint_ranges_kernel(
        words, starts, ends))
    got = fingerprint.reduce_ranges(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(starts),
        torch.from_numpy(ends)).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert not got[2::4].any()


def test_index_matches_jax_index():
    a = sorted(fake_hash(f"a{i}") for i in range(40))
    b = sorted(fake_hash(f"b{i}") for i in range(9))
    port, jax = fingerprint.FingerprintIndex("cpu"), jax_fingerprint.FingerprintIndex()
    for index in (port, jax):
        index.sync_doc(0, a)
        index.sync_doc(1, b)
    queries = [(0, MIN, MAX), (1, MIN, MAX), (1, b[2], b[5]), (0, a[0], a[0]),
               (0, a[3], a[30]), (2, MIN, MAX)]
    assert port.fingerprint_ranges(queries) == jax.fingerprint_ranges(queries)
    assert port.fingerprint_ranges([]) == []
    assert port.dispatches == 1
    host = V2.HashIndex(a).fingerprint_many([(MIN, MAX), (a[3], a[30])])
    assert port.fingerprint_ranges([(0, MIN, MAX), (0, a[3], a[30])]) == host


# ---------------------------------------------------------------------- #
# SyncFarm: one sweep mixes v1 and v2 channels


def _farms(farm_cls, sync_cls, docs, replicas, **kw):
    server = farm_cls(docs, capacity=256, **kw)
    reps = [farm_cls(docs, capacity=256, **kw) for _ in range(replicas)]
    return [server, *reps], sync_cls(server), [sync_cls(f) for f in reps]


def _edit(farms, edits):
    out = []
    for farm, per_change in zip(farms, edits):
        for bufs in per_change:
            result = farm.apply_changes([[b] for b in bufs])
            out.append([chip_smoke.canon(p) for p in result])
    return out


@pytest.mark.parametrize("docs,replicas,v2_replicas,seed", [
    (3, 2, 1, 0), (4, 4, 2, 1), (2, 3, 3, 2)])
def test_mixed_protocol_farm_sweep_matches_jax(docs, replicas, v2_replicas,
                                               seed):
    edits = chip_smoke.make_edits(docs, replicas, 3, 5, seed)
    jfarms, jsync, jreps = _farms(TpuDocFarm, JaxSyncFarm, docs, replicas)
    pfarms, psync, preps = _farms(TorchDocFarm, SyncFarm, docs, replicas,
                                  device="cpu")
    want = _edit(jfarms[1:], edits)
    got = _edit(pfarms[1:], edits)
    assert got == want
    prog = get_observatory().programs()["sync.fingerprint_ranges"]
    with enabled_observatory():
        before = prog.dispatches
        jsweeps = chip_smoke.sync_until_quiet("cpu", jsync, jreps, docs,
                                              want.append, v2_replicas)
        jax_dispatches = prog.dispatches - before
    port_prog = port_prof.get_observatory().programs()[
        "sync.fingerprint_ranges"]
    with port_prof.enabled_observatory():
        before = port_prog.dispatches
        psweeps = chip_smoke.sync_until_quiet("cpu", psync, preps, docs,
                                              got.append, v2_replicas)
        port_dispatches = port_prog.dispatches - before
    assert got == want
    assert [(s.moved, s.v2_moved, s.bytes) for s in psweeps] == [
        (s.moved, s.v2_moved, s.bytes) for s in jsweeps]
    assert any(s.v2_moved for s in psweeps)
    dispatches = sum(s.fingerprints.dispatches for s in [psync, *preps])
    assert dispatches == jax_dispatches == port_dispatches > 0
    # at most one reduction per generate call: the server and each v2
    # replica generate once per sweep
    assert dispatches <= len(psweeps) * (1 + v2_replicas)
    assert chip_smoke.check_converged(pfarms, docs) == \
        chip_smoke.check_converged(jfarms, docs)

"""Batched Bloom filters, the port against the JAX package: twins of every
case of tests/test_sync_batch.py (filters bit-identical to the sequential
wire format, batched queries, the empty filter, ``batched_have_filters``
driving the sequential protocol), then the port's
``batched_have_filters`` byte-identical to the JAX function for 1, 3 and
64 backends, one of them empty. On the CPU the build and query wrappers
take their plain versions; on the card they launch kernels 1 and 2."""
import inspect
from hashlib import sha256
from math import ceil

import numpy as np
import pytest
import torch

import automerge_tpu_torch
from automerge_tpu.tpu import sync_batch as jax_sync_batch
from automerge_tpu_torch.tpu import sync_batch
from test_torch_faults_domain import Pkg, twin_pkgs


def fake_hashes(tag, n):
    return [sha256(f"{tag}-{i}".encode()).hexdigest() for i in range(n)]


def _filters(P, hash_lists):
    """(words, modulo, counts) through package P's build program; the
    port's takes int32 tensors holding the uint32 bits."""
    xyz, counts = P.sync_batch.pack_hashes(hash_lists)
    num_words = int(ceil(xyz.shape[1] * P.sync.BITS_PER_ENTRY / 32)) or 1
    if P.is_port:
        words, modulo = P.sync_batch.build_filters(
            torch.from_numpy(xyz.view(np.int32)), torch.from_numpy(counts),
            num_words)
    else:
        words, modulo = P.sync_batch.build_filters(xyz, counts, num_words)
    return words, modulo, counts


def _query(P, words, modulo, counts, queries):
    q_xyz, _ = P.sync_batch.pack_hashes(queries)
    if P.is_port:
        return P.sync_batch.query_filters(
            words, modulo, torch.from_numpy(counts),
            torch.from_numpy(q_xyz.view(np.int32))).numpy()
    return np.asarray(P.sync_batch.query_filters(words, modulo, counts, q_xyz))


def test_bit_identical_to_sequential(monkeypatch):
    def scenario(P, rec):
        hash_lists = [fake_hashes("a", 5), fake_hashes("b", 17), [],
                      fake_hashes("c", 1)]
        wire = P.sync_batch.filters_to_bytes(*_filters(P, hash_lists))
        for hashes, bloom_bytes in zip(hash_lists, wire):
            assert bloom_bytes == P.sync.BloomFilter(hashes).bytes
        rec.value([bytes(b) for b in wire])

    twin_pkgs(scenario, monkeypatch)


def test_batched_query_matches_sequential(monkeypatch):
    def scenario(P, rec):
        hash_lists = [fake_hashes("x", 20), fake_hashes("y", 8)]
        queries = [fake_hashes("x", 30), fake_hashes("y", 30)]
        contained = _query(P, *_filters(P, hash_lists), queries)
        for b, (hashes, qs) in enumerate(zip(hash_lists, queries)):
            bloom = P.sync.BloomFilter(hashes)
            for c, q in enumerate(qs):
                assert bool(contained[b, c]) == bloom.contains_hash(q), (b, c)
        rec.value(contained.tolist())

    twin_pkgs(scenario, monkeypatch)


def test_empty_filter_contains_nothing(monkeypatch):
    def scenario(P, rec):
        words, modulo, counts = _filters(P, [[]])
        contained = _query(P, words, modulo, counts, [fake_hashes("q", 3)])
        assert not contained.any()
        rec.value(contained.tolist())

    twin_pkgs(scenario, monkeypatch)


def test_batched_have_interoperates_with_protocol(monkeypatch):
    def scenario(P, rec):
        am = P.am
        docs = []
        for i in range(3):
            doc = am.init(f"{i:08d}" if i else "aaaaaaaa")
            for j in range(4):
                doc = am.change(doc, lambda d, j=j: d.__setitem__(f"k{j}", j))
            docs.append(doc)
        backends = [am.Frontend.get_backend_state(doc, "test") for doc in docs]
        haves = P.sync_batch.batched_have_filters(backends, [[], [], []],
                                                  **P.cpu)
        for backend, have in zip(backends, haves):
            assert P.sync.get_changes_to_send(backend, [have], []) == []
        rec.value(haves)

    twin_pkgs(scenario, monkeypatch)


# ---------------------------------------------------------------------- #
# batched_have_filters: the port's against the JAX function


def _backends(P, num, seed):
    """`num` single-document backends from seeded edits; every fifth one
    (and the last of a batch larger than one) stays empty. Returns
    (backends, last_syncs): each last sync is the heads after the first
    of a doc's changes, or [] when it has none."""
    am = P.am
    rng = np.random.default_rng(seed)
    backends, last_syncs = [], []
    for i in range(num):
        backend = P.backend.init()
        first_heads = []
        if i % 5 != 4 and not (num > 1 and i == num - 1):
            doc = am.init(f"{i + 1:08x}")
            for c in range(int(rng.integers(1, 5))):
                doc = am.change(doc, lambda d, c=c: d.__setitem__(
                    f"k{c}", int(rng.integers(1000))))
                if c == 0:
                    first_heads = P.backend.get_heads(
                        am.Frontend.get_backend_state(doc, "test"))
            backend = am.Frontend.get_backend_state(doc, "test")
        backends.append(backend)
        last_syncs.append(first_heads if i % 2 else [])
    return backends, last_syncs


@pytest.mark.parametrize("num", [1, 3, 64])
def test_have_filters_byte_identical_to_jax(num, monkeypatch):
    def scenario(P, rec):
        backends, last_syncs = _backends(P, num, seed=num)
        haves = P.sync_batch.batched_have_filters(backends, last_syncs,
                                                  **P.cpu)
        assert [h["lastSync"] for h in haves] == last_syncs
        assert any(h["bloom"] == b"" for h in haves) == (num > 1)
        for backend, have in zip(backends, haves):
            hashes = [P.columnar.decode_change_meta_cached(c)["hash"]
                      for c in P.backend.get_changes(backend,
                                                     have["lastSync"])]
            assert have["bloom"] == P.sync.BloomFilter(hashes).bytes
        rec.value(haves)

    record = twin_pkgs(scenario, monkeypatch)
    assert len(record) == 1 and len(record[0][1]) == num


def test_have_filters_run_on_the_card_by_default():
    """The port's entry point defaults to ``device="cuda"`` and raises
    without CUDA (no CPU stand-in); it is exported as JAX's is."""
    assert inspect.signature(
        sync_batch.batched_have_filters).parameters["device"].default == "cuda"
    assert "batched_have_filters" in sync_batch.__all__
    assert list(inspect.signature(jax_sync_batch.batched_have_filters)
                .parameters) == ["backends", "last_syncs"]
    backends, last_syncs = _backends(Pkg(automerge_tpu_torch), 2, seed=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sync_batch.batched_have_filters(backends, last_syncs)

"""Batched sync-protocol helpers: Bloom filter construction and querying for
thousands of (document, peer) pairs on the card.

PyTorch counterpart of the JAX package's ``tpu/sync_batch.py``. The wire
format is unchanged from the single-document protocol (sync.py, reference
backend/sync.js): 10 bits/entry, 7 probes, triple hashing from the first 12
bytes of each SHA-256 change hash (sync.js:88). A replica farm syncing B
documents evaluates all filters in one kernel launch
(``bloom_kernels.bloom_build`` / ``bloom_query``) instead of B loops.

Filters are padded to a common word capacity; each filter's true bit count
(``modulo`` = 8 * ceil(entries * 10 / 8)) rides along as data. Hash words
are uint32 bit patterns carried in int32 tensors (bloom_kernels.py).
"""
from __future__ import annotations

from math import ceil

import numpy as np
import torch

from ..codecs import Encoder, hex_to_bytes
from ..obs.metrics import get_metrics
from ..obs.prof import get_observatory
from ..sync import BITS_PER_ENTRY, NUM_PROBES
from .bloom_kernels import WORD_BITS, bloom_build, bloom_query, filter_modulo

__all__ = [
    "WORD_BITS", "batched_have_filters", "build_filters", "filter_modulo",
    "filters_to_bytes", "hash_to_xyz", "pack_hashes", "query_filters",
]

_M_FILTERS_BUILT = get_metrics().counter(
    "sync.filters.built", "Bloom filters built on device and serialised"
)
_M_FILTER_BYTES = get_metrics().counter(
    "sync.filters.bytes", "wire bytes of serialised device-built filters"
)


def hash_to_xyz(hash_hex: str) -> tuple[int, int, int]:
    """First 12 bytes of the hash as three little-endian uint32s."""
    data = hex_to_bytes(hash_hex)
    return (
        int.from_bytes(data[0:4], "little"),
        int.from_bytes(data[4:8], "little"),
        int.from_bytes(data[8:12], "little"),
    )


def pack_hashes(hash_lists, width=None):
    """Packs per-filter hash lists into a [B, E, 3] uint32 xyz array plus a
    [B] int32 count vector (host numpy). Padded entries are zero and
    masked by the count."""
    batch = len(hash_lists)
    width = width or max((len(h) for h in hash_lists), default=1) or 1
    xyz = np.zeros((batch, width, 3), np.uint32)
    counts = np.zeros((batch,), np.int32)
    for b, hashes in enumerate(hash_lists):
        counts[b] = len(hashes)
        if hashes:
            raw = b"".join(hex_to_bytes(h)[:12] for h in hashes)
            xyz[b, : len(hashes)] = np.frombuffer(raw, "<u4").reshape(-1, 3)
    return xyz, counts


#: The JAX package's filter programs are the CUDA kernels here: each JAX
#: name is bound to the kernel wrapper's own program, so a launch is
#: counted and bucketed once (tpu/jitprof.py's roster). ``build_filters``
#: builds B Bloom filters at once (xyz [B, E, 3] int32 bits, counts [B]
#: int32 -> words [B, W] int32 bits, modulo [B] int32); ``query_filters``
#: tests C candidate hashes against each of B filters in one launch
#: (query_xyz [B, C, 3] int32 bits -> [B, C] bool, False for empty filters,
#: matching BloomFilter.contains_hash on zero entries).
build_filters = get_observatory().alias("sync.build_filters", bloom_build)
query_filters = get_observatory().alias("sync.query_filters", bloom_query)


def filters_to_bytes(words, modulo, counts):
    """Serialises filters into the reference wire format (sync.js:68:
    numEntries, bitsPerEntry, numProbes, bits). Accepts tensors or numpy
    arrays; word rows are written as little-endian uint32."""
    words = np.ascontiguousarray(_host(words))
    if words.dtype == np.int32:
        words = words.view(np.uint32)  # the int32 carrier's uint32 bits
    words = words.astype("<u4", copy=False)
    modulo = np.asarray(_host(modulo))
    counts = np.asarray(_host(counts))
    out = []
    for b in range(words.shape[0]):
        if counts[b] == 0:
            out.append(b"")
            continue
        encoder = Encoder()
        encoder.append_uint32(int(counts[b]))
        encoder.append_uint32(BITS_PER_ENTRY)
        encoder.append_uint32(NUM_PROBES)
        num_bytes = int(modulo[b]) // 8
        encoder.append_raw_bytes(words[b].tobytes()[:num_bytes])
        out.append(encoder.buffer)
    if _M_FILTERS_BUILT.enabled:
        _M_FILTERS_BUILT.inc(sum(1 for blob in out if blob))
        _M_FILTER_BYTES.inc(sum(len(blob) for blob in out))
    return out


def batched_have_filters(backends, last_syncs, device="cuda"):
    """Builds the `have` Bloom filters for a batch of
    single-document backends in one launch of the build kernel (the batched
    analogue of makeBloomFilter, sync.js:234). Returns one
    ``{"lastSync", "bloom"}`` dict per backend. Runs on the card unless
    ``device="cpu"``, and raises when CUDA is absent."""
    from .. import backend as Backend
    from ..columnar import decode_change_meta_cached
    from .engine import _require_device

    device = _require_device(device, "batched_have_filters")
    hash_lists = []
    for backend, last_sync in zip(backends, last_syncs):
        changes = Backend.get_changes(backend, list(last_sync))
        hash_lists.append([decode_change_meta_cached(c)["hash"] for c in changes])
    xyz, counts = pack_hashes(hash_lists)
    num_words = int(ceil(xyz.shape[1] * BITS_PER_ENTRY / WORD_BITS)) or 1
    words, modulo = build_filters(
        torch.from_numpy(xyz.view(np.int32)).to(device),
        torch.from_numpy(counts).to(device), num_words,
    )
    blooms = filters_to_bytes(words, modulo, counts)
    return [
        {"lastSync": list(last_sync), "bloom": bloom}
        for last_sync, bloom in zip(last_syncs, blooms)
    ]


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a

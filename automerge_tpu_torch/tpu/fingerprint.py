"""Range-fingerprint index for sync v2: batched XOR reductions on the device.

PyTorch counterpart of the JAX package's ``tpu/fingerprint.py``. The v2
reconciliation driver (sync_v2.py) compares change-hash sets range by
range using XOR-of-hash fingerprints. Per document the arithmetic is
trivial; what the farm needs is the batch shape: a serving sweep holds
hundreds of live v2 channels, and every channel's fingerprint queries for
the round — inbound-range checks, median splits, fresh probes — resolve
as ONE device reduction, not one per channel.

``FingerprintIndex`` keeps one sorted hash array per document on the host
(extended incrementally, reconciled against the farm's change graph) and
packs the queried documents into a pow2-bucketed ``[B, E, 8]`` tensor of
hash words; ``reduce_ranges`` masks each row to its [start, end) span and
XOR-folds the entry axis. Counts come from host-side bisection (index
arithmetic, not data reduction).

The reduction is plain PyTorch, not a hand-written kernel: in the JAX
package it is an XLA program (``jax.lax.reduce`` with ``bitwise_xor``),
not a Pallas kernel. Hash words ride ``int32`` tensors holding the uint32
bits (PyTorch on the CPU has no usable ``uint32``; XOR does not care about
sign) and are read back as uint32.

Fingerprints are canonical: XOR over 256-bit hash integers, returned as
64-char hex, bit-identical to the host ``HashIndex`` prefix-XOR path and
to the JAX package's reduction.
"""
from __future__ import annotations

from bisect import bisect_left, insort

import numpy as np
import torch

from ..columnar import decode_change_meta_cached
from ..errors import SyncProtocolError
from ..sync import HASH_SIZE

#: one SHA-256 hash as big-endian uint32 words
HASH_WORDS = HASH_SIZE // 4


def _pow2(n: int) -> int:
    """Smallest power of two >= n (min 1): the shape-bucket grid for the
    batched reduction, kept from the JAX package (where every distinct
    shape is a compile) so both upload the same shapes."""
    return 1 << (max(n, 1) - 1).bit_length()


def reduce_ranges(words, starts, ends):
    """XOR-reduces each row's [start, end) span: words [B, E, 8] int32
    (uint32 bit patterns, E a power of two), starts/ends [B] int32 ->
    [B, 8] int32. Padded rows (start == end == 0) reduce to zero. Torch
    has no XOR reduction, so the masked entry axis folds in halves,
    log2(E) steps."""
    width = words.shape[1]
    if width & (width - 1):
        raise ValueError(f"entry axis {width} is not a power of two")
    idx = torch.arange(width, dtype=torch.int32, device=words.device)[None, :]
    mask = (idx >= starts[:, None]) & (idx < ends[:, None])
    folded = words.masked_fill(~mask[:, :, None], 0)
    while folded.shape[1] > 1:
        half = folded.shape[1] // 2
        folded = folded[:, :half] ^ folded[:, half:]
    return folded[:, 0]


def _hash_words(h: str) -> list[int]:
    return [int(h[8 * k: 8 * k + 8], 16) for k in range(HASH_WORDS)]


class _DocIndex:
    """One document's sorted hash array plus its packed host words."""

    __slots__ = ("hashes", "members", "words", "dirty")

    def __init__(self):
        self.hashes: list[str] = []
        self.members: set[str] = set()
        self.words: np.ndarray | None = None
        self.dirty = True

    def insert(self, h: str) -> bool:
        if h in self.members:
            return False
        if len(h) != 2 * HASH_SIZE:
            raise SyncProtocolError(f"not a 256-bit hash: {h!r}")
        self.members.add(h)
        insort(self.hashes, h)
        self.dirty = True
        return True

    def packed(self, width: int) -> np.ndarray:
        if self.dirty or self.words is None or self.words.shape[0] < width:
            words = np.zeros((width, HASH_WORDS), np.uint32)
            for e, h in enumerate(self.hashes):
                words[e] = _hash_words(h)
            self.words = words
            self.dirty = False
        return self.words[:width]


class _DocView:
    """Host-side set view of one document (the ``view`` protocol the v2
    driver's plan/receive phases consume: count/items/contains plus
    incremental insert)."""

    __slots__ = ("_doc",)

    def __init__(self, doc: _DocIndex):
        self._doc = doc

    def __len__(self) -> int:
        return len(self._doc.hashes)

    def contains(self, h: str) -> bool:
        return h in self._doc.members

    def insert_many(self, hashes) -> None:
        for h in hashes:
            self._doc.insert(h)

    def count(self, lo: str, hi: str) -> int:
        hashes = self._doc.hashes
        return bisect_left(hashes, hi) - bisect_left(hashes, lo)

    def items(self, lo: str, hi: str) -> list[str]:
        hashes = self._doc.hashes
        return hashes[bisect_left(hashes, lo):bisect_left(hashes, hi)]


class FingerprintIndex:
    """Per-document range-fingerprint indexes with batched resolution on
    `device` (the card unless the caller asks for the CPU).

    Lifecycle: ``note_commit`` extends a document's set incrementally;
    ``sync_doc`` reconciles against an authoritative hash list (cheap
    no-op when counts agree — change sets only grow). ``dispatches``
    counts the reductions run (one per ``fingerprint_ranges`` call with
    queries)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._docs: dict[int, _DocIndex] = {}
        self.dispatches = 0

    def _doc(self, d: int) -> _DocIndex:
        doc = self._docs.get(d)
        if doc is None:
            doc = self._docs[d] = _DocIndex()
        return doc

    def view(self, d: int) -> _DocView:
        return _DocView(self._doc(d))

    def note_commit(self, d: int, hashes) -> None:
        """Incremental update: the hashes of changes just committed."""
        doc = self._doc(d)
        for h in hashes:
            doc.insert(h)

    def sync_doc(self, d: int, hashes) -> None:
        """Reconciles document ``d`` against an authoritative hash list."""
        doc = self._doc(d)
        if len(hashes) != len(doc.hashes):
            for h in hashes:
                doc.insert(h)

    def sync_from_farm(self, farm, d: int) -> None:
        """Refreshes document ``d`` from a TorchDocFarm's change graph."""
        self.sync_doc(d, [
            decode_change_meta_cached(c)["hash"]
            for c in farm.get_changes(d, [])
        ])

    def rebuild_from_store(self, store) -> None:
        """Re-hydrates from the store's hash graph (``ShardStore``'s per-doc
        footer hash lists) — the restart path: the store already proved
        these hashes against its checksummed segments."""
        for d, hashes in store.footer_hashes.items():
            self.sync_doc(int(d), hashes)

    # -------------------------------------------------------------- #

    def fingerprint_ranges(self, queries) -> list[tuple[int, str]]:
        """Resolves [(doc, lo, hi)] -> [(count, xor_hex)] in query order.

        All queries reduce in one pow2-bucketed device reduction: the
        batch axis is the query list (a document's words repeat once per
        query), the entry axis is the largest queried document padded to
        a power of two. An empty query list dispatches nothing."""
        if not queries:
            return []
        spans = []
        for d, lo, hi in queries:
            doc = self._doc(d)
            i = bisect_left(doc.hashes, lo)
            j = bisect_left(doc.hashes, hi)
            spans.append((doc, i, j))
        width = _pow2(max((len(doc.hashes) for doc, _, _ in spans), default=1))
        batch = _pow2(len(queries))
        words = np.zeros((batch, width, HASH_WORDS), np.uint32)
        starts = np.zeros(batch, np.int32)
        ends = np.zeros(batch, np.int32)
        for b, (doc, i, j) in enumerate(spans):
            words[b] = doc.packed(width)
            starts[b] = i
            ends[b] = j
        dev = self.device
        fp_words = reduce_ranges(
            torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(starts).to(dev), torch.from_numpy(ends).to(dev),
        ).cpu().numpy().view(np.uint32)
        self.dispatches += 1
        out = []
        for b, (_doc, i, j) in enumerate(spans):
            fp = "".join(format(int(w), "08x") for w in fp_words[b])
            out.append((j - i, fp))
        return out

"""Batched peer-wise sync for a farm of documents.

PyTorch counterpart of the JAX package's ``tpu/sync_farm.py`` (Bloom
protocol v1), over a ``TorchDocFarm``.

`SyncFarm` runs the reference sync protocol (backend/sync.js, wire format
unchanged — see sync.py) for many (document, peer) channels at once:

- `generate_messages` builds every channel's `have` Bloom filter in ONE
  kernel launch (sync_batch.build_filters) and evaluates every channel's
  changes-to-send Bloom queries in ONE kernel launch
  (sync_batch.query_filters) — the batched analogue of makeBloomFilter
  (sync.js:234) and getChangesToSend's containsHash loop (sync.js:246-289).
- `receive_messages` decodes the messages, applies all channels' changes
  through the farm's single batched applyChanges, and advances per-channel
  sharedHeads exactly like receiveSyncMessage (sync.js:420).

Channels negotiated onto sync v2 (range-based reconciliation, sync_v2.py)
ride the same batched calls via the ``protocols`` parameter: every v2
channel's fingerprint queries for the round — inbound-range checks, median
splits, fresh probes — concatenate into ONE device reduction
(tpu/fingerprint.FingerprintIndex), and inbound payloads route on their
leading type byte, so one sweep mixes v1 and v2 channels freely.

Messages are byte-identical to the sequential protocol's (asserted by
the JAX package's tests against its sequential protocol, and this
package's tests against the JAX SyncFarm), so a farm can sync against any
reference-compatible peer.

Hash-graph traversals (changes since lastSync, dependents closure) stay on
the host: the graphs are tiny per document and pointer-chasing shaped. The
device does the bit-parallel work: B filters built and B x C candidate
probes evaluated per call.
"""
from __future__ import annotations

from math import ceil

import numpy as np
import torch

from ..columnar import decode_change_meta_cached
from ..errors import SyncProtocolError
from ..obs.metrics import get_metrics
from ..sync import (
    BITS_PER_ENTRY,
    NUM_PROBES,
    BloomFilter,
    decode_sync_message,
    encode_sync_message,
    init_sync_state,
    _advance_heads,
)
from ..sync_v2 import (
    MESSAGE_TYPE_SYNC_V2,
    decode_sync_message_v2,
    finish_generate_v2,
    plan_generate_v2,
    post_receive_v2,
)
from .fingerprint import FingerprintIndex
from .sync_batch import (
    WORD_BITS,
    build_filters,
    filters_to_bytes,
    pack_hashes,
    query_filters,
)

# Batched sync records into the SAME named instruments as the sequential
# protocol (sync.py): one set of totals whichever path runs. The device
# query kernel evaluates all NUM_PROBES bits per candidate (no early
# exit), so its probe count is candidates x NUM_PROBES.
_METRICS = get_metrics()
_M_MSGS_GEN = _METRICS.counter("sync.messages.generated")
_M_MSGS_RECV = _METRICS.counter("sync.messages.received")
_M_BYTES_SENT = _METRICS.counter("sync.bytes.sent")
_M_BYTES_RECV = _METRICS.counter("sync.bytes.received")
_M_CHANGES_SENT = _METRICS.counter("sync.changes.sent")
_M_CHANGES_RECV = _METRICS.counter("sync.changes.received")
_M_NEED_REQUESTED = _METRICS.counter("sync.changes.need_requested")
_M_BLOOM_PROBES = _METRICS.counter("sync.bloom.probes")
_M_BLOOM_HITS = _METRICS.counter("sync.bloom.hits")
_M_BLOOM_FP = _METRICS.counter("sync.bloom.false_positives")
_M_REJECTED = _METRICS.counter("sync.messages.rejected")
_M2_MSGS_RECV = _METRICS.counter("sync.v2.messages.received")
_M2_REJECTED = _METRICS.counter("sync.v2.messages.rejected")
_M_SHED_QUARANTINED = _METRICS.counter(
    "sync.messages.shed_quarantined",
    "sync channels skipped in generate_messages because the doc farm has "
    "their document quarantined (release_quarantine restores them)",
)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (min 1): the shape-bucket grid for the
    batched filter kernels, kept from the JAX package (where every
    distinct shape is a compile) so both sync farms pad identically."""
    return 1 << (max(n, 1) - 1).bit_length()


def filters_from_bytes(blobs):
    """Parses wire-format Bloom filters into padded host arrays:
    (words [B, W] uint32, modulo [B] int32, counts [B] int32). Inverse of
    filters_to_bytes for same-parameter filters; a zero-entry filter maps
    to an all-zero row with count 0. The device query kernel hardcodes the
    default probe count, so filters with other wire parameters must take
    the host path (see _plan_generate) — passing one here is an error."""
    parsed = [BloomFilter(b) for b in blobs]
    for p in parsed:
        if p.num_entries and (
            p.num_probes != NUM_PROBES or p.num_bits_per_entry != BITS_PER_ENTRY
        ):
            raise SyncProtocolError(
                "non-default Bloom parameters require the host BloomFilter path"
            )
    num_words = max(
        (ceil(len(p.bits) / 4) for p in parsed if p.num_entries), default=1
    ) or 1
    words = np.zeros((len(parsed), num_words), np.uint32)
    modulo = np.zeros(len(parsed), np.int32)
    counts = np.zeros(len(parsed), np.int32)
    for i, p in enumerate(parsed):
        if p.num_entries == 0:
            continue
        bits = bytes(p.bits)
        padded = bits + b"\0" * (-len(bits) % 4)
        row = np.frombuffer(padded, np.uint32)
        words[i, : row.shape[0]] = row
        modulo[i] = 8 * len(p.bits)
        counts[i] = p.num_entries
    return words, modulo, counts


class SyncFarm:
    """Batched sync over a TorchDocFarm. Channels are (doc index,
    sync_state dict) pairs; sync_state is the reference's shape
    (initSyncState, sync.js:308) and remains encode/decode-compatible."""

    def __init__(self, farm):
        self.farm = farm
        self.device = farm.engine.device
        # outcome report of the most recent receive_messages farm dispatch
        # (a FarmApplyResult, or None when the call applied no changes)
        self.last_apply = None
        # per-doc range-fingerprint indexes for v2 channels, refreshed
        # lazily from the farm's change graph (cheap count-compare no-op
        # once current)
        self.fingerprints = FingerprintIndex(self.device)

    def _v2_view(self, d):
        """The doc's fingerprint view, refreshed against the farm."""
        self.fingerprints.sync_from_farm(self.farm, d)
        return self.fingerprints.view(d)

    @staticmethod
    def init_state():
        return init_sync_state()

    def make_session(self, d, *, clock=None, rng=None, config=None,
                     state=None):
        """A supervised ``SyncSession`` (sync_session.py) for document
        ``d``'s channel to one peer: seq/ack framing, retransmission with
        backoff, peer-restart detection and the convergence watchdog, over
        this farm's batched generate/receive."""
        from ..sync_session import FarmDriver, SyncSession

        return SyncSession(FarmDriver(self, d), clock=clock, rng=rng,
                           config=config, state=state)

    def restore_session(self, d, blob, *, clock=None, rng=None, config=None):
        """Resumes a persisted supervised channel (``SyncSession.save()``)
        for document ``d``."""
        from ..sync_session import FarmDriver, SyncSession

        return SyncSession.restore(blob, FarmDriver(self, d), clock=clock,
                                   rng=rng, config=config)

    # -------------------------------------------------------------- #
    # generate (sync.js:327, batched)

    def _changes_since(self, d, since_hashes):
        changes = self.farm.get_changes(d, list(since_hashes))
        return [decode_change_meta_cached(c) for c in changes]

    def generate_messages(self, channels, protocols=None):
        """channels: [(doc, sync_state)]. Returns [(new_state, bytes|None)]
        in channel order. All Bloom builds and queries run as one kernel
        launch each; all v2 channels' fingerprint queries run as ONE
        batched reduction.

        ``protocols``, when given, aligns with ``channels``: an entry of
        ``"v2"`` routes that channel through range-based reconciliation
        (sync_v2), anything else through the Bloom protocol. One sweep
        mixes both freely."""
        n = len(channels)
        plans = []
        v2_queries = []  # (doc, lo, hi) across all v2 channels this sweep
        # a doc quarantined by the farm's per-doc isolation must not be
        # offered over sync: its host state is the pre-fault snapshot, so
        # advertising heads/filters from it would invite deliveries the
        # farm will shed anyway. The channel resumes after
        # release_quarantine.
        quarantined = self.farm.quarantine
        for i, (d, state) in enumerate(channels):
            if d in quarantined:
                plans.append({"shed": True})
                _M_SHED_QUARANTINED.inc()
                continue
            if protocols is not None and protocols[i] == "v2":
                view = self._v2_view(d)
                our_heads = self.farm.get_heads(d)
                our_need = self.farm.get_missing_deps(
                    d, state.get("theirHeads") or []
                )
                v2_plan, queries = plan_generate_v2(state, view, our_heads)
                plans.append({
                    "v2": True, "plan": v2_plan, "q0": len(v2_queries),
                    "nq": len(queries), "our_heads": our_heads,
                    "our_need": our_need,
                })
                v2_queries.extend((d, lo, hi) for lo, hi in queries)
                continue
            plans.append(self._plan_generate(d, state))

        # all v2 channels' fingerprints — inbound-range checks, median
        # splits, fresh probes — resolve in one pow2-bucketed device
        # reduction; each channel then slices its contiguous span back out
        v2_fps = self.fingerprints.fingerprint_ranges(v2_queries)

        # batched `have` filter construction, pow2-padded in batch and
        # width (the padding is masked: zero-count rows serialise to empty
        # filters)
        build_idx = [i for i, p in enumerate(plans) if p.get("build_hashes") is not None]
        if build_idx:
            lists = [plans[i]["build_hashes"] for i in build_idx]
            width = _pow2(max((len(h) for h in lists), default=1))
            xyz, counts = pack_hashes(lists, width=width)
            pad = _pow2(len(lists)) - len(lists)
            if pad:
                xyz = np.concatenate(
                    [xyz, np.zeros((pad,) + xyz.shape[1:], xyz.dtype)]
                )
                counts = np.concatenate([counts, np.zeros(pad, counts.dtype)])
            num_words = int(ceil(width * BITS_PER_ENTRY / WORD_BITS)) or 1
            words, modulo = build_filters(
                self._put(xyz.view(np.int32)), self._put(counts), num_words
            )
            blooms = filters_to_bytes(words, modulo, counts)
            for i, bloom in zip(build_idx, blooms):
                plans[i]["our_have"] = [
                    {"lastSync": plans[i]["shared_heads"], "bloom": bloom}
                ]

        # batched changes-to-send Bloom queries: flatten every channel's
        # (their-filter, candidate-hash) pairs into one [B, C] query
        query_idx = [i for i, p in enumerate(plans) if p.get("query") is not None]
        if query_idx:
            blobs, cand_lists = [], []
            for i in query_idx:
                blobs.append(plans[i]["query"]["bloom"])
                cand_lists.append(plans[i]["query"]["hashes"])
            words, modulo, counts = filters_from_bytes(blobs)
            # pow2 shape buckets (batch, candidate width, filter words):
            # padded rows/slots are masked by counts and never read back
            batch = _pow2(len(blobs))
            width = _pow2(max((len(c) for c in cand_lists), default=1))
            w_words = _pow2(words.shape[1])
            padded_words = np.zeros((batch, w_words), words.dtype)
            padded_words[: words.shape[0], : words.shape[1]] = words
            padded_modulo = np.zeros(batch, modulo.dtype)
            padded_modulo[: modulo.shape[0]] = modulo
            padded_counts = np.zeros(batch, counts.dtype)
            padded_counts[: counts.shape[0]] = counts
            q, _ = pack_hashes(cand_lists, width=width)
            q = np.concatenate(
                [q, np.zeros((batch - q.shape[0],) + q.shape[1:], q.dtype)]
            )
            contained = query_filters(
                self._put(padded_words.view(np.int32)),
                self._put(padded_modulo), self._put(padded_counts),
                self._put(q.view(np.int32)),
            ).cpu().numpy()
            total_hits = 0
            for b, i in enumerate(query_idx):
                hits = {
                    h
                    for c, h in enumerate(cand_lists[b])
                    if contained[b, c]
                }
                total_hits += len(hits)
                plans[i]["bloom_positive"] = hits
            if _METRICS.enabled:
                _M_BLOOM_PROBES.inc(
                    NUM_PROBES * sum(len(c) for c in cand_lists)
                )
                _M_BLOOM_HITS.inc(total_hits)

        results = []
        for (d, state), plan in zip(channels, plans):
            if plan.get("v2"):
                fps = v2_fps[plan["q0"]: plan["q0"] + plan["nq"]]
                results.append(finish_generate_v2(
                    state, plan["plan"], fps,
                    lambda h, d=d: self.farm.get_change_by_hash(d, h),
                    plan["our_heads"], plan["our_need"],
                ))
                continue
            results.append(self._finish_generate(d, state, plan))
        assert len(results) == n
        return results

    def _put(self, array):
        """A host array as a tensor on the farm's device."""
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _plan_generate(self, d, state):
        """Host phase 1: everything except the device filter ops."""
        farm = self.farm
        shared_heads = state["sharedHeads"]
        their_heads = state["theirHeads"]
        their_have = state["theirHave"]
        their_need = state["theirNeed"]
        our_heads = farm.get_heads(d)
        our_need = farm.get_missing_deps(d, their_heads or [])
        plan = {
            "shared_heads": shared_heads,
            "our_heads": our_heads,
            "our_need": our_need,
            "our_have": [],
        }

        if their_heads is None or all(h in their_heads for h in our_need):
            plan["build_hashes"] = [
                c["hash"] for c in self._changes_since(d, shared_heads)
            ]

        if their_have:
            last_sync = their_have[0]["lastSync"]
            if not all(farm.get_change_by_hash(d, h) for h in last_sync):
                plan["reset"] = True
                return plan

        if (
            isinstance(their_have, list)
            and isinstance(their_need, list)
            and their_have  # have=[] is served from `need` alone (sync.py:183)
        ):
            # candidates for the Bloom-negative scan: changes since the
            # union of the peer's lastSync hashes (sync.js:246)
            last_sync_hashes = []
            seen = set()
            for h in their_have:
                for hash_ in h["lastSync"]:
                    if hash_ not in seen:
                        seen.add(hash_)
                        last_sync_hashes.append(hash_)
            metas = self._changes_since(d, last_sync_hashes)
            plan["candidates"] = metas
            # one wire filter per have entry; entries beyond [0] — and any
            # filter with non-default wire parameters, which the device
            # kernel cannot evaluate — take the host BloomFilter path
            first = BloomFilter(their_have[0]["bloom"])
            conforming = first.num_entries == 0 or (
                first.num_probes == NUM_PROBES
                and first.num_bits_per_entry == BITS_PER_ENTRY
            )
            if conforming:
                plan["query"] = {
                    "bloom": their_have[0]["bloom"],
                    "hashes": [m["hash"] for m in metas],
                }
                plan["extra_blooms"] = [h["bloom"] for h in their_have[1:]]
            else:
                plan["bloom_positive"] = set()
                plan["extra_blooms"] = [h["bloom"] for h in their_have]
        return plan

    def _finish_generate(self, d, state, plan):
        """Host phase 2: reference control flow of generateSyncMessage."""
        farm = self.farm
        if plan.get("shed"):
            return state, None
        if plan.get("reset"):
            msg = {
                "heads": plan["our_heads"], "need": [],
                "have": [{"lastSync": [], "bloom": b""}], "changes": [],
            }
            encoded = encode_sync_message(msg)
            _M_MSGS_GEN.inc()
            _M_BYTES_SENT.inc(len(encoded))
            return state, encoded

        their_have = state["theirHave"]
        their_need = state["theirNeed"]
        changes_to_send = []
        if isinstance(their_have, list) and isinstance(their_need, list):
            if not their_have:
                changes_to_send = [
                    c
                    for c in (farm.get_change_by_hash(d, h) for h in their_need)
                    if c is not None
                ]
            else:
                changes_to_send = self._changes_to_send(
                    d, plan, their_have, their_need
                )

        our_heads = plan["our_heads"]
        heads_unchanged = (
            isinstance(state["lastSentHeads"], list)
            and our_heads == state["lastSentHeads"]
        )
        heads_equal = (
            isinstance(state["theirHeads"], list)
            and our_heads == state["theirHeads"]
        )
        if heads_unchanged and heads_equal and not changes_to_send:
            return state, None

        sent_hashes = state["sentHashes"]
        changes_to_send = [
            c
            for c in changes_to_send
            if not sent_hashes.get(decode_change_meta_cached(c)["hash"])
        ]
        msg = {
            "heads": our_heads,
            "have": plan["our_have"],
            "need": plan["our_need"],
            "changes": changes_to_send,
        }
        if changes_to_send:
            sent_hashes = dict(sent_hashes)
            for change in changes_to_send:
                sent_hashes[decode_change_meta_cached(change)["hash"]] = True
        new_state = dict(state, lastSentHeads=our_heads, sentHashes=sent_hashes)
        encoded = encode_sync_message(msg)
        _M_MSGS_GEN.inc()
        _M_BYTES_SENT.inc(len(encoded))
        _M_CHANGES_SENT.inc(len(changes_to_send))
        return new_state, encoded

    def _changes_to_send(self, d, plan, their_have, their_need):
        """Bloom-negative changes + dependents closure + explicit needs
        (getChangesToSend, sync.js:246), with the containsHash loop already
        evaluated on device (plan['bloom_positive'])."""
        metas = plan["candidates"]
        positive = plan.get("bloom_positive") or set()
        extra = [BloomFilter(b) for b in plan.get("extra_blooms", ())]

        change_hashes = set()
        dependents = {}
        to_send = set()
        for meta in metas:
            change_hashes.add(meta["hash"])
            for dep in meta["deps"]:
                dependents.setdefault(dep, []).append(meta["hash"])
            missed = meta["hash"] not in positive and all(
                not bloom.contains_hash(meta["hash"]) for bloom in extra
            )
            if missed:
                to_send.add(meta["hash"])

        stack = list(to_send)
        while stack:
            h = stack.pop()
            for dep in dependents.get(h, []):
                if dep not in to_send:
                    to_send.add(dep)
                    stack.append(dep)

        out = []
        _M_NEED_REQUESTED.inc(len(their_need))
        for h in their_need:
            # a needed hash we hold but withheld as Bloom-positive is a
            # detected false positive (same accounting as sync.py)
            if h in change_hashes and h not in to_send:
                _M_BLOOM_FP.inc()
            to_send.add(h)
            if h not in change_hashes:
                change = self.farm.get_change_by_hash(d, h)
                if change is not None:
                    out.append(change)
        for meta in metas:
            if meta["hash"] in to_send:
                out.append(meta["change"])
        return out

    # -------------------------------------------------------------- #
    # receive (sync.js:420, batched apply)

    def receive_messages(self, channels_msgs, protocols=None):
        """channels_msgs: [(doc, sync_state, message_bytes)]. Applies every
        channel's changes through ONE batched farm.apply_changes call (docs
        repeated across channels fall back to per-channel application to
        preserve per-message head accounting). Returns
        [(new_state, patch|None)] in channel order.

        Payloads route on their leading type byte — a sync v2 frame
        (``MESSAGE_TYPE_SYNC_V2``) decodes and post-processes through the
        range-reconciliation path, anything else through the reference
        protocol — so mixed-protocol sweeps and mid-session transitions
        need no caller-side branching. ``protocols`` is accepted for
        symmetry with ``generate_messages`` and forward compatibility;
        routing itself is self-describing.

        One bad peer must not abort the batched round: a channel whose
        message fails to decode is rejected in place — its result is
        ``(unchanged state, None)``, counted on ``sync.messages.rejected``
        (``sync.v2.messages.rejected`` for v2 frames) — and a channel
        whose changes poison its document is handled by the farm's per-doc
        isolation (the doc quarantines, the patch is a no-op, every other
        channel proceeds)."""
        del protocols  # inbound routing is by payload type byte
        farm = self.farm
        decoded = []
        is_v2 = []
        rejected = rejected_v2 = received_v2 = 0
        for _, _, m in channels_msgs:
            v2 = bool(m) and m[0] == MESSAGE_TYPE_SYNC_V2
            is_v2.append(v2)
            try:
                decoded.append(
                    decode_sync_message_v2(m) if v2 else decode_sync_message(m)
                )
                received_v2 += v2
            except (SyncProtocolError, ValueError, TypeError, IndexError):
                decoded.append(None)
                if v2:
                    rejected_v2 += 1
                else:
                    rejected += 1
        if _METRICS.enabled:
            _M_MSGS_RECV.inc(len(channels_msgs) - rejected - rejected_v2
                             - received_v2)
            _M_REJECTED.inc(rejected)
            _M2_MSGS_RECV.inc(received_v2)
            _M2_REJECTED.inc(rejected_v2)
            _M_BYTES_RECV.inc(sum(
                len(m)
                for (_, _, m), msg in zip(channels_msgs, decoded)
                if msg is not None
            ))
            _M_CHANGES_RECV.inc(
                sum(len(m["changes"]) for m in decoded if m is not None)
            )
        docs = [d for d, _, _ in channels_msgs]
        live_docs = [
            d for (d, _, _), msg in zip(channels_msgs, decoded)
            if msg is not None
        ]
        self.last_apply = None
        if len(set(live_docs)) != len(live_docs):
            return [
                (s, None) if msg is None else self._receive_one(d, s, msg, v2)
                for (d, s, _), msg, v2 in zip(channels_msgs, decoded, is_v2)
            ]

        before = {d: farm.get_heads(d) for d in docs}
        patches = [None] * farm.num_docs
        if any(msg and msg["changes"] for msg in decoded):
            per_doc = [[] for _ in range(farm.num_docs)]
            for d, msg in zip(docs, decoded):
                if msg is not None:
                    per_doc[d] = list(msg["changes"])
            patches = farm.apply_changes(per_doc)
            self.last_apply = patches

        results = []
        for (d, state, _), msg, v2 in zip(channels_msgs, decoded, is_v2):
            if msg is None:
                results.append((state, None))
                continue
            patch = patches[d] if msg["changes"] else None
            if v2:
                results.append((
                    self._post_receive_v2(d, state, msg, before[d]), patch,
                ))
            else:
                results.append(
                    self._post_receive(d, state, msg, before[d], patch)
                )
        return results

    def _receive_one(self, d, state, msg, v2=False):
        farm = self.farm
        before = farm.get_heads(d)
        patch = None
        if msg["changes"]:
            per_doc = [[] for _ in range(farm.num_docs)]
            per_doc[d] = list(msg["changes"])
            result = farm.apply_changes(per_doc)
            self.last_apply = result
            patch = result[d]
        if v2:
            return self._post_receive_v2(d, state, msg, before), patch
        return self._post_receive(d, state, msg, before, patch)

    def _post_receive_v2(self, d, state, msg, before_heads):
        """The batched twin of receive_sync_message_v2's bookkeeping: the
        fingerprint view re-syncs from the farm (picking up the changes
        the batched apply just committed) before the item-range diffs."""
        farm = self.farm
        return post_receive_v2(
            state, msg, before_heads, farm.get_heads(d),
            lambda h: farm.get_change_by_hash(d, h) is not None,
            self._v2_view(d),
        )

    def _post_receive(self, d, state, msg, before_heads, patch):
        farm = self.farm
        shared_heads = state["sharedHeads"]
        last_sent_heads = state["lastSentHeads"]
        sent_hashes = state["sentHashes"]
        if msg["changes"]:
            shared_heads = _advance_heads(
                before_heads, farm.get_heads(d), shared_heads
            )
        if not msg["changes"] and msg["heads"] == before_heads:
            last_sent_heads = msg["heads"]
        known = [h for h in msg["heads"] if farm.get_change_by_hash(d, h)]
        if len(known) == len(msg["heads"]):
            shared_heads = msg["heads"]
            if len(msg["heads"]) == 0:
                last_sent_heads = []
                sent_hashes = {}
        else:
            shared_heads = sorted(set(known + shared_heads))
        new_state = {
            "sharedHeads": shared_heads,
            "lastSentHeads": last_sent_heads,
            "theirHave": msg["have"],
            "theirHeads": msg["heads"],
            "theirNeed": msg["need"],
            "sentHashes": sent_hashes,
        }
        return new_state, patch

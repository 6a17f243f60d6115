"""Batched Text/list engine: RGA sequences for a batch of documents.

PyTorch counterpart of the JAX package's ``tpu/text_engine.py``.

- **Host**: transcoding only. Each insert op is assigned a stable slot in a
  per-document element table; elemId strings resolve to slots through a
  dict. No ordering work happens on the host.
- **Device**, batched over documents:
  * document order: the RGA insertion order ("insert after the reference
    element, skipping concurrent elements with greater opId",
    backend/new.js:144-163) as a parallel rank over the insertion tree
    (``rga.batched_rga_rank``: sort + pointer doubling, O(log E) depth);
  * visibility and conflicts: update/delete succ marking and the max-opId
    winner per element through the map engine (engine.py), keyed by the
    element's slot;
  * counter-tie resolution on the actor id string via the actor-rank
    remap (new.js:146, apply_patch.js:33).

This covers the repo's configuration 2 (concurrent insert/delete on Text).
The host scan-based order (``HostDocOrder``) is the differential-test
oracle for the device rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import parse_op_id
from ..errors import EncodeError, PackingLimitError
from . import rga
from .engine import (
    ACTION_DEL,
    ACTION_SET,
    ACTOR_BITS,
    PAD_KEY,
    BatchedMapEngine,
    changes_from_numpy,
)
from .rga import batched_rga_rank
from .transcode import actor_rank_table


class HostDocOrder:
    """Host-side RGA order for one document's list object: the sequential
    reference scan (new.js:144-163), kept as the oracle the device rank is
    differentially tested against."""

    __slots__ = ("elems", "pos", "dirty")

    def __init__(self):
        self.elems = []  # elemId strings in document order
        self.pos = {}  # elemId -> index (lazily rebuilt)
        self.dirty = False

    def _rebuild(self):
        if self.dirty:
            self.pos = {e: i for i, e in enumerate(self.elems)}
            self.dirty = False

    def insert(self, elem_id: str, ref: str):
        """Inserts elem_id after `ref` ('_head' for the front), skipping
        concurrent elements with greater opId (RGA convergence rule)."""
        self._rebuild()
        if ref == "_head":
            index = 0
        else:
            index = self.pos[ref] + 1
        new = parse_op_id(elem_id)
        while index < len(self.elems):
            other = parse_op_id(self.elems[index])
            if (other.counter, other.actor_id) > (new.counter, new.actor_id):
                index += 1
            else:
                break
        self.elems.insert(index, elem_id)
        self.dirty = True

    def ranks(self):
        self._rebuild()
        return self.pos


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


class BatchedTextEngine:
    """Front end for a batch of Text documents (one list object per doc).
    `device` holds the op slab and runs the rank and visibility programs:
    the card unless the caller asks for the CPU (``device="cpu"``)."""

    def __init__(self, num_docs: int, capacity: int = 256, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedTextEngine runs on the card by default and CUDA is "
                "not available here; pass device='cpu' to run on the CPU"
            )
        self.device = device
        self.num_docs = num_docs
        self.engine = BatchedMapEngine(num_docs, capacity, device=device)
        self.values = []  # interned element values
        self._value_index = {}
        self.actors = []
        self._actor_index = {}
        # element tables: stable slot per insert op, in arrival order
        self.elem_capacity = capacity
        self.elem_opid = np.zeros((num_docs, capacity), np.int64)
        self.elem_parent = np.full((num_docs, capacity), -1, np.int32)
        self.num_elems = np.zeros(num_docs, np.int32)
        self.elem_slot = [dict() for _ in range(num_docs)]  # elemId -> slot

    def _actor(self, actor_id):
        idx = self._actor_index.get(actor_id)
        if idx is None:
            idx = len(self.actors)
            self.actors.append(actor_id)
            self._actor_index[actor_id] = idx
        return idx

    def _value(self, v):
        idx = self._value_index.get(v)
        if idx is None:
            idx = len(self.values)
            self.values.append(v)
            self._value_index[v] = idx
        return idx

    def _pack(self, op_id: str) -> int:
        p = parse_op_id(op_id)
        return (p.counter << ACTOR_BITS) | self._actor(p.actor_id)

    def _actor_rank(self) -> np.ndarray:
        """Lexicographic rank per actor intern index, padded to a power of
        two."""
        return actor_rank_table(
            self.actors, pad_to=_next_pow2(max(len(self.actors), 1))
        )

    def _grow_elems(self, needed: int):
        if needed > rga.MAX_ELEMS:
            raise PackingLimitError(
                f"text document exceeds {rga.MAX_ELEMS} elements (incl. "
                "tombstones): beyond the rank kernel's key-packing range"
            )
        while needed > self.elem_capacity:
            pad = self.elem_capacity
            self.elem_opid = np.concatenate(
                [self.elem_opid, np.zeros((self.num_docs, pad), np.int64)],
                axis=1,
            )
            self.elem_parent = np.concatenate(
                [self.elem_parent, np.full((self.num_docs, pad), -1, np.int32)],
                axis=1,
            )
            self.elem_capacity *= 2

    def apply_batch(self, per_doc_ops):
        """Applies one round of change ops per document. Each op is a tuple
        (op_dict, op_counter, actor). Supported actions: insert 'set',
        non-insert 'set' (element overwrite), and 'del'."""
        max_new = max(
            (sum(1 for op, _, _ in doc_ops if op.get("insert"))
             for doc_ops in per_doc_ops),
            default=0,
        )
        self._grow_elems(int(self.num_elems.max(initial=0)) + max_new)

        rows = []
        for d, doc_ops in enumerate(per_doc_ops):
            slots = self.elem_slot[d]
            doc_rows = []
            for op, ctr, actor in doc_ops:
                if ctr >= rga.MAX_COUNTER:
                    raise PackingLimitError(
                        f"op counter {ctr} exceeds the merge-key "
                        "packing range"
                    )
                op_id = f"{ctr}@{actor}"
                packed = (ctr << ACTOR_BITS) | self._actor(actor)
                if op.get("insert"):
                    ref = op.get("elemId", "_head")
                    slot = int(self.num_elems[d])
                    self.num_elems[d] += 1
                    self.elem_opid[d, slot] = packed
                    self.elem_parent[d, slot] = -1 if ref == "_head" else slots[ref]
                    slots[op_id] = slot
                    doc_rows.append(
                        (slot, packed, ACTION_SET, self._value(op.get("value")), -1)
                    )
                elif op["action"] == "set":
                    key = slots[op["elemId"]]
                    pred = self._pack(op["pred"][0]) if op.get("pred") else -1
                    doc_rows.append(
                        (key, packed, ACTION_SET, self._value(op.get("value")), pred)
                    )
                elif op["action"] == "del":
                    key = slots[op["elemId"]]
                    pred = self._pack(op["pred"][0]) if op.get("pred") else -1
                    doc_rows.append((key, packed, ACTION_DEL, 0, pred))
                else:
                    raise EncodeError(f"Unsupported text op: {op['action']}")
            rows.append(doc_rows)

        width = max((len(r) for r in rows), default=1) or 1
        keys = np.full((self.num_docs, width), PAD_KEY, np.int32)
        ops = np.zeros((self.num_docs, width), np.int64)
        actions = np.zeros((self.num_docs, width), np.int32)
        values = np.zeros((self.num_docs, width), np.int64)
        preds = np.full((self.num_docs, width), -1, np.int64)
        for d, doc_rows in enumerate(rows):
            if not doc_rows:
                continue
            arr = np.asarray(doc_rows, np.int64)
            n = arr.shape[0]
            keys[d, :n] = arr[:, 0]
            ops[d, :n] = arr[:, 1]
            actions[d, :n] = arr[:, 2]
            values[d, :n] = arr[:, 3]
            preds[d, :n] = arr[:, 4]
        self.engine.apply_batch(changes_from_numpy(
            keys, ops, actions, values, preds, self.device
        ))

    def document_ranks(self, actor_rank=None) -> np.ndarray:
        """Device-computed RGA document order: rank[d, slot] = position of
        the element in doc d's sequence (tombstones included), or E for
        empty slots."""
        if actor_rank is None:
            actor_rank = self._actor_rank()
        dev = self.device
        valid = (
            torch.arange(self.elem_capacity, dtype=torch.int64,
                         device=dev)[None, :]
            < torch.from_numpy(self.num_elems).to(dev)[:, None]
        )
        ranks = batched_rga_rank(
            torch.from_numpy(self.elem_parent).to(dev),
            torch.from_numpy(self.elem_opid).to(dev),
            valid,
            torch.as_tensor(np.asarray(actor_rank), dtype=torch.int32).to(dev),
        )
        return ranks.cpu().numpy()

    def visible_texts(self):
        """Each document's visible element values in document order (device
        rank + device visibility)."""
        actor_rank = self._actor_rank()
        ranks = self.document_ranks(actor_rank)
        keys, _ops, _visible, winners, vals = self.engine.visible_state(
            actor_rank=actor_rank
        )
        keys = keys.cpu().numpy()
        winners = winners.cpu().numpy()
        vals = vals.cpu().numpy()
        texts = []
        for d in range(self.num_docs):
            # visible value id per element slot (-1 = none), one winner per
            # slot; then the live slots in rank order
            n = int(self.num_elems[d])
            win = np.nonzero(winners[d])[0]
            by_slot = np.full(n, -1, np.int64)
            by_slot[keys[d, win]] = vals[d, win]
            order = np.argsort(ranks[d, : self.elem_capacity])[:n]
            live = by_slot[order]
            texts.append([self.values[v] for v in live[live >= 0].tolist()])
        return texts

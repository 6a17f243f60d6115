"""The port's BatchedTextEngine against the JAX package's, round by round
on the CPU: document ranks and visible texts must be equal after every
round. Traffic is chip_smoke.py's configuration-2 generator (two actors,
concurrent inserts and deletes, tied counters) at a small size, plus a
hand-made round of concurrent overwrites."""
import numpy as np
import pytest

import chip_smoke as cs
from automerge_tpu.tpu.text_engine import BatchedTextEngine as JaxTextEngine
from automerge_tpu_torch.tpu.text_engine import BatchedTextEngine


def _engines(docs, capacity):
    jax = JaxTextEngine(docs, capacity=capacity)
    port = BatchedTextEngine(docs, capacity=capacity, device="cpu")
    for eng in (jax, port):
        eng._actor(cs.ACTOR_B)  # intern B before A: intern order != rank
    return jax, port


def _same(jax, port):
    assert np.array_equal(port.document_ranks(), np.asarray(jax.document_ranks()))
    assert port.visible_texts() == jax.visible_texts()


@pytest.mark.parametrize("seed,docs,ops", [(0, 3, 12), (1, 4, 20)])
def test_ranks_and_texts_match_jax_every_round(seed, docs, ops):
    traffic = cs.TextTraffic(docs, ops, seed)
    seed_ops = [(op, ctr, cs.ACTOR_A)
                for op, ctr in cs.TextTraffic.seed_ops()[1:]]
    jax, port = _engines(docs, capacity=32)
    for r in range(6):
        start, pairs = traffic.next_round()
        per_doc = [
            (list(seed_ops) if r == 0 else [])
            + [(op, start + i, cs.ACTOR_A) for i, op in enumerate(a)]
            + [(op, start + i, cs.ACTOR_B) for i, op in enumerate(b)]
            for a, b in pairs
        ]
        jax.apply_batch(per_doc)
        port.apply_batch(per_doc)
        _same(jax, port)
    assert [len(t) for t in port.visible_texts()] == \
        traffic.text_lengths().tolist()


def test_concurrent_overwrites_and_head_inserts():
    a, b = cs.ACTOR_A, cs.ACTOR_B
    ins = {"action": "set", "insert": True, "pred": []}
    jax, port = _engines(2, capacity=4)
    rounds = [
        # both actors insert at the head with one counter, then after it
        [[({**ins, "elemId": "_head", "value": "x"}, 1, a),
          ({**ins, "elemId": "_head", "value": "y"}, 1, b),
          ({**ins, "elemId": f"1@{a}", "value": "z"}, 2, a)],
         [({**ins, "elemId": "_head", "value": "p"}, 1, b)]],
        # concurrent overwrites of one element (tie on the counter), and
        # a delete of the other actor's element
        [[({"action": "set", "elemId": f"1@{a}", "value": "X",
            "pred": [f"1@{a}"]}, 3, a),
          ({"action": "set", "elemId": f"1@{a}", "value": "W",
            "pred": [f"1@{a}"]}, 3, b),
          ({"action": "del", "elemId": f"1@{b}", "pred": [f"1@{b}"]}, 4, a)],
         [({**ins, "elemId": f"1@{b}", "value": "q"}, 2, a)]],
    ]
    for per_doc in rounds:
        jax.apply_batch(per_doc)
        port.apply_batch(per_doc)
        _same(jax, port)
    assert port.visible_texts() == [["W", "z"], ["p", "q"]]

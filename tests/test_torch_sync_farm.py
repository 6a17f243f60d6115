"""The port's farm + SyncFarm against the JAX package's TpuDocFarm + SyncFarm
on the same seeded edits, on the CPU: every sync message must be
byte-identical and every patch canonical-JSON-identical, sweep by sweep.
Also: documents exported by a JAX farm carry across, list/text deliveries
match the JAX farm in both isolation modes, and the parts the port does not
have yet raise their typed error before anything commits."""
import json
import random

import pytest

from automerge_tpu.columnar import encode_change
from automerge_tpu.testing import faults
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu.tpu.sync_farm import SyncFarm as JaxSyncFarm
from automerge_tpu_torch import SyncFarm, TorchDocFarm
from automerge_tpu_torch.carry import doc_from_jax_export
from automerge_tpu_torch.errors import NotPortedError, PackingLimitError


def canon(x):
    return json.dumps(x, sort_keys=True, default=repr)


def same(a, b):
    assert canon(a) == canon(b)


def make_change(actor, seq, start_op, deps, ops):
    return encode_change({"actor": actor, "seq": seq, "startOp": start_op,
                          "time": 0, "deps": sorted(deps), "ops": ops})


class Replica:
    """One peer held twice: a JAX farm and a port farm fed the same edits,
    so the two stacks can be compared step by step."""

    def __init__(self, num_docs, actor, plain=False):
        self.plain = plain
        self.jax = TpuDocFarm(num_docs, capacity=64, page_size=16)
        self.port = TorchDocFarm(num_docs, capacity=64, page_size=16,
                                 device="cpu")
        self.jsync = JaxSyncFarm(self.jax)
        self.tsync = SyncFarm(self.port)
        self.num_docs = num_docs
        self.actor = actor
        self.seqs = [0] * num_docs
        self.own = [None] * num_docs  # (counter op, map id) per doc

    def edit(self, d, rng, n_ops=3):
        """A random local change on doc d: the first creates a counter and
        a nested map; later ones set root and map keys and increment the
        counter. A `plain` replica only sets root keys (the farm's fused
        patch-column readback serves exactly such docs)."""
        farm = self.port
        self.seqs[d] += 1
        start = farm.max_op[d] + 1
        ops = []
        if self.plain:
            self.own[d] = (None, None)
        elif self.own[d] is None:
            ops.append({"action": "set", "obj": "_root", "key": "c",
                        "value": 0, "datatype": "counter", "pred": []})
            ops.append({"action": "makeMap", "obj": "_root", "key": "m",
                        "pred": []})
            self.own[d] = (f"{start}@{self.actor}", f"{start + 1}@{self.actor}")
        ctr_op, map_id = self.own[d]
        for _ in range(n_ops):
            r = 1.0 if self.plain else rng.random()
            if r < 0.3:
                ops.append({"action": "inc", "obj": "_root", "key": "c",
                            "value": rng.randrange(1, 5), "pred": [ctr_op]})
            elif r < 0.5:
                ops.append({"action": "set", "obj": map_id,
                            "key": f"n{rng.randrange(3)}", "datatype": "uint",
                            "value": rng.randrange(100), "pred": []})
            else:
                ops.append({"action": "set", "obj": "_root",
                            "key": f"k{rng.randrange(5)}", "datatype": "uint",
                            "value": rng.randrange(1000), "pred": []})
        buf = make_change(self.actor, self.seqs[d], start,
                          farm.get_heads(d), ops)
        per_doc = [[] for _ in range(self.num_docs)]
        per_doc[d] = [buf]
        same(self.port.apply_changes(per_doc), self.jax.apply_changes(per_doc))
        return buf


def sync_pairs(a, b, max_rounds=10):
    """Both stacks run the reference sync loop over every doc channel, all
    channels in one generate call and one receive call per side; messages
    and patches must match between the stacks at every step."""
    n = a.num_docs
    states = {
        key: [SyncFarm.init_state() for _ in range(n)]
        for key in ("ja", "jb", "ta", "tb")
    }
    sweeps = 0
    for _ in range(max_rounds):
        moved = False
        for src, dst, s_src, s_dst in ((a, b, "a", "b"), (b, a, "b", "a")):
            out_j = src.jsync.generate_messages(
                [(d, states["j" + s_src][d]) for d in range(n)])
            out_t = src.tsync.generate_messages(
                [(d, states["t" + s_src][d]) for d in range(n)])
            batch_j, batch_t = [], []
            for d in range(n):
                states["j" + s_src][d], msg_j = out_j[d]
                states["t" + s_src][d], msg_t = out_t[d]
                assert msg_t == msg_j, f"message mismatch on doc {d}"
                if msg_t is not None:
                    batch_j.append((d, states["j" + s_dst][d], msg_j))
                    batch_t.append((d, states["t" + s_dst][d], msg_t))
            if not batch_t:
                continue
            moved = True
            got_j = dst.jsync.receive_messages(batch_j)
            got_t = dst.tsync.receive_messages(batch_t)
            for (d, _, _), (sj, pj), (st, pt) in zip(batch_t, got_j, got_t):
                states["j" + s_dst][d] = sj
                states["t" + s_dst][d] = st
                same(st, sj)
                same(pt, pj)
        sweeps += 1
        if not moved:
            break
    for d in range(n):
        for r in (a, b):
            assert r.port.get_heads(d) == r.jax.get_heads(d)
            same(r.port.get_patch(d), r.jax.get_patch(d))
        assert a.port.get_heads(d) == b.port.get_heads(d)
        same(a.port.get_patch(d)["diffs"], b.port.get_patch(d)["diffs"])
    return sweeps


@pytest.mark.parametrize("seed,plain", [(0, False), (1, False), (2, True)])
def test_divergent_replicas_match_jax_every_sweep(seed, plain):
    rng = random.Random(seed)
    a = Replica(3, "aaaaaaaa", plain)
    b = Replica(3, "bbbbbbbb", plain)
    for d in range(3):
        a.edit(d, rng)
    sync_pairs(a, b)
    for d in range(3):
        for _ in range(rng.randrange(1, 3)):
            a.edit(d, rng)
        for _ in range(rng.randrange(1, 3)):
            b.edit(d, rng)
    assert sync_pairs(a, b) > 1


def test_jax_exports_carry_across():
    """Docs exported mid-stream from a JAX farm, adopted by a port farm,
    then both fed the same next deliveries: equal patches."""
    rng = random.Random(5)
    src = Replica(3, "aaaaaaaa")
    for _ in range(2):
        for d in range(3):
            src.edit(d, rng)
    port = TorchDocFarm(3, capacity=64, page_size=16, device="cpu")
    for d in range(3):
        port.adopt_doc(d, doc_from_jax_export(src.jax.export_doc(d)))
        same(port.get_patch(d), src.jax.get_patch(d))
    src.port = port  # later edits go to the JAX farm and the adopted docs
    for _ in range(2):
        for d in range(3):
            src.edit(d, rng)
    for d in range(3):
        same(port.get_patch(d), src.jax.get_patch(d))


def test_list_changes_raise_before_anything_commits():
    """List/text deliveries apply now (embedded walk + device rank) and give
    the JAX farm's patches, in both isolation modes. What still raises
    before anything commits is a batch-mode call that fails prevalidation:
    no doc's state moves, the list doc's walk included."""
    ok = make_change("aaaaaaaa", 1, 1, [], [
        {"action": "set", "obj": "_root", "key": "x", "datatype": "uint",
         "value": 1, "pred": []}])
    for isolation in ("doc", "batch"):
        jax = TpuDocFarm(2, capacity=32)
        farm = TorchDocFarm(2, capacity=32, device="cpu")
        same(farm.apply_changes([[ok], []], isolation=isolation),
             jax.apply_changes([[ok], []], isolation=isolation))
        heads = farm.get_heads(0)
        lst = make_change("aaaaaaaa", 2, 2, heads, [
            {"action": "makeList", "obj": "_root", "key": "l", "pred": []},
            {"action": "set", "obj": "2@aaaaaaaa", "elemId": "_head",
             "insert": True, "datatype": "uint", "value": 7, "pred": []}])
        other = make_change("bbbbbbbb", 1, 1, [], [
            {"action": "set", "obj": "_root", "key": "y", "datatype": "uint",
             "value": 2, "pred": []}])
        same(farm.apply_changes([[lst], [other]], isolation=isolation),
             jax.apply_changes([[lst], [other]], isolation=isolation))
        for d in range(2):
            same(farm.get_patch(d), jax.get_patch(d))
        more = make_change("aaaaaaaa", 3, 4, farm.get_heads(0), [
            {"action": "set", "obj": "2@aaaaaaaa", "elemId": "3@aaaaaaaa",
             "insert": True, "datatype": "uint", "value": 8, "pred": []}])
        over = make_change("bbbbbbbb", 2, 1 << 24, farm.get_heads(1), [
            {"action": "set", "obj": "_root", "key": "y", "datatype": "uint",
             "value": 3, "pred": ["1@bbbbbbbb"]}])
        if isolation == "batch":
            before = [farm.get_patch(d) for d in range(2)]
            lengths = farm.engine.lengths.tolist()
            with pytest.raises(PackingLimitError):
                farm.apply_changes([[more], [over]], isolation="batch")
            assert [farm.get_patch(d) for d in range(2)] == before
            assert farm.engine.lengths.tolist() == lengths
            assert farm.exact[0].get_patch() == before[0]
            assert farm.fault_counts == [0, 0] and not farm.quarantine
        else:
            got = farm.apply_changes([[more], [over]])
            same(got, jax.apply_changes([[more], [over]]))
            assert list(got.quarantined) == [1]
            for d in range(2):
                same(farm.get_patch(d), jax.get_patch(d))


def test_sync_v2_raises_not_ported():
    farm = TorchDocFarm(1, capacity=32, device="cpu")
    sync = SyncFarm(farm)
    with pytest.raises(NotPortedError) as err:
        sync.generate_messages([(0, SyncFarm.init_state())], protocols="v2")
    assert err.value.slice_name == "sync_v2"
    with pytest.raises(NotPortedError):
        sync.receive_messages([(0, SyncFarm.init_state(), b"\x45\x00")])
    with pytest.raises(NotPortedError):
        farm.attach_store(object())


def test_carry_refuses_list_documents():
    """List documents carry across now (tests/test_torch_farm_lists.py);
    what is still refused is a document in the JAX farm's degraded mode
    (walk-served after a failed device dispatch), which this package has
    not ported."""
    jax = TpuDocFarm(2, capacity=32)
    bufs = [[make_change(a, 1, 1, [], [
        {"action": "set", "obj": "_root", "key": "x", "datatype": "uint",
         "value": 1, "pred": []}])] for a in ("aaaaaaaa", "bbbbbbbb")]
    with faults.inject("farm.device_dispatch", faults.fail_docs([0])):
        result = jax.apply_changes(bufs)
    assert list(result.quarantined) == [0] and 1 in jax.degraded
    with pytest.raises(ValueError, match="degraded"):
        doc_from_jax_export(jax.export_doc(1))

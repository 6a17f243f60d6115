"""List/text documents through the port's farm against the JAX farm, on the
CPU: the ListWorkload differential of tests/test_farm_lists.py with
TorchDocFarm and TpuDocFarm side by side (every round's patches and the
whole-document patches dict-equal, both isolation modes), carrying list
documents across from a JAX export, per-doc quarantine, and the rollback
that still refuses a failed device dispatch."""
import pytest

from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu_torch import TorchDocFarm
from automerge_tpu_torch.carry import doc_from_jax_export
from automerge_tpu_torch.errors import NotPortedError
from test_farm_lists import ListWorkload, make_change


def _farms(num_docs):
    return (TpuDocFarm(num_docs, capacity=512),
            TorchDocFarm(num_docs, capacity=512, device="cpu"))


def _round(jax, port, loads, isolation="doc"):
    per_doc = []
    for d, load in enumerate(loads):
        buf = load.next_change(jax.get_heads(d))
        per_doc.append([buf] if buf else [])
    want = jax.apply_changes(per_doc, isolation=isolation)
    got = port.apply_changes(per_doc, isolation=isolation)
    for d in range(len(loads)):
        assert got[d] == want[d], f"doc {d}:\n  port {got[d]}\n  jax  {want[d]}"
        assert got.outcomes[d].status == want.outcomes[d].status
    return per_doc


def _whole_docs_equal(jax, port):
    for d in range(jax.num_docs):
        assert port.get_heads(d) == jax.get_heads(d)
        assert port.get_patch(d) == jax.get_patch(d), f"get_patch doc {d}"


@pytest.mark.parametrize("isolation", ["doc", "batch"])
@pytest.mark.parametrize("num_docs,rounds,seed", [(1, 12, 11), (3, 10, 12),
                                                  (2, 18, 13)])
def test_list_differential_matches_jax(num_docs, rounds, seed, isolation):
    jax, port = _farms(num_docs)
    loads = [ListWorkload(seed + 31 * d) for d in range(num_docs)]
    for _ in range(rounds):
        _round(jax, port, loads, isolation)
    _whole_docs_equal(jax, port)
    for d in range(num_docs):
        if port.exact[d] is not None:
            assert port.get_patch(d) == port.exact[d].get_patch()


def test_jax_list_exports_carry_across():
    jax, _ = _farms(3)
    loads = [ListWorkload(40 + d) for d in range(3)]
    for _ in range(8):
        per_doc = []
        for d, load in enumerate(loads):
            buf = load.next_change(jax.get_heads(d))
            per_doc.append([buf] if buf else [])
        jax.apply_changes(per_doc)
    assert all(jax.exact[d] is not None for d in range(3))
    port = TorchDocFarm(3, capacity=512, device="cpu")
    for d in (2, 0, 1):  # adoption order != the JAX farm's intern order
        port.adopt_doc(d, doc_from_jax_export(jax.export_doc(d)))
    _whole_docs_equal(jax, port)
    for _ in range(6):
        _round(jax, port, loads)
    _whole_docs_equal(jax, port)


def test_list_doc_quarantine_matches_jax():
    jax, port = _farms(2)
    loads = [ListWorkload(50 + d) for d in range(2)]
    for _ in range(4):
        _round(jax, port, loads)
    good = loads[0].next_change(jax.get_heads(0))
    bad = loads[1].next_change(jax.get_heads(1))[:-3]  # truncated chunk
    want = jax.apply_changes([[good], [bad]])
    got = port.apply_changes([[good], [bad]])
    assert got[0] == want[0] and got[1] == want[1]
    assert list(got.quarantined) == list(want.quarantined) == [1]
    assert got.quarantined[1].error_kind == want.quarantined[1].error_kind
    _whole_docs_equal(jax, port)


def test_failed_device_dispatch_rolls_back_and_raises():
    jax, port = _farms(2)
    loads = [ListWorkload(60 + d) for d in range(2)]
    for _ in range(3):
        _round(jax, port, loads)
    per_doc = [[loads[d].next_change(jax.get_heads(d))] for d in range(2)]
    before = [(port.get_heads(d), port.get_patch(d)) for d in range(2)]
    lengths = port.engine.lengths.tolist()
    elems = port.num_elems.tolist()

    def fail(*args, **kwargs):
        raise RuntimeError("device lost")

    port.engine.apply_batch = fail
    with pytest.raises(NotPortedError) as err:
        port.apply_changes(per_doc)
    assert err.value.slice_name == "opset"
    del port.engine.apply_batch
    assert [(port.get_heads(d), port.get_patch(d)) for d in range(2)] == before
    assert port.engine.lengths.tolist() == lengths
    assert port.num_elems.tolist() == elems
    assert port.fault_counts == [0, 0] and not port.quarantine
    # the walks that took the lost delivery rebuild from the committed log:
    # delivering it again gives the JAX farm's patches
    want = jax.apply_changes(per_doc)
    got = port.apply_changes(per_doc)
    assert list(got) == list(want)
    _whole_docs_equal(jax, port)


def test_element_limit_quarantines_before_commit(monkeypatch):
    from automerge_tpu_torch.tpu import rga

    monkeypatch.setattr(rga, "MAX_ELEMS", 3)
    port = TorchDocFarm(1, capacity=32, device="cpu")
    ops = [{"action": "makeList", "obj": "_root", "key": "l", "pred": []}]
    ref = "_head"
    for i in range(4):
        ops.append({"action": "set", "obj": "1@aaaaaaaa", "elemId": ref,
                    "insert": True, "datatype": "uint", "value": i,
                    "pred": []})
        ref = f"{2 + i}@aaaaaaaa"
    buf, _ = make_change("aaaaaaaa", 1, 1, [], ops)
    got = port.apply_changes([[buf]])
    assert got.quarantined[0].error_kind == "packing"
    assert port.get_heads(0) == [] and int(port.num_elems[0]) == 0

"""The port's copy of the sequential engine (``automerge_tpu_torch.opset``)
against the JAX package's, patch for patch on the same change buffers:
incremental patches, whole-document patches, saved document bytes,
reloads, hash-graph queries and the errors of bad deliveries."""
import random

import pytest

from automerge_tpu.opset import OpSet as JaxOpSet
from automerge_tpu_torch.opset import OpSet
from test_farm_lists import ListWorkload, make_change


def _pair_run(seed, rounds, batch=1):
    """Feeds one ListWorkload to both engines, `batch` changes per
    delivery (shuffled, so later changes queue until their deps land)."""
    rng = random.Random(seed)
    load = ListWorkload(seed)
    jax, port = JaxOpSet(), OpSet()
    pending = []
    for _ in range(rounds):
        buf = load.next_change(list(load.last_hash[a] for a in load.actors
                                    if load.last_hash[a]) or [])
        if buf:
            pending.append(buf)
        if len(pending) >= batch:
            rng.shuffle(pending)
            assert port.apply_changes(pending) == jax.apply_changes(pending)
            pending = []
    if pending:
        assert port.apply_changes(pending) == jax.apply_changes(pending)
    return jax, port


@pytest.mark.parametrize("seed,batch", [(1, 1), (2, 1), (3, 3), (4, 5)])
def test_patches_match_jax(seed, batch):
    jax, port = _pair_run(seed, 40, batch)
    assert port.get_patch() == jax.get_patch()
    assert port.heads == jax.heads and port.clock == jax.clock
    assert port.get_missing_deps() == jax.get_missing_deps()


@pytest.mark.parametrize("seed", [5, 6])
def test_saved_documents_match_jax(seed):
    jax, port = _pair_run(seed, 30)
    saved = port.save()
    assert saved == jax.save()
    loaded, jax_loaded = OpSet(saved), JaxOpSet(saved)
    assert loaded.get_patch() == jax_loaded.get_patch() == port.get_patch()
    assert port.get_changes([]) == jax.get_changes([])


def test_bad_deliveries_raise_like_jax():
    first = make_change("aaaaaaaa", 1, 1, [], [
        {"action": "makeText", "obj": "_root", "key": "t", "pred": []}])[0]

    def set_x(seq):
        return make_change("aaaaaaaa", seq, 2, [], [
            {"action": "set", "obj": "_root", "key": "x", "datatype": "uint",
             "value": 1, "pred": []}])[0]

    for bad in (set_x(1), set_x(3)):  # a reused and a skipped seq number
        jax, port = JaxOpSet(), OpSet()
        assert port.apply_changes([first]) == jax.apply_changes([first])
        with pytest.raises(Exception) as jerr:
            jax.apply_changes([bad])
        with pytest.raises(Exception) as terr:
            port.apply_changes([bad])
        assert type(terr.value).__name__ == type(jerr.value).__name__
        assert str(terr.value) == str(jerr.value)
        assert port.get_patch() == jax.get_patch()
    # an insert after an element the document never saw: both engines
    # accept it the same way
    stray = make_change("bbbbbbbb", 1, 2, [], [
        {"action": "set", "obj": "1@aaaaaaaa", "elemId": "9@aaaaaaaa",
         "insert": True, "value": "q", "pred": []}])[0]
    jax, port = JaxOpSet(), OpSet()
    assert port.apply_changes([first, stray]) == jax.apply_changes(
        [first, stray])
    assert port.get_patch() == jax.get_patch()

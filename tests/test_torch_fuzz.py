"""Convergence fuzzing of the port's API and backend against the same
reference-model oracle as tests/test_fuzz.py (``Micromerge``, with its
change generator): random changes from several actors go through the
port's full backend in causally valid orders, with save/load round trips
interleaved, and the materialised documents must match the oracle, each
other, and the JAX package's documents, whose ``save()`` bytes the port's
must equal. One case per seed."""
import random

import pytest
from test_fuzz import ChangeGenerator, Micromerge
from test_fuzz import apply_via_backend as jax_apply_via_backend
from test_fuzz import materialize

import automerge_tpu as jam
import automerge_tpu_torch as am
from automerge_tpu_torch.columnar import encode_change


def apply_via_backend(changes, shuffle_seed=None):
    """The port's twin of test_fuzz.apply_via_backend: binary changes
    through the full backend (optionally in a shuffled, causally buffered
    order), materialised via save/load."""
    binaries = [encode_change(c) for c in changes]
    if shuffle_seed is not None:
        rng = random.Random(shuffle_seed)
        binaries = binaries[:1] + rng.sample(binaries[1:], len(binaries) - 1)
    doc = am.init("ffffffff")
    doc, _patch = am.apply_changes(doc, binaries)
    return am.load(am.save(doc), "ffffffff")


@pytest.mark.parametrize("seed", range(5))
def test_backend_matches_oracle(seed):
    changes = ChangeGenerator(seed).generate(15)
    oracle = Micromerge()
    for change in changes:
        oracle.apply_change(change)
    doc = apply_via_backend(changes)
    assert materialize(doc) == materialize(oracle.root)
    want = jax_apply_via_backend(changes)
    assert materialize(doc) == materialize(want)
    assert am.save(doc) == jam.save(want)


@pytest.mark.parametrize("seed", range(5))
def test_order_independence(seed):
    changes = ChangeGenerator(seed + 100).generate(12)
    reference = materialize(apply_via_backend(changes))
    assert reference == materialize(jax_apply_via_backend(changes))
    for shuffle in range(3):
        doc = apply_via_backend(changes, shuffle_seed=shuffle)
        assert materialize(doc) == reference, f"shuffle {shuffle}"
        want = jax_apply_via_backend(changes, shuffle_seed=shuffle)
        assert am.save(doc) == jam.save(want), f"shuffle {shuffle}"


@pytest.mark.parametrize("seed", range(3))
def test_save_load_mid_stream(seed):
    changes = ChangeGenerator(seed + 200).generate(12)
    binaries = [encode_change(c) for c in changes]
    mid = len(binaries) // 2
    doc = am.init("ffffffff")
    doc, _ = am.apply_changes(doc, binaries[:mid])
    doc = am.load(am.save(doc), "eeeeeeee")
    doc, _ = am.apply_changes(doc, binaries[mid:])
    assert materialize(doc) == materialize(apply_via_backend(changes))
    jdoc = jam.init("ffffffff")
    jdoc, _ = jam.apply_changes(jdoc, binaries[:mid])
    jdoc = jam.load(jam.save(jdoc), "eeeeeeee")
    jdoc, _ = jam.apply_changes(jdoc, binaries[mid:])
    assert am.save(doc) == jam.save(jdoc)
    assert [bytes(c) for c in am.get_all_changes(doc)] == \
        [bytes(c) for c in jam.get_all_changes(jdoc)]


@pytest.mark.parametrize("seed", range(3))
def test_save_load_byte_stability(seed):
    changes = ChangeGenerator(seed + 300).generate(10)
    doc = apply_via_backend(changes)
    saved = am.save(doc)
    doc2 = am.load(saved)
    state = am.Frontend.get_backend_state(doc2, "x")
    state.state.binary_doc = None  # force re-encode from op rows
    assert state.state.save() == saved
    assert saved == jam.save(jax_apply_via_backend(changes))

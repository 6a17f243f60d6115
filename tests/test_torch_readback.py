"""The port's full-readback oracle, ``TorchDocFarm._read_visibility``: one
readback of the engine's whole visibility state plus the action column of
its dense view. Twins of the JAX package's
tests/test_parity_incremental.py::test_mirror_matches_device_state on the
same seeds (the host row mirror IS the device op table), and the
readback itself against the JAX farm's on the same traffic."""
import numpy as np
import pytest

from automerge_tpu.opset import OpSet as JaxOpSet
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu_torch import TorchDocFarm
from test_farm import Workload

SEEDS = [11, 23, 47]
ROUNDS = 10
NUM_DOCS = 3


def run_workload(farm, seed):
    """`NUM_DOCS` copies of one random map-family workload (concurrent
    actors, counters, nesting, deletes, delayed delivery), generated
    against a JAX-package OpSet oracle as the JAX suite does."""
    oracle = JaxOpSet()
    workload = Workload(seed)
    for _ in range(ROUNDS):
        buffers = workload.next_round(oracle)
        if not buffers:
            continue
        oracle.apply_changes(list(buffers))
        farm.apply_changes([list(buffers) for _ in range(NUM_DOCS)])
    return farm


@pytest.mark.parametrize("seed", SEEDS)
def test_mirror_matches_device_state(seed):
    """keys/opIds/actions of the host mirror match the full-state readback
    row for row, and the refreshed visible/total cache matches the
    device visibility program for every live row."""
    farm = run_workload(TorchDocFarm(NUM_DOCS, capacity=64,
                                     quarantine_threshold=None, device="cpu"),
                        seed)
    keys, ops, visible, totals, actions = farm._read_visibility()
    for a in (keys, ops, visible, totals, actions):
        assert isinstance(a, np.ndarray)
    for d in range(farm.num_docs):
        farm._refresh_visibility([d])
        n = farm._vis_mkey[d].shape[0]
        assert int((np.asarray(keys[d]) != np.iinfo(np.int32).max).sum()) == n
        np.testing.assert_array_equal(farm._vis_key[d], keys[d][:n])
        np.testing.assert_array_equal(farm._vis_op[d], ops[d][:n])
        np.testing.assert_array_equal(farm._vis_action[d], actions[d][:n])
        np.testing.assert_array_equal(farm._vis_visible[d], visible[d][:n])
        np.testing.assert_array_equal(farm._vis_total[d], totals[d][:n])


@pytest.mark.parametrize("seed", SEEDS)
def test_readback_matches_jax_farm(seed):
    """The same traffic through both farms: every live row of the port's
    readback (key, op, visible, total, action) equals the JAX farm's."""
    port = run_workload(TorchDocFarm(NUM_DOCS, capacity=64,
                                     quarantine_threshold=None, device="cpu"),
                        seed)
    jax = run_workload(TpuDocFarm(NUM_DOCS, capacity=64,
                                  quarantine_threshold=None), seed)
    got = port._read_visibility()
    want = [np.asarray(a) for a in jax._read_visibility()]
    for d in range(NUM_DOCS):
        n = jax._vis_mkey[d].shape[0]
        assert port._vis_mkey[d].shape[0] == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[d][:n], w[d][:n])

"""The port's serving front door against the JAX package's: ``LoadGen``
on one seed and one small configuration, once over the JAX farm and once
over the port's (``device="cpu"``), must give the same report
(dispatches, admission counts, occupancy, the latency histogram,
convergence) and move the same frames byte for byte: under chaos, with
hostile clients, and with a store attached (whose directories must then
be identical too)."""
import json

import pytest

from automerge_tpu.serve import LoadConfig as JaxLoadConfig
from automerge_tpu.serve import LoadGen as JaxLoadGen
from automerge_tpu.store import ShardStore as JaxShardStore
from automerge_tpu.testing import faults as jax_faults
from automerge_tpu.tpu.farm import TpuDocFarm
from automerge_tpu_torch.serve import LoadConfig, LoadGen
from automerge_tpu_torch.store import ShardStore
from automerge_tpu_torch.testing import faults
from automerge_tpu_torch.tpu.farm import TorchDocFarm
from chip_smoke import dir_files

CLIENTS, DOCS = 24, 6


def _run(port, root=None, **knobs):
    """One LoadGen run over one package. Returns (report, frames, every
    doc's whole patch, the store's files or None)."""
    if port:
        farm = TorchDocFarm(DOCS, capacity=128, device="cpu")
        store_cls, gen, config_cls, fault_mod = (
            ShardStore, LoadGen, LoadConfig, faults)
    else:
        farm = TpuDocFarm(DOCS, capacity=128)
        store_cls, gen, config_cls, fault_mod = (
            JaxShardStore, JaxLoadGen, JaxLoadConfig, jax_faults)
    store = None
    if root is not None:
        store = store_cls(root)
        farm.attach_store(store)
    harness = gen(farm, config_cls(clients=CLIENTS, docs=DOCS,
                                   edits_per_client=2, ops_per_edit=4,
                                   spread=0.4, seed=9, **knobs))
    frames = []

    def record(**ctx):
        frames.append((ctx["link"], bytes(ctx["frame"])))

    with fault_mod.inject("chaos.send", record), \
            fault_mod.inject("chaos.deliver", record):
        report = harness.run()
    patches = [json.dumps(farm.get_patch(d), sort_keys=True)
               for d in range(DOCS)]
    files = None
    if store is not None:
        store.close()
        files = dir_files(root)
    return report, frames, patches, files


@pytest.mark.parametrize("knobs", [{"chaos": 0.3}, {"poison": 0.34}],
                         ids=["chaos", "poison"])
def test_loadgen_matches_jax(knobs):
    want = _run(False, **knobs)
    got = _run(True, **knobs)
    report = got[0]
    assert report == want[0]
    assert got[1] == want[1] and len(got[1]) > 100
    assert got[2] == want[2]
    assert report["dispatches"] > 0 and report["latency_ms"]["samples"] > 0
    if "poison" in knobs:
        assert report["poisoned_docs"] > 0
    else:
        assert report["converged"]


def test_loadgen_with_store_writes_jax_identical_directories(tmp_path):
    """With a store attached to the served farm, every flush's commits go
    through the WAL: both packages write the same files."""
    want = _run(False, root=str(tmp_path / "jax"))
    got = _run(True, root=str(tmp_path / "port"))
    assert got[0] == want[0] and got[0]["converged"]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert any(name.startswith("wal-") and len(data) > 1000
               for name, data in got[3])

"""The port stands alone: importing automerge_tpu_torch (its farm, its
SyncFarm, its sequential engine, text engine and kernels, its backend,
sync v2, sessions, fault points, flight recorder and fingerprint index,
its store, serving front door, chaos transport and request-flow
observability, its public API, frontend and uuid factory, its program
observatory, ledger and obs CLI, its doc-sharded mesh with its process
workers and shared-memory rings, its native codecs, its engine-level API
(``BatchTranscoder`` and the dense state) and its amlint included) or
chip_smoke.py loads neither
JAX nor anything of the JAX package, and its entry points refuse to fall
back to the CPU when no card is present. The port's memory sampler reads
its own codecs module, never the JAX package's."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import sys
import automerge_tpu_torch
import automerge_tpu_torch.analysis
import automerge_tpu_torch.analysis.__main__
import automerge_tpu_torch.backend
import automerge_tpu_torch.carry
import automerge_tpu_torch.frontend
import automerge_tpu_torch.kernels
import automerge_tpu_torch.native
import automerge_tpu_torch.obs
import automerge_tpu_torch.obs.__main__
import automerge_tpu_torch.obs.export
import automerge_tpu_torch.obs.flight
import automerge_tpu_torch.obs.ledger
import automerge_tpu_torch.obs.prof
import automerge_tpu_torch.obs.scope
import automerge_tpu_torch.obs.slo
import automerge_tpu_torch.opset
import automerge_tpu_torch.parallel
import automerge_tpu_torch.parallel.mesh
import automerge_tpu_torch.parallel.meshfarm
import automerge_tpu_torch.parallel.shm
import automerge_tpu_torch.parallel.workers
import automerge_tpu_torch.serve
import automerge_tpu_torch.store
import automerge_tpu_torch.sync_session
import automerge_tpu_torch.sync_v2
import automerge_tpu_torch.testing.chaos
import automerge_tpu_torch.testing.faults
import automerge_tpu_torch.uuid
import automerge_tpu_torch.tpu.fingerprint
import automerge_tpu_torch.tpu.jitprof
import automerge_tpu_torch.tpu.decode
import automerge_tpu_torch.tpu.leb_kernels
import automerge_tpu_torch.tpu.rga
import automerge_tpu_torch.tpu.text_engine
import automerge_tpu_torch.tpu.transcode
import chip_smoke
from automerge_tpu_torch.tpu import (BatchTranscoder, batched_apply_ops,
                                     batched_visible_state, make_empty_state)
from automerge_tpu_torch.tpu.farm import TorchDocFarm
from automerge_tpu_torch.tpu.sync_farm import SyncFarm
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
    or m == "automerge_tpu" or m.startswith("automerge_tpu.")
)
print("LEAKED=" + ",".join(leaked))
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout, out.stdout


FRESH_IMPORTS = """
import importlib, pathlib, sys
root = pathlib.Path("automerge_tpu_torch")
names = sorted(
    ".".join(p.with_suffix("").parts).removesuffix(".__init__")
    for p in root.rglob("*.py"))
failed = []
for name in names:
    for loaded in [m for m in sys.modules if m.startswith("automerge_tpu_torch")]:
        del sys.modules[loaded]
    try:
        importlib.import_module(name)
    except Exception as exc:
        failed.append(f"{name}: {exc!r}")
print("MODULES=%d" % len(names))
print("FAILED=" + " | ".join(failed))
"""


def test_every_module_imports_first_in_a_fresh_interpreter():
    """Whichever module of the port a process names first imports: the
    package's lazy entry points leave no import cycle to the order in
    which an earlier import happened to load modules."""
    out = subprocess.run(
        [sys.executable, "-c", FRESH_IMPORTS], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "FAILED=\n" in out.stdout, out.stdout
    assert int(out.stdout.split("MODULES=")[1].split()[0]) >= 50


def test_sampler_reads_the_port_codecs_only():
    """The port's Sampler names ``automerge_tpu_torch.codecs`` (a copied
    string would read the JAX package's DecodeCache whenever both are
    loaded, and no import check sees a string)."""
    import inspect

    from automerge_tpu_torch.obs import prof

    assert prof.CODECS_MODULE == "automerge_tpu_torch.codecs"
    source = inspect.getsource(prof)
    assert '"automerge_tpu.codecs"' not in source
    assert "sys.modules.get(CODECS_MODULE)" in source


def test_farm_defaults_to_the_card():
    from automerge_tpu_torch import TorchDocFarm

    if torch.cuda.is_available():
        assert TorchDocFarm(1, capacity=8).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchDocFarm(1, capacity=8)


def test_text_engine_defaults_to_the_card():
    from automerge_tpu_torch.tpu.text_engine import BatchedTextEngine

    if torch.cuda.is_available():
        assert BatchedTextEngine(1, capacity=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchedTextEngine(1, capacity=8)

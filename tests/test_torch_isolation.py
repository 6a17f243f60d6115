"""The port stands alone: importing automerge_tpu_torch (its farm, its
SyncFarm, its sequential engine, text engine and kernels included) or
chip_smoke.py loads neither JAX nor anything of the JAX package, and its
entry points refuse to fall back to the CPU when no card is present."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import sys
import automerge_tpu_torch
import automerge_tpu_torch.carry
import automerge_tpu_torch.kernels
import automerge_tpu_torch.opset
import automerge_tpu_torch.tpu.decode
import automerge_tpu_torch.tpu.leb_kernels
import automerge_tpu_torch.tpu.rga
import automerge_tpu_torch.tpu.text_engine
import chip_smoke
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

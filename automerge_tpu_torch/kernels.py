"""Build and load the package's hand-written CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Libraries land in
``build/kernels/`` beside the package, named by a hash of their source so
an edited source never loads a stale build. Nothing is built at import: a
kernel's wrapper calls ``load`` on its first launch, and ``build`` starts
one ``nvcc`` per source at once, for callers that want every kernel ready
(and timed) up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = {
    "bloom": _PKG / "csrc" / "bloom.cu",
    "leb128": _PKG / "csrc" / "leb128.cu",
}
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, str]:
    """Compiles the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    {name: compiler output}; raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(
            f"{n}:\n{logs[n]}" for n in failed
        ))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


# ---------------------------------------------------------------------- #
# helpers the kernel wrappers share


def check_tensor(name, t, dtype, shape) -> None:
    """Raises unless `t` has the dtype and shape a kernel takes and is
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(device: int) -> int:
    """The current CUDA stream of card `device` (an index) as a pointer,
    for a kernel launcher: the capture stream while a CUDA graph is being
    captured. Read without building a ``torch.cuda.Stream``, which costs
    the host more than a small kernel's launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device)

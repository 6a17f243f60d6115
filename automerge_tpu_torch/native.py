"""ctypes bindings for the native C++ columnar codecs (native/codecs.cpp).

The native library accelerates the host-side transcoding between the
variable-length column formats and dense numpy arrays. Its output is
byte-identical to the pure-Python codecs by contract
(tests/test_torch_native.py); `available()` reports which path is active.

This is the port's own copy of the JAX package's ``native.py`` with its
own library. The first call that needs the library compiles the repo's
``native/codecs.cpp`` with ``g++`` into ``build/native/`` beside the
package, named by a hash of the source (as ``kernels.py`` names the CUDA
libraries), so an edited source never loads a stale build and nothing is
written into ``native/``. Without ``g++``, or when the build fails, the
pure-Python codecs serve every call.

Build ahead of time with: python -m automerge_tpu_torch.native --build
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .columnar import NULL_SENTINEL  # noqa: F401 — the dense arrays' null

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "codecs.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None
#: why the library is not loaded (None until a load was attempted)
load_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libamcodecs_{digest}.so"


def build(verbose=False) -> Path:
    """Compiles the native library with g++ unless it is built already;
    returns its path. Concurrent builds are safe: each writes a
    pid-tagged temporary file and renames it into place."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native codecs need a C++ "
                           "compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    result = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                            capture_output=not verbose, text=True)
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {result.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, load_error
    if _lib is not None or load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as exc:
        load_error = str(exc)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.am_rle_decode.restype = ctypes.c_int64
    lib.am_rle_decode.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int,
                                  ctypes.c_int64, i64p, ctypes.c_size_t]
    lib.am_rle_encode.restype = ctypes.c_int64
    lib.am_rle_encode.argtypes = [i64p, ctypes.c_size_t, ctypes.c_int,
                                  ctypes.c_int64, u8p, ctypes.c_size_t]
    lib.am_delta_decode.restype = ctypes.c_int64
    lib.am_delta_decode.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int64,
                                    i64p, ctypes.c_size_t]
    lib.am_delta_encode.restype = ctypes.c_int64
    lib.am_delta_encode.argtypes = [i64p, ctypes.c_size_t, ctypes.c_int64,
                                    u8p, ctypes.c_size_t]
    lib.am_bool_decode.restype = ctypes.c_int64
    lib.am_bool_decode.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]
    lib.am_bool_encode.restype = ctypes.c_int64
    lib.am_bool_encode.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]
    lib.am_strrle_decode.restype = ctypes.c_int64
    lib.am_strrle_decode.argtypes = [u8p, ctypes.c_size_t, u8p,
                                     ctypes.c_size_t, i64p, ctypes.c_size_t]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _check(rc, what):
    if rc < 0:
        raise ValueError(f"native {what} failed with code {rc}")
    return rc


def _as_u8p(buf):
    return ctypes.cast(ctypes.c_char_p(bytes(buf)), ctypes.POINTER(ctypes.c_uint8))


def rle_decode(buf: bytes, signed: bool = False, max_count: int = None) -> np.ndarray:
    """Decodes an RLE column into an int64 array (nulls = NULL_SENTINEL)."""
    lib = _load()
    cap = max_count if max_count is not None else max(16, len(buf) * 64)
    out = np.empty(cap, np.int64)
    rc = lib.am_rle_decode(
        _as_u8p(buf), len(buf), 1 if signed else 0, NULL_SENTINEL,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    return out[:_check(rc, "rle_decode")]


def rle_encode(values: np.ndarray, signed: bool = False) -> bytes:
    lib = _load()
    values = np.ascontiguousarray(values, np.int64)
    cap = max(16, values.size * 10)
    out = np.empty(cap, np.uint8)
    rc = lib.am_rle_encode(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), values.size,
        1 if signed else 0, NULL_SENTINEL,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    return out[:_check(rc, "rle_encode")].tobytes()


def delta_decode(buf: bytes, max_count: int = None) -> np.ndarray:
    lib = _load()
    cap = max_count if max_count is not None else max(16, len(buf) * 64)
    out = np.empty(cap, np.int64)
    rc = lib.am_delta_decode(
        _as_u8p(buf), len(buf), NULL_SENTINEL,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    return out[:_check(rc, "delta_decode")]


def delta_encode(values: np.ndarray) -> bytes:
    lib = _load()
    values = np.ascontiguousarray(values, np.int64)
    cap = max(16, values.size * 10)
    out = np.empty(cap, np.uint8)
    rc = lib.am_delta_encode(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), values.size,
        NULL_SENTINEL,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    return out[:_check(rc, "delta_encode")].tobytes()


def bool_decode(buf: bytes, max_count: int = None) -> np.ndarray:
    lib = _load()
    cap = max_count if max_count is not None else max(16, len(buf) * 4096)
    out = np.empty(cap, np.uint8)
    rc = lib.am_bool_decode(
        _as_u8p(buf), len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    return out[:_check(rc, "bool_decode")].astype(bool)


def strrle_decode(buf: bytes, max_count: int = None):
    """Decodes a string-RLE column; returns (blob bytes, offsets int64[n,2])
    where a row's string is blob[start:end], or (-1, -1) for null."""
    lib = _load()
    cap = max_count if max_count is not None else max(16, len(buf) * 64)
    blob_cap = max(64, len(buf) * 64)
    blob = np.empty(blob_cap, np.uint8)
    offs = np.empty(cap * 2, np.int64)
    rc = lib.am_strrle_decode(
        _as_u8p(buf), len(buf),
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), blob_cap,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    n = _check(rc, "strrle_decode")
    return blob.tobytes(), offs[: 2 * n].reshape(n, 2)


def bool_encode(values: np.ndarray) -> bytes:
    lib = _load()
    values = np.ascontiguousarray(values, np.uint8)
    cap = max(16, values.size * 10 + 16)
    out = np.empty(cap, np.uint8)
    rc = lib.am_bool_encode(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), values.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    return out[:_check(rc, "bool_encode")].tobytes()


if __name__ == "__main__":
    import sys

    if "--build" in sys.argv:
        print(f"native codecs built: {build(verbose=True)}")

"""ctypes bridge to the native NIfTI decoder (native/nifti_loader.cc).

Port of transmf_ad_tpu/data/native_loader.py with the same functions and the
same `available()` contract. The repository's `native/nifti_loader.cc` is
built on first use (g++ -O3, linked against zlib) into the port's own build
directory, `transmf_ad_tpu_torch/_build/`, under a name keyed by a hash of
the source, and never into `native/`. Where no toolchain is found, or the
build fails, every function decodes with the pure-Python NIfTI reader
instead, as the JAX package does: that is host decoding, not a device
kernel. `decode_batch` decodes a whole batch through the C++ worker pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "nifti_loader.cc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    """The built library, compiled now unless one for the same source
    exists; None when the source, g++ or zlib is missing or the build
    fails."""
    try:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    except OSError:
        return None
    lib = BUILD_DIR / f"libnifti_loader_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / "lib.so"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               str(SOURCE), "-o", str(so), "-lz", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(so, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.nifti_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.nifti_decode.restype = ctypes.c_int
        lib.nifti_decode_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.nifti_decode_batch.restype = ctypes.c_int
        lib.nifti_peek_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.nifti_peek_dims.restype = ctypes.c_int
        lib.nifti_pool_init.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native decoder is built and loaded; False means the
    pure-Python decoder runs."""
    return _load() is not None


def peek_dims(path: str):
    lib = _load()
    if lib is None:
        from . import nifti

        return nifti.parse_header(nifti._read_bytes(path)).shape
    dims = (ctypes.c_int * 3)()
    rc = lib.nifti_peek_dims(path.encode(), dims)
    if rc != 0:
        raise ValueError(f"nifti_peek_dims({path}) failed: {rc}")
    return tuple(dims)


def decode(path: str, shape, normalize: bool = True) -> np.ndarray:
    """Decode one volume to C-contiguous float32 (X, Y, Z)."""
    lib = _load()
    if lib is None:
        return _py_decode(path, shape, normalize)
    out = np.empty(shape, np.float32)
    rc = lib.nifti_decode(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        shape[0], shape[1], shape[2], int(normalize),
    )
    if rc != 0:
        raise ValueError(f"nifti_decode({path}) failed: {rc}")
    return out


def decode_batch(paths: Sequence[str], shape,
                 normalize: bool = True) -> np.ndarray:
    """Decode a batch in parallel -> (N, X, Y, Z) float32."""
    lib = _load()
    n = len(paths)
    if lib is None:
        return np.stack([_py_decode(p, shape, normalize) for p in paths])
    out = np.empty((n, *shape), np.float32)
    buf = b"\0".join(p.encode() for p in paths) + b"\0"
    rc = lib.nifti_decode_batch(
        buf, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        shape[0], shape[1], shape[2], int(normalize),
    )
    if rc != 0:
        raise ValueError(f"nifti_decode_batch failed: {rc}")
    return out


def _py_decode(path, shape, normalize):
    from . import nifti

    vol = nifti.load(path)
    if vol.shape != tuple(shape):
        raise ValueError(f"{path}: shape {vol.shape} != expected {shape}")
    if normalize:
        lo, hi = float(vol.min()), float(vol.max())
        vol = (vol - lo) / (hi - lo) if hi > lo else np.zeros_like(vol)
    return vol

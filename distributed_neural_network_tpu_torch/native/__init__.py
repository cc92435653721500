"""Native (C++) host-side data kernels, bound with ctypes (counterpart of
the JAX package's `native/__init__.py`).

`batcher.cpp` is the port's own copy of the JAX package's source, byte for
byte: the CIFAR decode (plane-major uint8 to normalized NHWC float32), the
layout-preserving uint8 normalize, and the row gather + normalize that
assembles a host-streamed batch (`data/stream.py`), each one multithreaded
pass. It is compiled with g++ at first use into the package's gitignored
`_build/` (once per hash of the source), loaded with ctypes and wrapped
here with numpy types.

Every entry point has a numpy version. It runs when `DNN_TPU_NO_NATIVE=1`
asks for it, and, as in the JAX package, when the library cannot be built
or loaded; that case prints why on stderr, and `available()` says which
one runs (`chip_smoke.py` requires the library on the card's machine).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "batcher.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_lock = threading.Lock()
_lib = None
_tried = False


def _disabled() -> bool:
    return os.environ.get("DNN_TPU_NO_NATIVE", "") not in ("", "0")


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"batcher-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a name per process: concurrent first builds (pytest-xdist, ranks on
    # one host) must not write one file; os.replace is atomic
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[native] build failed, using the numpy versions: {e}", file=sys.stderr)
        return None
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _disabled():
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            print(f"[native] load failed, using the numpy versions: {e}", file=sys.stderr)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.cifar_decode_chw_to_nhwc.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, f32p, ctypes.c_int32]
        lib.affine_u8_to_f32.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, f32p, ctypes.c_int32]
        lib.gather_affine_u8.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float, f32p,
            ctypes.c_int32]
        for fn in (lib.cifar_decode_chw_to_nhwc, lib.affine_u8_to_f32, lib.gather_affine_u8):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled library is loaded (the numpy versions run otherwise)."""
    return _load() is not None


def _affine_coeffs(mean: float, std: float) -> tuple[float, float]:
    # out = (x/255 - mean)/std = x * 1/(255*std) - mean/std
    return 1.0 / (255.0 * std), -mean / std


def _as_u8(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.uint8:
        raise TypeError(f"native data kernels take uint8 input, got {a.dtype}")
    return np.ascontiguousarray(a)


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# the numpy versions: what the wrappers run without the library, and what
# the tests hold the library to


def fallback_cifar_decode_normalize(rows_u8, mean, std) -> np.ndarray:
    x = rows_u8.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (x.astype(np.float32) / 255.0 - mean) / std


def fallback_normalize_u8(images_u8, mean, std) -> np.ndarray:
    return (images_u8.astype(np.float32) / 255.0 - mean) / std


def fallback_gather_normalize_u8(images_u8, idx, mean, std) -> np.ndarray:
    return (images_u8[idx].astype(np.float32) / 255.0 - mean) / std


def cifar_decode_normalize(rows_u8: np.ndarray, mean: float, std: float, *,
                           nthreads: int = 0) -> np.ndarray:
    """(N, 3072) plane-major uint8 -> (N, 32, 32, 3) normalized float32."""
    rows_u8 = _as_u8(rows_u8)
    if rows_u8.ndim != 2 or rows_u8.shape[1] != 3072:
        raise ValueError(f"rows must be (N, 3072), got {rows_u8.shape}")
    lib = _load()
    if lib is None:
        return fallback_cifar_decode_normalize(rows_u8, mean, std)
    a, b = _affine_coeffs(mean, std)
    out = np.empty((rows_u8.shape[0], 32, 32, 3), np.float32)
    lib.cifar_decode_chw_to_nhwc(_u8ptr(rows_u8), rows_u8.shape[0], a, b, _f32ptr(out),
                                 nthreads)
    return out


def normalize_u8(images_u8: np.ndarray, mean: float, std: float, *,
                 nthreads: int = 0) -> np.ndarray:
    """Layout-preserving uint8 -> normalized float32 (any shape)."""
    images_u8 = _as_u8(images_u8)
    lib = _load()
    if lib is None:
        return fallback_normalize_u8(images_u8, mean, std)
    a, b = _affine_coeffs(mean, std)
    out = np.empty(images_u8.shape, np.float32)
    lib.affine_u8_to_f32(_u8ptr(images_u8), images_u8.size, a, b, _f32ptr(out), nthreads)
    return out


def gather_normalize_u8(images_u8: np.ndarray, indices: np.ndarray, mean: float, std: float,
                        *, nthreads: int = 0) -> np.ndarray:
    """images_u8[indices] normalized, in one pass: (N, ...) uint8 and (B,)
    integers give (B, ...) float32 (a host-streamed batch)."""
    images_u8 = _as_u8(images_u8)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, got {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= images_u8.shape[0]):
        raise IndexError(f"indices out of range [0, {images_u8.shape[0]}): "
                         f"[{idx.min()}, {idx.max()}]")
    lib = _load()
    if lib is None:
        return fallback_gather_normalize_u8(images_u8, idx, mean, std)
    a, b = _affine_coeffs(mean, std)
    row = int(np.prod(images_u8.shape[1:], dtype=np.int64))
    out = np.empty((idx.shape[0], *images_u8.shape[1:]), np.float32)
    lib.gather_affine_u8(_u8ptr(images_u8), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         idx.shape[0], row, a, b, _f32ptr(out), nthreads)
    return out

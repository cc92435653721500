"""Build a CUDA source of `csrc/` with nvcc, load it with ctypes, and launch
its C entry points on PyTorch's current stream.

Every kernel module of the port goes through here: `build` compiles one
`.cu` file into a shared library under the gitignored `_build/` (once per
hash of the source and flags, so an edited source rebuilds), `load` opens it
with ctypes, and `launch` calls one of its functions with the stream
appended and raises if the function returns a CUDA error (each C entry
point returns `cudaGetLastError()` right after its launch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build(source: str) -> str:
    """Compile `source` (a path) into a shared library once per source hash
    and return the library's path; the compiler's output lands beside it as
    `<name>_<hash>.log`. Raises if nvcc fails."""
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"{stem}_{tag}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    with open(os.path.join(BUILD_DIR, f"{stem}_{tag}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """Build and open `source`; `signatures` maps each C function's name to
    its argument types (the trailing stream argument included). Every
    function returns an int."""
    lib = ctypes.CDLL(build(source))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """Call `name` with `args` and the current stream of `device`; raise on
    a non-zero CUDA error code."""
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")

"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface. The library lands in
`forge_tpu_torch/_build/` (ignored by git), named by a hash of the sources,
so a changed kernel is rebuilt and an unchanged one is loaded as it is. Each
C entry point returns a `cudaError_t` value; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# the `dtype` argument of every entry point (csrc/*.cu dispatch on it)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point → argument types (pointers and the stream as void*)
SIGNATURES = {
    # q, k, v, out, bh, lq, lk, d, scale, dtype, stream
    "forge_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, a, s, w, bias, y, B, C, H, W, O, dtype, stream
    "forge_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's compile, if it compiled
build_log: str = ""


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def nvcc_command(srcs: List[str], out: str, nvcc: str = "nvcc",
                 verbose: bool = False) -> List[str]:
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    if verbose:  # registers, shared memory and spills of every kernel
        cmd.append("-Xptxas=-v")
    return cmd + ["-o", out, *srcs]


def library_path(srcs: Optional[List[str]] = None) -> str:
    h = hashlib.sha256()
    for path in srcs if srcs is not None else sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libforge_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a library for these exact sources exists."""
    global build_seconds, build_log
    srcs = sources()
    out = library_path(srcs)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(srcs, tmp, nvcc_path(), verbose),
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")

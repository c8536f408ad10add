"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (`sm_90a`)
into a shared library with a plain C interface; the compilers run side by
side, so the build takes as long as the slowest file. The libraries land in
`forge_tpu_torch/_build/` (ignored by git), each named by a hash of its
source and of the shared headers (`csrc/*.cuh`), so a changed kernel or
header is rebuilt and an unchanged one is loaded as it is. Each C entry point returns a `cudaError_t` value; `check` raises on
anything but 0.
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
import types
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
    # q, k, v, out, bh, lq, lk, d, scale, dtype, body, stream
    "forge_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # head dim → dynamic shared bytes of the tensor-core body (-1: no instance)
    "forge_flash_attention_wgmma_smem": [_I],
    # x, a, s, w, bias, y, work, B, C, H, W, O, dtype, body, stream
    "forge_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # B, C, H, W, O → parts of the tensor-core body's channel walk (its f32
    # scratch holds that many outputs; 1: none), -1 without a card
    "forge_gn_silu_conv3x3_wgmma_splits": [_I, _I, _I, _I, _I],
    # output channels a block (64, 128, 160, 256) → dynamic shared bytes of
    # the tensor-core body (-1: no instance)
    "forge_gn_silu_conv3x3_wgmma_smem": [_I],
    # x, codes, scales, mins, y, M, N, K, kind, block, dtype, body, stream
    "forge_dequant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # tile rows (128 or 256) → dynamic shared bytes of the tensor-core body
    "forge_dequant_matmul_wgmma_smem": [_I],
}

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None
build_seconds: Optional[float] = None  # wall time of this process's compile, if it compiled
build_log: str = ""


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> List[str]:
    """The headers every source may include; each library's name hashes them."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


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
    for path in (srcs if srcs is not None else sources()) + headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libforge_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> List[str]:
    """Compile every kernel source that has no library for its exact content,
    one nvcc process per source, all started together → library paths."""
    global build_seconds, build_log
    outs = [library_path([src]) for src in sources()]
    todo = [(src, out) for src, out in zip(sources(), outs) if not os.path.exists(out)]
    if not todo:
        return outs
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((src, out, tmp, subprocess.Popen(
            nvcc_command([src], tmp, nvcc_path(), verbose),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, out, tmp, proc in procs:
        log = proc.communicate()[0]
        logs.append(f"== {os.path.basename(src)}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode})")
        else:
            os.replace(tmp, out)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    build_seconds = time.perf_counter() - t0
    return outs


def library() -> types.SimpleNamespace:
    """The kernels' C entry points (`SIGNATURES`), built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            libs = [ctypes.CDLL(path) for path in build()]
            fns = {}
            for name, argtypes in SIGNATURES.items():
                fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned storage: the kernels load 16-byte vectors
    and TMA boxes from it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")

"""Dequantize-matmul for block-quantized weights (port of forge_tpu/ops/dequant_matmul.py).

`dequant_matmul(x2, leaf)` computes y[M, N] = x2[M, K] · dequant(W[N, K])ᵀ
with f32 accumulation. On a CUDA tensor it launches the hand-written kernel
in `csrc/dequant_matmul.cu` (see its header for the design), which decodes
each weight tile on chip from the leaf's native flat layout (ops/quant.py),
so no dequantized weight reaches device memory. The kernel has two bodies,
and `dequant_body` picks one for each call: the tensor-core body (`wgmma`,
the weight decoded into registers as the A operand) for bf16, the SIMT body
(f32 CUDA cores) for f32. On a CPU tensor it runs
`dequant_matmul_plain`: dequantize to the compute dtype, then one matmul.

Unlike the TPU kernel (in % 512, out % 128, else a dequantize fallback that
crashed on prepared leaves: BENCH_r05 `KeyError: 'codes'`), the kernel takes
any M ≥ 1, any N ≥ 1 and any K that is a multiple of the block, so every
quantized Flux linear launches it. On CUDA an unsupported leaf raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import ops
from . import _build
from .quant import CODE_DTYPE, PACKED, SCALE_DTYPE, QuantLeaf, dequantize, lora_epilogue

KIND_CODES = {"q8_0": 0, "nf4": 1, "q4_0": 2, "gq4": 3, "gq8": 4}  # csrc/dequant_matmul.cu
BODY_CODES = {"simt": 0, "wgmma": 1}  # the entry point's `body` argument
BLOCKS = (16, 32, 64)
# Fewest rows that take the tensor-core body in bf16. Measured on an H100: it
# wins from one row on (NF4 1×18432×3072: 0.0870 ms, the SIMT body 0.8213 ms),
# whose 128-row tiles spend their FMAs on the masked rows.
WGMMA_MIN_M = 1


def dequant_body(m: int, dtype: torch.dtype) -> str:
    """The body a CUDA call with m rows of `dtype` runs. f32 stays on the SIMT
    body: TF32 tensor cores would break its 1e-4 bound."""
    return "wgmma" if dtype == torch.bfloat16 and m >= WGMMA_MIN_M else "simt"


def dequant_matmul_plain(x2: torch.Tensor, leaf: QuantLeaf) -> torch.Tensor:
    """Reference math: the weight dequantized to x2's dtype, then x2 @ wᵀ."""
    return x2 @ dequantize(leaf, x2.dtype).T


def _check_leaf(leaf: QuantLeaf, k: int, device: torch.device) -> None:
    kind, block = leaf.kind, leaf.block
    n_out, n_in = leaf.shape
    if kind not in KIND_CODES:
        raise NotImplementedError(f"dequant_matmul: kind {kind!r} has no kernel")
    if n_in != k:
        raise ValueError(f"dequant_matmul: x has {k} columns, weight is {leaf.shape}")
    if block not in BLOCKS or k % block or (kind == "q4_0" and block != 32):
        raise ValueError(f"dequant_matmul: {kind} block {block} does not tile K = {k}")
    per_byte = 2 if kind in PACKED else 1
    n_blocks = n_out * n_in // block
    tensors = [("codes", leaf.codes, CODE_DTYPE[kind], n_out * n_in // per_byte),
               ("scales", leaf.scales, SCALE_DTYPE[kind], n_blocks)]
    if kind in ("gq4", "gq8"):
        if leaf.mins is None:
            raise ValueError(f"dequant_matmul: {kind} leaf has no mins")
        tensors.append(("mins", leaf.mins, torch.float16, n_blocks))
    for name, t, dtype, numel in tensors:
        if t.dtype != dtype or t.numel() != numel or t.device != device:
            raise ValueError(f"dequant_matmul: {kind} {name} must be {numel} {dtype} on "
                             f"{device}, got {t.numel()} {t.dtype} on {t.device}")


def dequant_matmul(x2: torch.Tensor, leaf: QuantLeaf, body: Optional[str] = None) -> torch.Tensor:
    """x2 [M, K] · dequant(leaf [N, K])ᵀ → [M, N] in x2's dtype. `body`
    ("wgmma" or "simt") overrides `dequant_body`'s choice on CUDA."""
    if body is not None and body not in BODY_CODES:
        raise ValueError(f"dequant_matmul: body must be one of {tuple(BODY_CODES)}, not {body!r}")
    if x2.device.type == "cpu":
        return dequant_matmul_plain(x2, leaf)
    if x2.device.type != "cuda":
        raise ValueError(f"dequant_matmul: x must be on a CUDA device, not {x2.device}")
    if x2.dim() != 2:
        raise ValueError(f"dequant_matmul: x must be [M, K], got {tuple(x2.shape)}")
    if x2.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dequant_matmul: dtype {x2.dtype} not supported")
    m, k = x2.shape
    n = leaf.shape[0]
    _check_leaf(leaf, k, x2.device)
    body = body or dequant_body(m, x2.dtype)
    if body == "wgmma" and x2.dtype != torch.bfloat16:
        raise TypeError(f"dequant_matmul: the wgmma body takes bfloat16, not {x2.dtype}")
    y = torch.empty((m, n), device=x2.device, dtype=x2.dtype)
    if m == 0:
        return y
    x2 = _build.aligned(x2)
    codes, scales = _build.aligned(leaf.codes), _build.aligned(leaf.scales)
    mins: Optional[torch.Tensor] = _build.aligned(leaf.mins) if leaf.mins is not None else None
    fn = _build.library().forge_dequant_matmul
    err = fn(x2.data_ptr(), codes.data_ptr(), scales.data_ptr(),
             None if mins is None else mins.data_ptr(), y.data_ptr(), m, n, k,
             KIND_CODES[leaf.kind], leaf.block, _build.DTYPE_CODES[x2.dtype], BODY_CODES[body],
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, f"dequant_matmul ({body} body)")
    dequant_matmul.launches += 1
    dequant_matmul.launches_by_body[body] += 1
    return y


dequant_matmul.launches = 0  # every launch, whichever body
dequant_matmul.launches_by_body = dict.fromkeys(BODY_CODES, 0)


def linear_quantized(x: torch.Tensor, leaf: QuantLeaf,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nn.linear on a quantized leaf: the dequant-matmul, the leaf's online
    LoRA terms, then the bias. Inside `ops.plain_versions()` the product is
    the plain version."""
    out_dim, in_dim = leaf.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_dim)
    y = (dequant_matmul_plain if ops._plain else dequant_matmul)(x2, leaf)
    y = lora_epilogue(y, x2, leaf).reshape(*lead, out_dim)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y

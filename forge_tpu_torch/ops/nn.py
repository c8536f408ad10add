"""Primitive NN ops over checkpoint-layout parameters (port of forge_tpu/ops/nn.py).

Parameters keep the exact layout they have in Stable Diffusion checkpoints:
Linear weights [out, in], conv kernels OIHW. Activations are NCHW, the
checkpoints' own layout, so state dicts load with no transform.

Numerics follow the reference: norm statistics are one-pass E[x²]−E[x]² in
float32 whatever the compute dtype, gelu is erf in float32 and tanh in bf16.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from .dequant_matmul import linear_quantized
from .quant import QuantLeaf


def linear(x: torch.Tensor, p: Mapping[str, Any]) -> torch.Tensor:
    """x [..., in] @ weight[out, in]ᵀ + bias. A quantized weight (NF4/GGUF
    `QuantLeaf`, ops/quant.py) goes to the dequant-matmul kernel; an fp8
    weight (core/loader.py's fp8 storage) is upcast to x's dtype here, on
    every call, and no upcast copy is kept."""
    w = p["weight"]
    bias = p.get("bias")
    if isinstance(w, QuantLeaf):
        return linear_quantized(x, w, bias)
    return F.linear(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype))


def conv2d(x: torch.Tensor, p: Mapping[str, Any], stride: int = 1,
           padding: int = 0, groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """NCHW conv with an OIHW kernel (an fp8 kernel upcast to x's dtype, as in `linear`)."""
    bias = p.get("bias")
    return F.conv2d(x, p["weight"].to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, groups=groups, dilation=dilation)


def conv2d_transpose(x: torch.Tensor, p: Mapping[str, Any], stride: int = 2,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """NCHW transpose conv with the [I, O, kh, kw] kernel torch's
    ConvTranspose2d stores: out = (H − 1)·stride − 2·padding + kh +
    output_padding, the output_padding rows and columns at the bottom and
    right holding the kernel's own contributions (the reference's crop of p
    from the top and left and p − output_padding from the bottom and right)."""
    bias = p.get("bias")
    return F.conv_transpose2d(x, p["weight"].to(x.dtype),
                              None if bias is None else bias.to(x.dtype),
                              stride=stride, padding=padding, output_padding=output_padding)


def group_stats(x: torch.Tensor, num_groups: int, eps: float):
    """One-pass f32 group statistics of NCHW x → (mean, rstd), each [B, G]."""
    b = x.shape[0]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=2)
    m2 = xf.square().mean(dim=2)
    var = (m2 - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def group_norm(
    x: torch.Tensor,
    p: Optional[Mapping[str, Any]] = None,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over NCHW with optional fused SiLU, f32 math."""
    b, c = x.shape[:2]
    mean, rstd = group_stats(x, num_groups, eps)
    xf = x.float().reshape(b, num_groups, -1)
    xf = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    if p is not None:
        bshape = (1, c) + (1,) * (x.dim() - 2)
        xf = xf * p["weight"].float().reshape(bshape) + p["bias"].float().reshape(bshape)
    if act == "silu":
        xf = xf * torch.sigmoid(xf)
    return xf.to(x.dtype)


def layer_norm(x: torch.Tensor, p: Optional[Mapping[str, Any]] = None,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    m2 = xf.square().mean(dim=-1, keepdim=True)
    var = (m2 - mean.square()).clamp_min(0.0)  # one-pass stats (see group_norm)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if p is not None and "weight" in p:
        xf = xf * p["weight"].float()
        if p.get("bias") is not None:
            xf = xf + p["bias"].float()
    return xf.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with f32 statistics."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        xf = xf * weight.float()
    return xf.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu in f32; tanh approximation in bf16, as the reference
    does (its tanh error is far below a bf16 ulp in gelu's active range)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def geglu(x: torch.Tensor, p: Mapping[str, Any]) -> torch.Tensor:
    """GEGLU feed-forward gate used by SD transformer blocks."""
    h, gate = linear(x, p).chunk(2, dim=-1)
    return h * gelu(gate)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] → [B, dim] (cos | sin halves)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW nearest-neighbour 2× upsample."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")

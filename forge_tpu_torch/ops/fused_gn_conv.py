"""Fused GroupNorm + SiLU + conv3x3 (port of forge_tpu/ops/fused_gn_conv.py).

The ResBlock hot path is `conv3x3(silu(group_norm(x)))`. The group statistics
are reduced in one f32 pass in plain torch and folded into a per-channel
affine `a = γ·rsqrt(var+eps)`, `s = β − mean·a` (`gn_affine`); the kernel
`gn_silu_conv3x3(x, a, s, w, bias)` then computes `conv3x3(silu(x·a+s))`
reading x once, with the padding applied after the activation so the pad is
exactly 0. On a CUDA tensor it launches `csrc/gn_silu_conv3x3.cu`; on a CPU
tensor it runs `gn_silu_conv3x3_plain`.

Unlike the TPU gate (C % 128, H·W ≥ 65536, an 8 MB weight cap), every call
on CUDA launches the kernel: the port's dispatch boundary is to be set by
measurement on the H100.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from .. import ops
from . import _build
from .nn import group_norm, group_stats


def gn_affine(x: torch.Tensor, gn_p: Mapping[str, Any], num_groups: int = 32,
              eps: float = 1e-5):
    """One-pass f32 group statistics of NCHW x folded with γ/β → (a, s), [B, C] f32."""
    b, c = x.shape[:2]
    mean, rstd = group_stats(x, num_groups, eps)
    per = c // num_groups
    mean_c = mean.repeat_interleave(per, dim=1)
    rstd_c = rstd.repeat_interleave(per, dim=1)
    a = gn_p["weight"].float()[None] * rstd_c
    s = gn_p["bias"].float()[None] - mean_c * a
    return a.contiguous(), s.contiguous()


def gn_silu_conv3x3_plain(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                          w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference math: f32 affine + SiLU stored in x's dtype, then a padded conv."""
    h = x.float() * a[:, :, None, None] + s[:, :, None, None]
    h = (h * torch.sigmoid(h)).to(x.dtype)
    return F.conv2d(h, w.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=1)


def gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B,C,H,W], a/s [B,C] f32, w [O,C,3,3], bias [O] or None → [B,O,H,W]."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, a, s, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3: x must be on a CUDA device, not {x.device}")
    bsz, c, h, wd = x.shape
    o = w.shape[0]
    if tuple(w.shape) != (o, c, 3, 3):
        raise ValueError(f"gn_silu_conv3x3: weight {tuple(w.shape)} is not [O, {c}, 3, 3]")
    if tuple(a.shape) != (bsz, c) or tuple(s.shape) != (bsz, c):
        raise ValueError("gn_silu_conv3x3: a and s must be [B, C]")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"gn_silu_conv3x3: dtype {x.dtype} not supported")
    dev = x.device
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    a = a.to(dev, torch.float32).contiguous()
    s = s.to(dev, torch.float32).contiguous()
    bias = (torch.zeros(o, device=dev, dtype=torch.float32) if bias is None
            else bias.to(dev, torch.float32).contiguous())
    y = torch.empty((bsz, o, h, wd), device=dev, dtype=x.dtype)
    fn = _build.library().forge_gn_silu_conv3x3
    err = fn(x.data_ptr(), a.data_ptr(), s.data_ptr(), w.data_ptr(), bias.data_ptr(),
             y.data_ptr(), bsz, c, h, wd, o, _build.DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gn_silu_conv3x3")
    gn_silu_conv3x3.launches += 1
    return y


gn_silu_conv3x3.launches = 0


def group_norm_silu_conv3x3(x: torch.Tensor, gn_p: Mapping[str, Any],
                            conv_p: Mapping[str, Any], num_groups: int = 32,
                            eps: float = 1e-5) -> torch.Tensor:
    """conv3x3(silu(group_norm(x))), padding 1: the ResBlock front end."""
    if ops._plain:  # the unfused plain ops, for whole-model comparisons
        h = group_norm(x, gn_p, num_groups=num_groups, eps=eps, act="silu")
        bias = conv_p.get("bias")
        return F.conv2d(h, conv_p["weight"].to(x.dtype),
                        None if bias is None else bias.to(x.dtype), padding=1)
    a, s = gn_affine(x, gn_p, num_groups, eps)
    return gn_silu_conv3x3(x, a, s, conv_p["weight"], conv_p.get("bias"))

"""Fused GroupNorm + SiLU + conv3x3 (port of forge_tpu/ops/fused_gn_conv.py).

The ResBlock hot path is `conv3x3(silu(group_norm(x)))`. The group statistics
are reduced in one f32 pass in plain torch and folded into a per-channel
affine `a = γ·rsqrt(var+eps)`, `s = β − mean·a` (`gn_affine`); the kernel
`gn_silu_conv3x3(x, a, s, w, bias)` then computes `conv3x3(silu(x·a+s))`
reading x once, with the padding applied after the activation so the pad is
exactly 0. On a CUDA tensor it launches `csrc/gn_silu_conv3x3.cu`, which has
two bodies, and `conv_body` picks one for each call: the tensor-core body
(`wgmma`) for bf16 where C is a multiple of 8, the SIMT body (f32 CUDA cores)
otherwise. On a CPU tensor it runs `gn_silu_conv3x3_plain`.

The tensor-core body reads the weight as [O, 3, 3, C] (torch's channels_last
of the OIHW tensor), which the loader gives the fused convs' weights on the
card (`core/loader.py`); a weight in another layout is copied into it on
each call. A weight stored as fp8 is upcast to x's dtype before either body
or the plain version reads it, on each call: no fp8 byte enters the kernel.

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


BODY_CODES = {"simt": 0, "wgmma": 1}  # the entry point's `body` argument


def conv_body(c: int, o: int, dtype: torch.dtype) -> str:
    """The body a CUDA call with C input and O output channels in `dtype`
    runs. The tensor-core body loads the weight by TMA, whose rows of C
    values need a 16-byte stride (C % 8 == 0); O, H and W take no part (it
    masks the channels of its last block past O and ragged pixel tiles).
    f32 stays on the SIMT body: TF32 tensor cores would break its 1e-4
    bound."""
    if dtype == torch.bfloat16 and c % 8 == 0:
        return "wgmma"
    return "simt"


def gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], body: Optional[str] = None) -> torch.Tensor:
    """x [B,C,H,W], a/s [B,C] f32, w [O,C,3,3], bias [O] or None → [B,O,H,W].
    `body` ("wgmma" or "simt") overrides `conv_body`'s choice on CUDA."""
    if body is not None and body not in BODY_CODES:
        raise ValueError(f"gn_silu_conv3x3: body must be one of {tuple(BODY_CODES)}, not {body!r}")
    if body == "wgmma" and x.dtype != torch.bfloat16:
        raise TypeError(f"gn_silu_conv3x3: the wgmma body takes bfloat16, not {x.dtype}")
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
    body = body or conv_body(c, o, x.dtype)
    if body == "wgmma" and c % 8:
        raise ValueError(f"gn_silu_conv3x3: the wgmma body takes C that is a multiple of 8, "
                         f"not {c}")
    dev = x.device
    x = x.contiguous()
    if body == "wgmma":  # [O, 3, 3, C], 16-byte aligned for TMA
        w = w.to(x.dtype).contiguous(memory_format=torch.channels_last)
        if w.data_ptr() % 16:
            w = w.clone(memory_format=torch.channels_last)
    else:
        w = w.to(x.dtype).contiguous()
    a = _build.aligned(a.to(dev, torch.float32))
    s = _build.aligned(s.to(dev, torch.float32))
    bias = (torch.zeros(o, device=dev, dtype=torch.float32) if bias is None
            else bias.to(dev, torch.float32).contiguous())
    y = torch.empty((bsz, o, h, wd), device=dev, dtype=x.dtype)
    lib = _build.library()
    work = None  # the tensor-core body's f32 partial sums where it splits the channel walk
    if body == "wgmma":
        splits = lib.forge_gn_silu_conv3x3_wgmma_splits(bsz, c, h, wd, o)
        if splits < 1:
            raise RuntimeError("gn_silu_conv3x3: the wgmma body's plan could not ask the card")
        if splits > 1:
            work = torch.empty(splits * y.numel(), device=dev, dtype=torch.float32)
    err = lib.forge_gn_silu_conv3x3(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), bsz, c, h, wd, o,
        _build.DTYPE_CODES[x.dtype], BODY_CODES[body], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"gn_silu_conv3x3 ({body} body)")
    gn_silu_conv3x3.launches += 1
    gn_silu_conv3x3.launches_by_body[body] += 1
    return y


gn_silu_conv3x3.launches = 0  # every launch, whichever body
gn_silu_conv3x3.launches_by_body = dict.fromkeys(BODY_CODES, 0)


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

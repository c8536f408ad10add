"""AutoencoderKL over `first_stage_model.*` keys (port of forge_tpu/models/vae.py).

Encoder and decoder resnet stacks with the mid-block single-head spatial
attention, the encoder's asymmetric-pad strided downsample and the
diagonal-Gaussian posterior. Activations NCHW.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.attention import attention_single_head_spatial
from ..ops.fused_gn_conv import group_norm_silu_conv3x3


def _resnet(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = group_norm_silu_conv3x3(x, p["norm1"], p["conv1"], eps=1e-6)
    h = group_norm_silu_conv3x3(h, p["norm2"], p["conv2"], eps=1e-6)
    if "nin_shortcut" in p:
        x = nn.conv2d(x, p["nin_shortcut"])
    return x + h


def _attn(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    b, c, hh, ww = x.shape
    h = nn.group_norm(x, p["norm"], eps=1e-6).reshape(b, c, hh * ww).transpose(1, 2)

    def proj(name, inp):  # the 1×1 convs are channel matmuls on [B, HW, C]
        w = p[name]["weight"]
        return nn.linear(inp, {"weight": w.reshape(w.shape[0], w.shape[1]),
                               "bias": p[name]["bias"]})

    out = attention_single_head_spatial(proj("q", h), proj("k", h), proj("v", h))
    out = proj("proj_out", out)
    return x + out.transpose(1, 2).reshape(b, c, hh, ww)


def encoder_apply(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] → moments [B,2z,H/8,W/8]."""
    h = nn.conv2d(x, p["conv_in"], padding=1)
    down = p["down"]
    for i in range(len(down)):
        level = down[str(i)]
        blocks = level["block"]
        for j in range(len(blocks)):
            h = _resnet(blocks[str(j)], h)
        if "downsample" in level:
            # ldm pads asymmetrically, (0, 1) on W and H, before the stride-2 conv
            h = nn.conv2d(F.pad(h, (0, 1, 0, 1)), level["downsample"]["conv"], stride=2)
    mid = p["mid"]
    h = _resnet(mid["block_1"], h)
    h = _attn(mid["attn_1"], h)
    h = _resnet(mid["block_2"], h)
    h = nn.group_norm(h, p["norm_out"], eps=1e-6, act="silu")
    return nn.conv2d(h, p["conv_out"], padding=1)


def decoder_apply(p: Mapping[str, Any], z: torch.Tensor) -> torch.Tensor:
    """z [B,zc,h,w] → image [B,3,8h,8w] in [-1, 1]."""
    h = nn.conv2d(z, p["conv_in"], padding=1)
    mid = p["mid"]
    h = _resnet(mid["block_1"], h)
    h = _attn(mid["attn_1"], h)
    h = _resnet(mid["block_2"], h)
    up = p["up"]
    for i in reversed(range(len(up))):
        level = up[str(i)]
        blocks = level["block"]
        for j in range(len(blocks)):
            h = _resnet(blocks[str(j)], h)
        if "upsample" in level:
            h = nn.conv2d(nn.upsample_nearest_2x(h), level["upsample"]["conv"], padding=1)
    h = nn.group_norm(h, p["norm_out"], eps=1e-6, act="silu")
    return nn.conv2d(h, p["conv_out"], padding=1)


def vae_encode(params: Mapping[str, Any], x: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image in [-1, 1], NCHW → latent sample: the posterior mean if `noise`
    is None, else mean + std·noise."""
    moments = encoder_apply(params["encoder"], x)
    if "quant_conv" in params:
        moments = nn.conv2d(moments, params["quant_conv"])
    mean, logvar = moments.chunk(2, dim=1)
    if noise is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * noise.to(mean.dtype)


def vae_decode(params: Mapping[str, Any], z: torch.Tensor) -> torch.Tensor:
    if "post_quant_conv" in params:
        z = nn.conv2d(z, params["post_quant_conv"])
    return decoder_apply(params["decoder"], z)

"""Stable Diffusion UNet, SD1.5 and SDXL base (port of forge_tpu/models/unet.py).

A function over the checkpoint's `model.diffusion_model.*` keys, nested by
`.`; activations NCHW. Block structure is discovered from the tree (key
presence), as in the reference: SD1.5's conv `proj_in`/`proj_out` or SDXL's
linear ones on [B, HW, C], and SDXL's label embedding of the size vector `y`
added to the timestep embedding. ControlNet residuals come in through
`control`; hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence

import torch

from ..ops import nn
from ..ops.attention import attention
from ..ops.fused_gn_conv import group_norm_silu_conv3x3


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The family's geometry. `unet_apply` reads the heads from it; the
    projections' kind and the label embedding it finds in the tree."""
    context_dim: int = 768
    num_heads: int = 8          # used when head_dim is None (SD1.5)
    head_dim: Optional[int] = None  # 64 for SDXL

    @staticmethod
    def for_family(family: str) -> "UNetConfig":
        if family == "sd15":
            return UNetConfig(context_dim=768, num_heads=8)
        if family == "sdxl":
            return UNetConfig(context_dim=2048, head_dim=64)
        raise NotImplementedError(f"no ported UNet config for family {family!r}")


def resblock(p: Mapping[str, Any], x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    h = group_norm_silu_conv3x3(x, p["in_layers"]["0"], p["in_layers"]["2"])
    emb_out = nn.linear(nn.silu(emb), p["emb_layers"]["1"])
    h = h + emb_out[:, :, None, None].to(h.dtype)
    h = group_norm_silu_conv3x3(h, p["out_layers"]["0"], p["out_layers"]["3"])
    if "skip_connection" in p:
        x = nn.conv2d(x, p["skip_connection"])
    return x + h


def _attn_block(p: Mapping[str, Any], x: torch.Tensor, context: Optional[torch.Tensor],
                heads: int) -> torch.Tensor:
    ctx = x if context is None else context
    q = nn.linear(x, {"weight": p["to_q"]["weight"]})
    k = nn.linear(ctx, {"weight": p["to_k"]["weight"]})
    v = nn.linear(ctx, {"weight": p["to_v"]["weight"]})
    return nn.linear(attention(q, k, v, heads=heads), p["to_out"]["0"])


def transformer_block(p: Mapping[str, Any], x: torch.Tensor, context: torch.Tensor,
                      heads: int) -> torch.Tensor:
    x = x + _attn_block(p["attn1"], nn.layer_norm(x, p["norm1"]), None, heads)
    x = x + _attn_block(p["attn2"], nn.layer_norm(x, p["norm2"]), context, heads)
    h = nn.geglu(nn.layer_norm(x, p["norm3"]), p["ff"]["net"]["0"]["proj"])
    return x + nn.linear(h, p["ff"]["net"]["2"])


def spatial_transformer(p: Mapping[str, Any], x: torch.Tensor, context: torch.Tensor,
                        cfg: UNetConfig) -> torch.Tensor:
    """Token blocks between proj_in and proj_out: 1×1 convs (SD1.5) or
    linears on [B, HW, C] (SDXL), told apart by the weight's rank."""
    b, c, h, w = x.shape
    heads = cfg.num_heads if cfg.head_dim is None else max(c // cfg.head_dim, 1)
    x_in = x
    x = nn.group_norm(x, p["norm"])
    linear_proj = p["proj_in"]["weight"].dim() == 2
    if linear_proj:
        x = nn.linear(x.reshape(b, c, h * w).transpose(1, 2), p["proj_in"])
    else:
        x = nn.conv2d(x, p["proj_in"]).reshape(b, c, h * w).transpose(1, 2)
    blocks = p["transformer_blocks"]
    for i in range(len(blocks)):
        x = transformer_block(blocks[str(i)], x, context, heads)
    if linear_proj:
        return nn.linear(x, p["proj_out"]).transpose(1, 2).reshape(b, c, h, w) + x_in
    x = x.transpose(1, 2).reshape(b, c, h, w)
    return nn.conv2d(x, p["proj_out"]) + x_in


def _apply_control(h: torch.Tensor, control, kind: str, index: int) -> torch.Tensor:
    """Add a ControlNet residual: control['input'][i] after input block i,
    control['output'][j] on the skip that output step j consumes,
    control['middle'][0] after the middle block."""
    if control is None:
        return h
    residuals = control.get(kind)
    if residuals is None or index >= len(residuals) or residuals[index] is None:
        return h
    return h + residuals[index].to(h.dtype)


def unet_apply(params: Mapping[str, Any], x: torch.Tensor, timesteps: torch.Tensor,
               context: torch.Tensor, y: Optional[torch.Tensor] = None,
               cfg: UNetConfig = UNetConfig(),
               control: Optional[Mapping[str, Sequence[torch.Tensor]]] = None) -> torch.Tensor:
    """x [B,C_latent,H,W], timesteps [B], context [B,L,context_dim],
    y [B, 2816] (SDXL's size conditioning, required when the tree has a
    label embedding), control (models/controlnet.py `run_controlnets`'
    residuals) → eps [B,C,H,W]."""
    model_channels = params["time_embed"]["0"]["weight"].shape[1]
    t_emb = nn.timestep_embedding(timesteps, model_channels, dtype=x.dtype)
    emb = nn.linear(t_emb, params["time_embed"]["0"])
    emb = nn.linear(nn.silu(emb), params["time_embed"]["2"])
    if "label_emb" in params:
        if y is None:
            raise ValueError("this UNet has a label embedding: pass its conditioning y")
        le = params["label_emb"]["0"]
        v = nn.linear(y.to(emb.dtype), le["0"])
        emb = emb + nn.linear(nn.silu(v), le["2"])

    hs: List[torch.Tensor] = []
    h = x
    input_blocks = params["input_blocks"]
    for i in range(len(input_blocks)):
        block = input_blocks[str(i)]
        for j in range(len(block)):
            sub = block[str(j)]
            if "in_layers" in sub:
                h = resblock(sub, h, emb)
            elif "transformer_blocks" in sub:
                h = spatial_transformer(sub, h, context, cfg)
            elif "op" in sub:
                h = nn.conv2d(h, sub["op"], stride=2, padding=1)
            elif "weight" in sub:  # input_blocks.0.0 stem conv
                h = nn.conv2d(h, sub, padding=1)
        h = _apply_control(h, control, "input", i)
        hs.append(h)

    mid = params["middle_block"]
    h = resblock(mid["0"], h, emb)
    h = spatial_transformer(mid["1"], h, context, cfg)
    h = resblock(mid["2"], h, emb)
    h = _apply_control(h, control, "middle", 0)

    output_blocks = params["output_blocks"]
    for i in range(len(output_blocks)):
        block = output_blocks[str(i)]
        h = torch.cat([h, _apply_control(hs.pop(), control, "output", i)], dim=1)
        for j in range(len(block)):
            sub = block[str(j)]
            if "in_layers" in sub:
                h = resblock(sub, h, emb)
            elif "transformer_blocks" in sub:
                h = spatial_transformer(sub, h, context, cfg)
            elif "conv" in sub:  # upsample
                h = nn.conv2d(nn.upsample_nearest_2x(h), sub["conv"], padding=1)

    h = nn.group_norm(h, params["out"]["0"], act="silu")
    return nn.conv2d(h, params["out"]["2"], padding=1)

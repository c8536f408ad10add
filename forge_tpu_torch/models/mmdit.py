"""SD3.x MMDiT over checkpoint keys (port of forge_tpu/models/mmdit.py).

2×2 conv patchify plus a learned positional grid cropped from its centre,
then joint transformer blocks: each a context block and an x block that
share one attention over [text ⊕ image] tokens, modulated (adaLN) by the
timestep and pooled-text embeddings. The last context block is pre-only
(its modulation, q, k and v, no output path). Two optional parts, found by
key presence: SD3.5's per-block q/k RMSNorm (`ln_q`, `ln_k`) and the x-only
second self-attention (`attn2`) of SD3.5-medium's MMDiT-X. A modulated
final layer and the unpatchify end it.

Every joint attention and every `attn2` goes to the flash kernel at any
length (SD3-medium at 1024²: 154 text + 4096 image tokens, 4250, a ragged
tail). The patchify conv, the linears and the modulations stay plain torch.
Latents are NCHW at the public function, the port's layout; the patchify
weight stays OIHW.

Keys: x_embedder.proj, pos_embed, t_embedder.mlp, y_embedder.mlp,
context_embedder, joint_blocks.N.{context_block,x_block}.*, final_layer.*.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from .. import ops
from ..ops import nn
from ..ops.flash_attention import flash_attention, flash_attention_plain


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    num_heads: int = 24  # hidden // 64
    pos_embed_max_size: int = 192


def _modulation(p: Mapping[str, Any], c: torch.Tensor, n: int):
    out = nn.linear(nn.silu(c), p["adaLN_modulation"]["1"])
    return out[:, None, :].chunk(n, dim=-1)  # n × [B, 1, D]


def _attn_qkv(p: Mapping[str, Any], x: torch.Tensor, heads: int):
    """x [B, L, D] → q, k, v [B, H, L, D/H], q and k RMS-normed where the block has ln_q/ln_k."""
    qkv = nn.linear(x, p["qkv"])
    b, l, _ = qkv.shape
    qkv = qkv.reshape(b, l, 3, heads, -1)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if "ln_q" in p:
        q = nn.rms_norm(q, p["ln_q"]["weight"])
        k = nn.rms_norm(k, p["ln_k"]["weight"])
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q/k/v [B, H, L, D] → [B, L, H·D] through the flash kernel, no length cut."""
    fn = flash_attention_plain if ops._plain else flash_attention
    out = fn(q, k, v, 1.0 / math.sqrt(q.shape[-1]))
    b, h, l, d = out.shape
    return out.transpose(1, 2).reshape(b, l, h * d)


def _mlp(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    return nn.linear(nn.gelu(nn.linear(x, p["fc1"])), p["fc2"])


def _modulated(x: torch.Tensor, shift, scale) -> torch.Tensor:
    return nn.layer_norm(x) * (1 + scale) + shift


def joint_block(p: Mapping[str, Any], context: torch.Tensor, x: torch.Tensor,
                c: torch.Tensor, heads: int):
    """One joint block → (context, x); context is None after a pre-only block."""
    cb, xb = p["context_block"], p["x_block"]
    pre_only = "proj" not in cb["attn"]
    if pre_only:
        c_shift, c_scale = _modulation(cb, c, 2)
    else:
        c_shift, c_scale, c_gate, c_shift2, c_scale2, c_gate2 = _modulation(cb, c, 6)
    has_attn2 = "attn2" in xb
    xm = _modulation(xb, c, 9 if has_attn2 else 6)

    cq, ck, cv = _attn_qkv(cb["attn"], _modulated(context, c_shift, c_scale), heads)
    xq, xk, xv = _attn_qkv(xb["attn"], _modulated(x, xm[0], xm[1]), heads)
    out = _attend(torch.cat([cq, xq], dim=2), torch.cat([ck, xk], dim=2),
                  torch.cat([cv, xv], dim=2))
    l_ctx = context.shape[1]
    ctx_attn, x_attn = out[:, :l_ctx], out[:, l_ctx:]

    x_new = x + xm[2] * nn.linear(x_attn, xb["attn"]["proj"])
    if has_attn2:  # MMDiT-X: an x-only self-attention from the block's input
        q2, k2, v2 = _attn_qkv(xb["attn2"], _modulated(x, xm[6], xm[7]), heads)
        x_new = x_new + xm[8] * nn.linear(_attend(q2, k2, v2), xb["attn2"]["proj"])
    x = x_new + xm[5] * _mlp(xb["mlp"], _modulated(x_new, xm[3], xm[4]))

    if pre_only:
        return None, x
    context = context + c_gate * nn.linear(ctx_attn, cb["attn"]["proj"])
    context = context + c_gate2 * _mlp(cb["mlp"], _modulated(context, c_shift2, c_scale2))
    return context, x


def cropped_pos_embed(pos_embed: torch.Tensor, hh: int, ww: int, max_size: int) -> torch.Tensor:
    """The centre hh × ww window of the max_size² grid → [1, hh·ww, D]."""
    grid = pos_embed.reshape(1, max_size, max_size, -1)
    top, left = (max_size - hh) // 2, (max_size - ww) // 2
    return grid[:, top:top + hh, left:left + ww].reshape(1, hh * ww, -1)


def mmdit_apply(params: Mapping[str, Any], x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, y: Optional[torch.Tensor] = None,
                cfg: Optional[MMDiTConfig] = None) -> torch.Tensor:
    """x [B, 16, h, w] latent, timesteps [B] (σ·1000), context [B, L, 4096]
    (CLIP-L ‖ CLIP-G zero-padded, ⊕ T5), y [B, 2048] (pooled L ‖ G) →
    velocity [B, 16, h, w]. `cfg` None: 64-wide heads."""
    proj = params["x_embedder"]["proj"]
    hidden = proj["bias"].shape[0]
    cfg = cfg or MMDiTConfig(num_heads=hidden // 64)
    b, c_in, h, w = x.shape
    ps = cfg.patch_size
    hh, ww = h // ps, w // ps

    img = F.conv2d(x, proj["weight"].to(x.dtype), proj["bias"].to(x.dtype), stride=ps)
    img = img.flatten(2).transpose(1, 2)  # [B, hh·ww, hidden], row-major over the patches
    if "pos_embed" in params:
        pos = params["pos_embed"]
        max_size = int(round(math.sqrt(pos.shape[1])))  # the trained grid's side
        img = img + cropped_pos_embed(pos, hh, ww, max_size).to(img.dtype)

    t_emb = nn.timestep_embedding(timesteps.float(), 256, dtype=torch.float32)
    te = params["t_embedder"]["mlp"]
    c = nn.linear(nn.silu(nn.linear(t_emb.to(img.dtype), te["0"])), te["2"])
    if y is not None and "y_embedder" in params:
        ye = params["y_embedder"]["mlp"]
        c = c + nn.linear(nn.silu(nn.linear(y.to(img.dtype), ye["0"])), ye["2"])

    ctx = nn.linear(context.to(img.dtype), params["context_embedder"])
    blocks = params["joint_blocks"]
    for i in range(len(blocks)):
        ctx, img = joint_block(blocks[str(i)], ctx, img, c, cfg.num_heads)

    fl = params["final_layer"]
    shift, scale = _modulation(fl, c, 2)
    out = nn.linear(_modulated(img, shift, scale), fl["linear"])  # [B, hh·ww, ps·ps·C]
    return (out.reshape(b, hh, ww, ps, ps, c_in).permute(0, 5, 1, 3, 2, 4)
            .reshape(b, c_in, h, w))

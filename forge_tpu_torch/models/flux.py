"""Flux (double/single-stream MMDiT) over checkpoint keys (port of forge_tpu/models/flux.py).

2×2-patchified latents and T5 text tokens through 19 double-stream blocks
(separate img/txt weights, joint attention) and 38 single-stream blocks,
with 3-axis RoPE, QK RMSNorm, adaLN modulation from (timestep ⊕ guidance ⊕
CLIP-pooled) vectors and the distilled-CFG guidance embedding. Every linear
goes through `nn.linear`, so quantized weights run the dequant-matmul
kernel; the joint attention goes to the flash kernel at any length.
Latents are NCHW at the public function, the port's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch

from .. import ops
from ..ops import nn
from ..ops.flash_attention import flash_attention, flash_attention_plain


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    num_heads: int = 24
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    guidance_embed: bool = True  # flux-dev; schnell has none
    patch_size: int = 2


def rope_freqs(pos: torch.Tensor, dim: int, theta: int) -> torch.Tensor:
    """pos [..., L] → [..., L, dim/2, 2] (cos, sin) at Flux frequencies."""
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.float()[..., None] * omega
    return torch.stack([torch.cos(out), torch.sin(out)], dim=-1)


def embed_nd(ids: torch.Tensor, axes_dim, theta: int) -> torch.Tensor:
    """ids [B, L, n_axes] → [B, L, D/2, 2], the per-axis tables concatenated."""
    return torch.cat([rope_freqs(ids[..., i], axes_dim[i], theta)
                      for i in range(len(axes_dim))], dim=-2)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [B, H, L, D], freqs [B, L, D/2, 2] → x rotated pairwise, in f32."""
    b, h, l, d = x.shape
    xf = x.float().reshape(b, h, l, d // 2, 2)
    cos = freqs[:, None, :, :, 0]
    sin = freqs[:, None, :, :, 1]
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([cos * x1 - sin * x2, sin * x1 + cos * x2], dim=-1)
    return out.reshape(b, h, l, d).to(x.dtype)


def _mlp_embedder(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    return nn.linear(nn.silu(nn.linear(x, p["in_layer"])), p["out_layer"])


def _modulation(p: Mapping[str, Any], vec: torch.Tensor, n: int):
    out = nn.linear(nn.silu(vec), p["lin"])
    return out[:, None, :].chunk(n, dim=-1)  # n × [B, 1, D]


def _qk_norm(p: Mapping[str, Any], q: torch.Tensor, k: torch.Tensor):
    return (nn.rms_norm(q, p["query_norm"]["scale"]),
            nn.rms_norm(k, p["key_norm"]["scale"]))


def _split_qkv(qkv: torch.Tensor, heads: int):
    b, l, _ = qkv.shape
    qkv = qkv.reshape(b, l, 3, heads, -1)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))  # each [B, H, L, D]


def _joint_attention(q, k, v, pe) -> torch.Tensor:
    """q/k/v [B, H, L, D] with RoPE pe [B, L, D/2, 2] → [B, L, H·D]."""
    q = apply_rope(q, pe)
    k = apply_rope(k, pe)
    fn = flash_attention_plain if ops._plain else flash_attention
    out = fn(q, k, v, 1.0 / (q.shape[-1] ** 0.5))
    b, h, l, d = out.shape
    return out.transpose(1, 2).reshape(b, l, h * d)


def _modulated(x: torch.Tensor, shift, scale) -> torch.Tensor:
    return nn.layer_norm(x) * (1 + scale) + shift


def double_block(p: Mapping[str, Any], img, txt, vec, pe, cfg: FluxConfig):
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = _modulation(p["img_mod"], vec, 6)
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = _modulation(p["txt_mod"], vec, 6)

    iq, ik, iv = _split_qkv(nn.linear(_modulated(img, i_shift1, i_scale1),
                                      p["img_attn"]["qkv"]), cfg.num_heads)
    iq, ik = _qk_norm(p["img_attn"]["norm"], iq, ik)
    tq, tk, tv = _split_qkv(nn.linear(_modulated(txt, t_shift1, t_scale1),
                                      p["txt_attn"]["qkv"]), cfg.num_heads)
    tq, tk = _qk_norm(p["txt_attn"]["norm"], tq, tk)

    attn = _joint_attention(torch.cat([tq, iq], dim=2), torch.cat([tk, ik], dim=2),
                            torch.cat([tv, iv], dim=2), pe)
    txt_attn, img_attn = attn[:, : txt.shape[1]], attn[:, txt.shape[1]:]

    img = img + i_gate1 * nn.linear(img_attn, p["img_attn"]["proj"])
    img = img + i_gate2 * nn.linear(
        nn.gelu(nn.linear(_modulated(img, i_shift2, i_scale2), p["img_mlp"]["0"])),
        p["img_mlp"]["2"])
    txt = txt + t_gate1 * nn.linear(txt_attn, p["txt_attn"]["proj"])
    txt = txt + t_gate2 * nn.linear(
        nn.gelu(nn.linear(_modulated(txt, t_shift2, t_scale2), p["txt_mlp"]["0"])),
        p["txt_mlp"]["2"])
    return img, txt


def single_block(p: Mapping[str, Any], x, vec, pe, cfg: FluxConfig):
    shift, scale, gate = _modulation(p["modulation"], vec, 3)
    hidden = nn.linear(_modulated(x, shift, scale), p["linear1"])
    d_model = x.shape[-1]
    qkv, mlp = hidden[..., : 3 * d_model], hidden[..., 3 * d_model:]
    q, k, v = _split_qkv(qkv, cfg.num_heads)
    q, k = _qk_norm(p["norm"], q, k)
    attn = _joint_attention(q, k, v, pe)
    return x + gate * nn.linear(torch.cat([attn, nn.gelu(mlp)], dim=-1), p["linear2"])


def final_layer(p: Mapping[str, Any], x, vec):
    shift, scale = nn.linear(nn.silu(vec), p["adaLN_modulation"]["1"])[:, None, :].chunk(2, dim=-1)
    return nn.linear(_modulated(x, shift, scale), p["linear"])


def position_ids(b: int, l_txt: int, hh: int, ww: int, device) -> torch.Tensor:
    """[B, L_txt + hh·ww, 3]: text tokens at 0, image token (i, j) at (0, i, j)."""
    ii = torch.arange(hh, dtype=torch.float32, device=device).repeat_interleave(ww)
    jj = torch.arange(ww, dtype=torch.float32, device=device).repeat(hh)
    img_ids = torch.stack([torch.zeros_like(ii), ii, jj], dim=-1)
    txt_ids = torch.zeros((l_txt, 3), dtype=torch.float32, device=device)
    return torch.cat([txt_ids, img_ids], dim=0)[None].expand(b, -1, -1)


def patchify(x: torch.Tensor, ps: int) -> torch.Tensor:
    """NCHW latent → [B, hh·ww, C·ps·ps] tokens, features channel-major "(c ph pw)"."""
    b, c, h, w = x.shape
    hh, ww = h // ps, w // ps
    return (x.reshape(b, c, hh, ps, ww, ps).permute(0, 2, 4, 1, 3, 5)
            .reshape(b, hh * ww, c * ps * ps))


def unpatchify(tokens: torch.Tensor, c: int, h: int, w: int, ps: int) -> torch.Tensor:
    b = tokens.shape[0]
    hh, ww = h // ps, w // ps
    return (tokens.reshape(b, hh, ww, c, ps, ps).permute(0, 3, 1, 4, 2, 5)
            .reshape(b, c, h, w))


def flux_apply(params: Mapping[str, Any], x: torch.Tensor, timesteps: torch.Tensor,
               context: torch.Tensor, y: torch.Tensor,
               guidance: Optional[torch.Tensor] = None,
               cfg: FluxConfig = FluxConfig()) -> torch.Tensor:
    """x [B, 16, h, w] latent, timesteps [B] (σ·1000), context [B, L_txt, 4096]
    T5 features, y [B, 768] CLIP-L pooled, guidance [B] → velocity [B, 16, h, w]."""
    b, c, h, w = x.shape
    ps = cfg.patch_size
    img = nn.linear(patchify(x, ps), params["img_in"])
    txt = nn.linear(context, params["txt_in"])

    t_vec = nn.timestep_embedding(timesteps.float(), 256, dtype=torch.float32)
    vec = _mlp_embedder(params["time_in"], t_vec.to(img.dtype))
    if cfg.guidance_embed and "guidance_in" in params:
        if guidance is None:
            guidance = torch.full((b,), 3.5, dtype=torch.float32, device=x.device)
        g_vec = nn.timestep_embedding(guidance.float() * 1000.0, 256, dtype=torch.float32)
        vec = vec + _mlp_embedder(params["guidance_in"], g_vec.to(img.dtype))
    vec = vec + _mlp_embedder(params["vector_in"], y.to(img.dtype))

    l_txt = context.shape[1]
    pe = embed_nd(position_ids(b, l_txt, h // ps, w // ps, x.device), cfg.axes_dim, cfg.theta)

    dbs = params["double_blocks"]
    for i in range(len(dbs)):
        img, txt = double_block(dbs[str(i)], img, txt, vec, pe, cfg)
    x_seq = torch.cat([txt, img], dim=1)
    sbs = params["single_blocks"]
    for i in range(len(sbs)):
        x_seq = single_block(sbs[str(i)], x_seq, vec, pe, cfg)
    out = final_layer(params["final_layer"], x_seq[:, l_txt:], vec)
    return unpatchify(out, c, h, w, ps)

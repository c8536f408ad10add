"""Chroma: Flux with the per-block modulations from one Approximator (port of forge_tpu/models/chroma.py).

Chroma's adaLN modulations do not come from (time ⊕ guidance ⊕ pooled)
MLPs: a small "distilled_guidance_layer" Approximator maps
[emb16(t) ‖ emb16(0) ‖ emb32(slot index)] to one modulation vector per slot.
Slot order: the single blocks (3 each: shift, scale, gate), then the double
blocks' image modulations (6 each), then their text modulations (6 each),
then the final layer's (shift, scale): 344 slots at 19 + 38 blocks. The
blocks are Flux's (joint attention on the flash kernel, 3-axis RoPE, QK
RMSNorm; gelu in its tanh form at every dtype, where the port's Flux takes
erf in f32); every linear goes through `nn.linear`. Latents are NCHW at the
public function, the port's layout. Chroma has no pooled vector and no
guidance input: `y` and `guidance` are taken and not read.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops import nn
from .flux import (FluxConfig, _joint_attention, _modulated, _qk_norm, _split_qkv, embed_nd,
                   patchify, position_ids, unpatchify)


def approximator(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The distilled guidance layer: in_proj, residual RMSNorm → SiLU MLP layers, out_proj."""
    x = nn.linear(x, p["in_proj"])
    layers, norms = p["layers"], p["norms"]
    for i in range(len(layers)):
        h = nn.rms_norm(x, norms[str(i)]["scale"])
        h = nn.linear(nn.silu(nn.linear(h, layers[str(i)]["in_layer"])),
                      layers[str(i)]["out_layer"])
        x = x + h
    return nn.linear(x, p["out_proj"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # the tanh form at every dtype, as the reference's


def _emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    # the reference's flux timestep_embedding multiplies t by 1000 itself
    return nn.timestep_embedding(t * 1000.0, dim, dtype=torch.float32)


def modulation_slots(n_double: int, n_single: int) -> int:
    return n_double * 12 + n_single * 3 + 2


def chroma_apply(params: Mapping[str, Any], x: torch.Tensor, timesteps: torch.Tensor,
                 context: torch.Tensor, y: Optional[torch.Tensor] = None,
                 guidance: Optional[torch.Tensor] = None,
                 cfg: FluxConfig = FluxConfig(guidance_embed=False)) -> torch.Tensor:
    """x [B, 16, h, w] latent, timesteps [B] (σ·1000), context [B, L_txt, 4096]
    T5 features → velocity [B, 16, h, w]."""
    b, c, h, w = x.shape
    ps = cfg.patch_size
    img = nn.linear(patchify(x, ps), params["img_in"])
    txt = nn.linear(context, params["txt_in"])

    dbs, sbs = params["double_blocks"], params["single_blocks"]
    nd, ns = len(dbs), len(sbs)
    n_slots = modulation_slots(nd, ns)
    t01 = timesteps.float() / 1000.0
    tg = torch.cat([_emb(t01, 16), _emb(torch.zeros_like(t01), 16)], dim=-1)  # [B, 32]
    index = _emb(torch.arange(n_slots, dtype=torch.float32, device=x.device), 32)  # [S, 32]
    approx_in = torch.cat([tg[:, None, :].expand(b, n_slots, 32),
                           index[None].expand(b, n_slots, 32)], dim=-1)
    mods = approximator(params["distilled_guidance_layer"], approx_in.to(img.dtype))

    def slots(first: int, n: int):
        return tuple(mods[:, i:i + 1, :] for i in range(first, first + n))  # each [B, 1, D]

    single_at, img_at, txt_at = 0, 3 * ns, 3 * ns + 6 * nd
    final_shift, final_scale = slots(txt_at + 6 * nd, 2)

    l_txt = context.shape[1]
    pe = embed_nd(position_ids(b, l_txt, h // ps, w // ps, x.device), cfg.axes_dim, cfg.theta)

    for i in range(nd):
        p = dbs[str(i)]
        i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = slots(img_at + 6 * i, 6)
        t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = slots(txt_at + 6 * i, 6)
        iq, ik, iv = _split_qkv(nn.linear(_modulated(img, i_shift1, i_scale1),
                                          p["img_attn"]["qkv"]), cfg.num_heads)
        iq, ik = _qk_norm(p["img_attn"]["norm"], iq, ik)
        tq, tk, tv = _split_qkv(nn.linear(_modulated(txt, t_shift1, t_scale1),
                                          p["txt_attn"]["qkv"]), cfg.num_heads)
        tq, tk = _qk_norm(p["txt_attn"]["norm"], tq, tk)
        attn = _joint_attention(torch.cat([tq, iq], dim=2), torch.cat([tk, ik], dim=2),
                                torch.cat([tv, iv], dim=2), pe)
        txt_attn, img_attn = attn[:, :l_txt], attn[:, l_txt:]
        img = img + i_gate1 * nn.linear(img_attn, p["img_attn"]["proj"])
        img = img + i_gate2 * nn.linear(
            _gelu(nn.linear(_modulated(img, i_shift2, i_scale2), p["img_mlp"]["0"])),
            p["img_mlp"]["2"])
        txt = txt + t_gate1 * nn.linear(txt_attn, p["txt_attn"]["proj"])
        txt = txt + t_gate2 * nn.linear(
            _gelu(nn.linear(_modulated(txt, t_shift2, t_scale2), p["txt_mlp"]["0"])),
            p["txt_mlp"]["2"])

    x_seq = torch.cat([txt, img], dim=1)
    d_model = x_seq.shape[-1]
    for i in range(ns):
        p = sbs[str(i)]
        shift, scale, gate = slots(single_at + 3 * i, 3)
        hidden = nn.linear(_modulated(x_seq, shift, scale), p["linear1"])
        qkv, mlp = hidden[..., : 3 * d_model], hidden[..., 3 * d_model:]
        q, k, v = _split_qkv(qkv, cfg.num_heads)
        q, k = _qk_norm(p["norm"], q, k)
        attn = _joint_attention(q, k, v, pe)
        x_seq = x_seq + gate * nn.linear(torch.cat([attn, _gelu(mlp)], dim=-1), p["linear2"])

    out = nn.linear(_modulated(x_seq[:, l_txt:], final_shift, final_scale),
                    params["final_layer"]["linear"])
    return unpatchify(out, c, h, w, ps)

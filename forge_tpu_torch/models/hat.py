# Copied from forge_tpu/models/hat.py (the hybrid attention block, the overlapping cross-attention block, hat_apply, load_hat and infer_hat_meta), in PyTorch.
"""HAT, the Hybrid Attention Transformer (XPixelGroup/HAT hat_arch.py).

SwinIR-style residual groups in which every block adds a channel-attention
conv branch (CAB, weighted by 0.01) to window attention, and each group
ends with an overlapping cross-attention block (OCAB) whose keys and values
come from enlarged windows (`F.unfold`, as upstream). The relative position
indices are recomputed here (HAT computes them in its constructor and the
released files keep them only as top-level buffers, which are not read).
Reuses the port's SwinIR helpers, as the reference reuses its own; like
them, attention is `torch.matmul` and a softmax, no kernel.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from .swinir import (RGB_MEAN, body, device_constant, group_conv, mlp, pad_input,
                     pixelshuffle_tail, shifted_windows, to_image, to_tokens, unwrap,
                     upsample_scale, window_attention, window_partition, window_reverse)


@functools.lru_cache(maxsize=8)
def swin_rel_index(ws: int) -> np.ndarray:
    """The Swin relative-position index [ws², ws²] (HAT calculate_rpi_sa)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int64)


@functools.lru_cache(maxsize=8)
def oca_rel_index(ws: int, owin: int) -> np.ndarray:
    """OCAB's q (ws) ↔ kv (owin) relative index [ws², owin²] (calculate_rpi_oca)."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(owin), np.arange(owin), indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (ws + owin - 1) + rel[:, :, 1]).astype(np.int64)


def _table_bias(table: torch.Tensor, fn, args: tuple) -> torch.Tensor:
    """The trained table [n, heads] at the index `fn(*args)` [Lq, Lk] → [heads, Lq, Lk]."""
    idx = device_constant(fn, args, table.device)
    return table[idx.reshape(-1)].reshape(*idx.shape, -1).permute(2, 0, 1)


def _cab(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The channel attention block on NCHW (hat_arch CAB + ChannelAttention)."""
    cab = p["cab"]
    h = nn.conv2d(F.gelu(nn.conv2d(x, cab["0"], padding=1)), cab["2"], padding=1)
    att = cab["3"]["attention"]
    s = torch.sigmoid(nn.conv2d(F.relu(nn.conv2d(h.mean(dim=(2, 3), keepdim=True), att["1"])),
                                att["3"]))
    return h * s


def _hab(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], ws: int, heads: int,
         shift: int, conv_scale: float = 0.01) -> torch.Tensor:
    """The hybrid attention block: window attention + conv_scale·CAB + MLP."""
    h, w = hw
    b, l, c = x.shape
    y = nn.layer_norm(x, p["norm1"])
    conv_x = to_tokens(_cab(p["conv_block"], to_image(y, h, w)))
    bias = _table_bias(p["attn"]["relative_position_bias_table"], swin_rel_index, (ws,))
    y = shifted_windows(y.reshape(b, h, w, c), ws, shift, lambda win, mask: window_attention(
        p["attn"], win, bias, heads, mask))
    x = x + y.reshape(b, l, c) + conv_x * conv_scale
    return x + mlp(p["mlp"], nn.layer_norm(x, p["norm2"]))


def _ocab(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], ws: int, heads: int,
          overlap_ratio: float) -> torch.Tensor:
    """The overlapping cross-attention block (hat_arch OCAB)."""
    h, w = hw
    b, l, c = x.shape
    owin = int(overlap_ratio * ws) + ws
    d = c // heads
    qkv = nn.linear(nn.layer_norm(x, p["norm1"]), p["qkv"]).reshape(b, h, w, 3, c)
    qw = window_partition(qkv[..., 0, :], ws)  # [nW, ws², C]
    kv = qkv[..., 1:, :].reshape(b, h, w, 2 * c).permute(0, 3, 1, 2)
    kvw = F.unfold(kv, kernel_size=owin, stride=ws, padding=(owin - ws) // 2)
    nw = kvw.shape[-1]
    kvw = kvw.reshape(b, 2, c, owin * owin, nw).permute(1, 0, 4, 3, 2).reshape(
        2, b * nw, owin * owin, c)
    qh = qw.reshape(-1, ws * ws, heads, d).transpose(1, 2)
    kh = kvw[0].reshape(-1, owin * owin, heads, d).transpose(1, 2)
    vh = kvw[1].reshape(-1, owin * owin, heads, d).transpose(1, 2)
    attn = (qh * d ** -0.5) @ kh.transpose(-2, -1)
    bias = _table_bias(p["relative_position_bias_table"], oca_rel_index, (ws, owin))
    attn = F.softmax(attn + bias[None].to(attn.dtype), dim=-1)
    out = (attn @ vh).transpose(1, 2).reshape(-1, ws * ws, c)
    x = x + nn.linear(window_reverse(out, ws, h, w).reshape(b, l, c), p["proj"])
    return x + mlp(p["mlp"], nn.layer_norm(x, p["norm2"]))


def _rhag(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], ws: int, heads: int,
          overlap_ratio: float) -> torch.Tensor:
    """The residual hybrid attention group: HABs (alternating shift), OCAB, conv."""
    res = x
    g = p["residual_group"]
    for j in range(len(g["blocks"])):
        x = _hab(g["blocks"][str(j)], x, hw, ws, heads, 0 if j % 2 == 0 else ws // 2)
    x = _ocab(g["overlap_attn"], x, hw, ws, heads, overlap_ratio)
    return res + group_conv(p["conv"], x, hw)


def hat_apply(params: Mapping[str, Any], img: torch.Tensor, window_size: int = 16,
              heads: int = 6, scale: int = 4, overlap_ratio: float = 0.5) -> torch.Tensor:
    """img [B,3,H,W] in [0, 1] → upscaled [B,3,sH,sW] (HAT.forward)."""
    x, h0, w0 = pad_input(img, window_size)
    x = body(params, x, lambda p, t, hw: _rhag(p, t, hw, window_size, heads, overlap_ratio))
    x = pixelshuffle_tail(params, x, scale)
    out = x + torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    return out[:, :, : h0 * scale, : w0 * scale]


def load_hat(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint's state dict → the nested tree (the wrapper unwrapped;
    `attn_mask` and `relative_position_index` buffers dropped)."""
    from ..core.convert import nest

    return nest({k: v for k, v in unwrap(sd).items()
                 if not (k.endswith("attn_mask") or k.endswith("relative_position_index"))})


def infer_hat_meta(params: Mapping[str, Any]) -> Dict[str, Any]:
    """(window size, heads, scale, overlap ratio) from the checkpoint's shapes."""
    table = params["layers"]["0"]["residual_group"]["blocks"]["0"]["attn"][
        "relative_position_bias_table"]
    ws = (int(np.sqrt(table.shape[0])) + 1) // 2
    oca = params["layers"]["0"]["residual_group"]["overlap_attn"]
    side = int(np.sqrt(oca["relative_position_bias_table"].shape[0]))  # ws + owin − 1
    return {"window_size": ws, "heads": int(table.shape[1]), "scale": upsample_scale(params),
            "overlap_ratio": (side + 1 - 2 * ws) / ws}


# Copied from forge_tpu/models/dat.py (the axial rectangle attention with its dynamic position bias, the adaptive channel attention, the SGFN, dat_apply, load_dat and infer_dat_meta), in PyTorch.
"""DAT, the Dual Aggregation Transformer (zhengchen1999/DAT dat_arch.py).

Blocks alternate between adaptive spatial attention (rectangular axial
windows, two orthogonal branches over half the heads each, a bias from the
dynamic-position MLP) and adaptive channel attention (transposed attention
with a learned temperature); each is fused with a parallel depthwise conv
branch (batch norm in eval) through mutual sigmoid gates. The FFN is the
spatial-gated SGFN. Spatial blocks at even positions, channel blocks at odd
ones; a spatial block is shifted where (i // 2) is odd, the reference's
schedule. Attention is `torch.matmul` and a softmax, no kernel.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from .swinir import (RGB_MEAN, body, device_constant, pad_input, pixelshuffle_tail,
                     to_image, to_tokens, unwrap, upsample_scale)


def _bn(p: Mapping[str, Any], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in eval (running statistics) on NCHW."""
    shape = (1, -1, 1, 1)
    mean, var = p["running_mean"].to(x.dtype), p["running_var"].to(x.dtype)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(shape)
    return y * p["weight"].to(x.dtype).reshape(shape) + p["bias"].to(x.dtype).reshape(shape)


@functools.lru_cache(maxsize=16)
def rect_rel_coords(h: int, w: int):
    """The dynamic-position MLP's inputs [(2h−1)(2w−1), 2] (the offsets) and
    the index [h·w, h·w] into its output."""
    bh, bw = np.arange(1 - h, h), np.arange(1 - w, w)
    biases = np.stack(np.meshgrid(bh, bw, indexing="ij")).reshape(2, -1).T
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + np.array([h - 1, w - 1])
    idx = rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]
    return biases.astype(np.float32), idx.astype(np.int64)


def _rect_offsets(h: int, w: int) -> np.ndarray:
    return rect_rel_coords(h, w)[0]


def _rect_index(h: int, w: int) -> np.ndarray:
    return rect_rel_coords(h, w)[1].reshape(-1)


def _dyn_pos_bias(p: Mapping[str, Any], hw: Tuple[int, int], heads: int,
                  dtype: torch.dtype, device) -> torch.Tensor:
    """DynamicPosBias → [heads, L, L] for an h×w window."""
    biases = device_constant(_rect_offsets, hw, device).to(dtype)
    t = nn.linear(biases, p["pos_proj"])
    for stage in ("pos1", "pos2", "pos3"):
        t = nn.linear(F.relu(nn.layer_norm(t, p[stage]["0"])), p[stage]["2"])
    l = hw[0] * hw[1]
    idx = device_constant(_rect_index, hw, device)
    return t[idx].reshape(l, l, heads).permute(2, 0, 1)


def _rect_partition(x: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // rh, rh, w // rw, rw, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, rh * rw, c)


def _rect_reverse(win: torch.Tensor, rh: int, rw: int, h: int, w: int) -> torch.Tensor:
    b = win.shape[0] // (h * w // rh // rw)
    x = win.reshape(b, h // rh, w // rw, rh, rw, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=16)
def _rect_shift_mask(h: int, w: int, rh: int, rw: int) -> np.ndarray:
    """The rolled rectangle grid's region mask [nW, L, L] (−100 across regions)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -rh), slice(-rh, -(rh // 2) or None), slice(-(rh // 2) or None, None)):
        for wsl in (slice(0, -rw), slice(-rw, -(rw // 2) or None),
                    slice(-(rw // 2) or None, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // rh, rh, w // rw, rw).transpose(0, 2, 1, 3).reshape(-1, rh * rw)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _spatial_branch(p: Mapping[str, Any], qkv: torch.Tensor, hw: Tuple[int, int],
                    rect: Tuple[int, int], heads: int, shift: bool) -> torch.Tensor:
    """One axial-window branch (dat_arch Spatial_Attention); qkv [3,B,H,W,Cb] → [B,H,W,Cb]."""
    h, w = hw
    rh, rw = min(rect[0], h), min(rect[1], w)
    c = qkv.shape[-1]
    d = c // heads
    if shift:
        qkv = torch.roll(qkv, (-(rh // 2), -(rw // 2)), dims=(2, 3))
    q, k, v = (_rect_partition(qkv[i], rh, rw) for i in range(3))
    nw, l, _ = q.shape
    qh, kh, vh = (t.reshape(nw, l, heads, d).transpose(1, 2) for t in (q, k, v))
    attn = (qh * d ** -0.5) @ kh.transpose(-2, -1)
    attn = attn + _dyn_pos_bias(p["pos"], (rh, rw), heads, attn.dtype, attn.device)[None]
    if shift:
        mask = device_constant(_rect_shift_mask, (h, w, rh, rw), attn.device).to(attn.dtype)
        m = mask.shape[0]
        attn = (attn.reshape(nw // m, m, heads, l, l) + mask[None, :, None]).reshape(
            nw, heads, l, l)
    out = (F.softmax(attn, dim=-1) @ vh).transpose(1, 2).reshape(nw, l, c)
    out = _rect_reverse(out, rh, rw, h, w)
    if shift:
        out = torch.roll(out, (rh // 2, rw // 2), dims=(1, 2))
    return out


def _dwconv(p: Mapping[str, Any], v_img: torch.Tensor) -> torch.Tensor:
    """The depthwise conv branch: conv 3×3 per channel, batch norm, gelu (NCHW)."""
    return F.gelu(_bn(p["1"], nn.conv2d(v_img, p["0"], padding=1, groups=v_img.shape[1])))


def _channel_map(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """channel_interaction: spatial mean → 1×1 → bn → gelu → 1×1 (NCHW → [B,C,1,1])."""
    return nn.conv2d(F.gelu(_bn(p["2"], nn.conv2d(x.mean(dim=(2, 3), keepdim=True), p["1"]))),
                     p["4"])


def _spatial_map(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """spatial_interaction: 1×1 → bn → gelu → 1×1 (NCHW → [B,1,H,W])."""
    return nn.conv2d(F.gelu(_bn(p["1"], nn.conv2d(x, p["0"]))), p["3"])


def _adaptive_spatial_attn(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int],
                           heads: int, split: Tuple[int, int], shift: bool) -> torch.Tensor:
    h, w = hw
    b, l, c = x.shape
    qkv = nn.linear(x, p["qkv"]).reshape(b, l, 3, c).permute(2, 0, 1, 3).reshape(3, b, h, w, c)
    half = c // 2
    attened = torch.cat([
        _spatial_branch(p["attns"]["0"], qkv[..., :half], hw, split, heads // 2, shift),
        _spatial_branch(p["attns"]["1"], qkv[..., half:], hw, split[::-1], heads // 2, shift),
    ], dim=-1).permute(0, 3, 1, 2)  # NCHW
    conv_x = _dwconv(p["dwconv"], qkv[2].permute(0, 3, 1, 2))
    cmap = _channel_map(p["channel_interaction"], conv_x)
    smap = _spatial_map(p["spatial_interaction"], attened)
    out = attened * torch.sigmoid(cmap) + conv_x * torch.sigmoid(smap)
    return nn.linear(to_tokens(out), p["proj"])


def _adaptive_channel_attn(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int],
                           heads: int) -> torch.Tensor:
    """Transposed (channel) attention with a temperature, and the conv branch."""
    h, w = hw
    b, l, c = x.shape
    d = c // heads
    qkv = nn.linear(x, p["qkv"]).reshape(b, l, 3, heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 3, 1) for i in range(3))  # [B,H,D,L]
    qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
    temp = p["temperature"].reshape(1, heads, 1, 1).to(x.dtype)
    attn = F.softmax((qn @ kn.transpose(-2, -1)) * temp, dim=-1)  # [B,H,D,D]
    out = (attn @ v).permute(0, 3, 1, 2).reshape(b, l, c)
    conv_x = _dwconv(p["dwconv"], to_image(qkv[:, :, 2].reshape(b, l, c), h, w))
    cmap = _channel_map(p["channel_interaction"], to_image(out, h, w))
    smap = _spatial_map(p["spatial_interaction"], conv_x)
    out = out * torch.sigmoid(to_tokens(smap)) + to_tokens(conv_x * torch.sigmoid(cmap))
    return nn.linear(out, p["proj"])


def _sgfn(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Spatial-gated FFN: fc1 → gelu → halves → depthwise-gated product → fc2."""
    t = F.gelu(nn.linear(x, p["fc1"]))
    c2 = t.shape[-1] // 2
    x1, x2 = t[..., :c2], nn.layer_norm(t[..., c2:], p["sg"]["norm"])
    x2 = to_tokens(nn.conv2d(to_image(x2, *hw), p["sg"]["conv"], padding=1, groups=c2))
    return nn.linear(x1 * x2, p["fc2"])


def _datb(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], heads: int,
          split: Tuple[int, int], is_channel: bool, shift: bool) -> torch.Tensor:
    y = nn.layer_norm(x, p["norm1"])
    x = x + (_adaptive_channel_attn(p["attn"], y, hw, heads) if is_channel
             else _adaptive_spatial_attn(p["attn"], y, hw, heads, split, shift))
    return x + _sgfn(p["ffn"], nn.layer_norm(x, p["norm2"]), hw)


def _group(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], heads: int,
           split: Tuple[int, int]) -> torch.Tensor:
    res = x
    for i in range(len(p["blocks"])):
        x = _datb(p["blocks"][str(i)], x, hw, heads, split, i % 2 == 1, (i // 2) % 2 == 1)
    return res + to_tokens(nn.conv2d(to_image(x, *hw), p["conv"], padding=1))


def dat_apply(params: Mapping[str, Any], img: torch.Tensor, heads: int = 6,
              split: Tuple[int, int] = (8, 32), scale: int = 4) -> torch.Tensor:
    """img [B,3,H,W] in [0, 1] → upscaled [B,3,sH,sW] (DAT.forward)."""
    x, h0, w0 = pad_input(img, split[1])
    x = body(params, x, lambda p, t, hw: _group(p, t, hw, heads, split), patch_norm="before_RG")
    if "conv_before_upsample" in params:  # pixelshuffle
        x = pixelshuffle_tail(params, x, scale)
    else:  # pixelshuffledirect: upsample.0 and one shuffle
        x = F.pixel_shuffle(nn.conv2d(x, params["upsample"]["0"], padding=1), scale)
    out = x + torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    return out[:, :, : h0 * scale, : w0 * scale]


def load_dat(sd: Mapping[str, Any]) -> Dict[str, Any]:
    from ..core.convert import nest

    return nest(dict(unwrap(sd)))


def infer_dat_meta(params: Mapping[str, Any]) -> Dict[str, Any]:
    """(heads, scale) from the checkpoint's shapes."""
    heads = int(params["layers"]["0"]["blocks"]["1"]["attn"]["temperature"].shape[0])
    if "conv_before_upsample" in params:
        scale = upsample_scale(params)
    else:
        scale = int(np.sqrt(params["upsample"]["0"]["weight"].shape[0] // 3))
    return {"heads": heads, "scale": scale}

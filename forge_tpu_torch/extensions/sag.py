"""Self-Attention Guidance (arXiv:2210.00939; port of
forge_tpu/extensions/sag.py): the middle block's self-attention q and k are
recorded on each forward (the attention itself still goes through
`ops/attention.attention`, so the flash kernel runs); after CFG the cond
half's attention probabilities (an f32 softmax) mark the tokens attended
above their mean, the x0 is blurred there, re-noised to σ and denoised once
more at the cond's batch without hooks, and x0 ← x0 + scale · (x0_cond −
x0_degraded). NCHW; the mask is the middle block's token grid, which must
be square (the reference's reshape fails on any other)."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.resize import resize
from ..sampling.cfg import make_apply_model


def gaussian_blur_2d(x: torch.Tensor, kernel_size: int = 9, sigma: float = 1.0) -> torch.Tensor:
    """Separable depthwise Gaussian blur of NCHW x, edges replicated: along
    H, then along W."""
    half = kernel_size // 2
    coords = torch.arange(-half, half + 1, dtype=torch.float32)
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).to(device=x.device, dtype=x.dtype)
    c = x.shape[1]
    y = F.conv2d(F.pad(x, (0, 0, half, half), mode="replicate"),
                 g.reshape(1, 1, kernel_size, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(F.pad(y, (half, half, 0, 0), mode="replicate"),
                    g.reshape(1, 1, 1, kernel_size).repeat(c, 1, 1, 1), groups=c)


def attention_mask(q: torch.Tensor, k: torch.Tensor, heads: int, batch: int,
                   size: Tuple[int, int]) -> torch.Tensor:
    """SAG's mask from a recorded middle-block self-attention: the first
    `batch` rows' f32 attention probabilities, the tokens attended above
    their mean (column means over heads and queries) → [batch, 1, *size],
    1 where the blur goes, taken to the latent's size by nearest."""
    _, l, inner = q.shape
    side = int(math.sqrt(l))
    if side * side != l:
        raise ValueError(f"SAG needs a square middle-block token grid: a "
                         f"{size[1] * 8}x{size[0] * 8} request gives {l} tokens, not "
                         f"{side}² (the reference's reshape fails there too)")
    d = inner // heads
    qh = q[:batch].reshape(batch, l, heads, d).transpose(1, 2).float()
    kh = k[:batch].reshape(batch, l, heads, d).transpose(1, 2).float()
    probs = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(d), dim=-1)
    importance = probs.mean(dim=(1, 2))  # [B, L]
    mask = (importance > importance.mean(dim=1, keepdim=True)).float()
    return resize(mask.reshape(batch, 1, side, side), tuple(size), "nearest")


def build_sag(engine, cond: Mapping[str, Any], sag_scale: float = 0.75,
              blur_sigma: float = 2.0) -> Tuple[Dict[str, Any], Callable]:
    """→ (UNet hooks, post-CFG hook). Needs the uncond (CFG > 1): the
    record's first rows are the cond's; `cond` is at the request's batch."""
    storage: Dict[str, Any] = {}

    def attn1_record(q, k, v, extra):
        storage["qk"] = (q, k, extra["n_heads"])
        return attention(q, k, v, heads=extra["n_heads"])

    hooks = {"attn1_replace": {("middle", 0): attn1_record}}
    apply_degraded = make_apply_model(engine.unet_apply_fn(), engine.loaded.unet,
                                      engine.predictor, engine.compute_dtype)

    def post_cfg(x0, eps_cond, eps_uncond, x, sigma):
        if "qk" not in storage:
            return x0
        q, k, heads = storage["qk"]
        mask = attention_mask(q, k, heads, x.shape[0], tuple(x.shape[2:]))
        degraded_in = gaussian_blur_2d(x0, sigma=blur_sigma) * mask + x0 * (1 - mask)
        degraded = apply_degraded(degraded_in + (x - x0), sigma, cond)
        return x0 + sag_scale * (eps_cond - degraded)

    return hooks, post_cfg

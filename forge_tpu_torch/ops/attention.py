"""Attention front end (port of forge_tpu/ops/attention.py).

q/k/v are [B, L, heads·dim]; `heads` splits the channel dim. Unmasked calls
with Lq ≥ 512 and Lk ≥ 512 go to the flash kernel on CUDA, the same cut as
the reference; every other call takes the plain matmul → f32 softmax →
matmul. On the CPU the flash wrapper itself runs its plain version; inside
`ops.plain_versions()` the front end calls the plain version directly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import ops
from .flash_attention import flash_attention, flash_attention_plain

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over [B, L, heads·dim] tensors → same shape."""
    b, lq, inner = q.shape
    dim = inner // heads
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dim)
    qh = q.reshape(b, lq, heads, dim).transpose(1, 2)
    kh = k.reshape(b, lk, heads, dim).transpose(1, 2)
    vh = v.reshape(b, lk, heads, dim).transpose(1, 2)
    if mask is None and lq >= 512 and lk >= 512:
        fn = flash_attention_plain if ops._plain else flash_attention
        out = fn(qh, kh, vh, scale)
    else:
        out = flash_attention_plain(qh, kh, vh, scale, mask)
    return out.transpose(1, 2).reshape(b, lq, inner)


def attention_single_head_spatial(q, k, v) -> torch.Tensor:
    """VAE attention: q/k/v are [B, H·W, C], one head of width C."""
    return attention(q, k, v, heads=1)

"""Flash attention (non-causal, no mask or bias): kernel wrapper and plain version.

Port of forge_tpu/ops/flash_attention.py. On a CUDA tensor `flash_attention`
launches the hand-written kernel in `csrc/flash_attention.cu` (see its header
for the design), which has two bodies, and `flash_body` picks one for each
call: the tensor-core body (`wgmma`, K/V by TMA) for bf16 with a head dim
that is a multiple of 8, the SIMT body (f32 CUDA cores) otherwise. On a CPU
tensor it runs `flash_attention_plain`, the same math as one matmul → f32
softmax → matmul.

Layout: q [B, H, Lq, D], k/v [B, H, Lk, D] → [B, H, Lq, D].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

MAX_HEAD_DIM = 512
BODY_CODES = {"simt": 0, "wgmma": 1}  # the entry point's `body` argument


def flash_body(d: int, dtype: torch.dtype) -> str:
    """The body a CUDA call at head dim d in `dtype` runs. The tensor-core
    body loads rows by TMA, which needs 16-byte row strides (d % 8 == 0);
    f32 stays on the SIMT body: TF32 tensor cores would break its 1e-4 bound."""
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_HEAD_DIM:
        return "wgmma"
    return "simt"


PLAIN_MAX_LOGITS = 1 << 30  # above this many logits the plain version walks the query rows


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference math: f32 logits and softmax, probabilities cast to v's dtype.
    `mask` (True = keep) serves the front end's masked calls. Past
    PLAIN_MAX_LOGITS logits (the hires UNet's 16384 tokens: 20 GiB of f32
    logits, three times over) it runs slices of the query rows in turn;
    rows are independent, so that is the same math."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, lq, lk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    if mask is None and b * h * lq * lk > PLAIN_MAX_LOGITS:
        rows = max(PLAIN_MAX_LOGITS // (b * h * lk), 1)
        return torch.cat([flash_attention_plain(q[:, :, i:i + rows], k, v, scale)
                          for i in range(0, lq, rows)], dim=2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, body: Optional[str] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v. `body` ("wgmma" or "simt") overrides
    `flash_body`'s choice on CUDA."""
    if body is not None and body not in BODY_CODES:
        raise ValueError(f"flash_attention: body must be one of {tuple(BODY_CODES)}, not {body!r}")
    if body == "wgmma" and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: the wgmma body takes bfloat16, not {q.dtype}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not match")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    body = body or flash_body(d, q.dtype)
    if body == "wgmma" and d % 8:
        raise ValueError(f"flash_attention: the wgmma body takes head dims that are a "
                         f"multiple of 8, not {d}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty_like(q)
    fn = _build.library().forge_flash_attention
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, lk, d,
             float(scale), _build.DTYPE_CODES[q.dtype], BODY_CODES[body],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({body} body)")
    flash_attention.launches += 1
    flash_attention.launches_by_body[body] += 1
    return out


flash_attention.launches = 0  # every launch, whichever body
flash_attention.launches_by_body = dict.fromkeys(BODY_CODES, 0)

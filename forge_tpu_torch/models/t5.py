"""T5 encoder (T5-XXL for Flux) over HF `shared.*` / `encoder.block.*` keys
(port of forge_tpu/models/t5.py).

RMSNorm pre-norms with f32 statistics, relative attention bias (block 0 owns
the bucket table), gated-GELU DenseReluDense, no attention scaling. The
masked, biased attention is plain matmul → f32 softmax → matmul, as the
reference's einsum (no TPU kernel runs it there either).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn


def _rms(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    return nn.rms_norm(x, p["weight"], eps=1e-6)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing, [qlen, klen] int."""
    relative_position = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def t5_attention(p: Mapping[str, Any], x: torch.Tensor, bias: torch.Tensor,
                 heads: int) -> torch.Tensor:
    b, l, _ = x.shape
    q = nn.linear(x, {"weight": p["q"]["weight"]})
    k = nn.linear(x, {"weight": p["k"]["weight"]})
    v = nn.linear(x, {"weight": p["v"]["weight"]})
    d = q.shape[-1] // heads
    qh, kh, vh = (t.reshape(b, l, heads, d).transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) + bias
    prob = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.matmul(prob, vh).transpose(1, 2).reshape(b, l, heads * d)
    return nn.linear(out, {"weight": p["o"]["weight"]})


def t5_apply(params: Mapping[str, Any], tokens: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, L] int → final hidden states [B, L, D]. `attention_mask`
    [B, L] (True or nonzero = attend) masks keys."""
    table = params["shared"]["weight"]
    if table.element_size() == 1 and table.is_floating_point():  # fp8 storage: the rows, upcast
        dtype = params["encoder"]["final_layer_norm"]["weight"].dtype
        x = F.embedding(tokens, table.view(torch.uint8)).view(table.dtype).to(dtype)
    else:
        x = F.embedding(tokens, table)
    l = tokens.shape[1]
    blocks = params["encoder"]["block"]
    rel = blocks["0"]["layer"]["0"]["SelfAttention"]["relative_attention_bias"]["weight"]
    num_heads = rel.shape[1]  # the bias table is per head
    buckets = torch.from_numpy(relative_position_buckets(l, l)).to(x.device).long()
    bias = rel.float()[buckets].permute(2, 0, 1)[None]  # [1, H, L, L] f32
    if attention_mask is not None:
        keep = attention_mask.to(torch.bool)[:, None, None, :]
        bias = bias + torch.where(keep, 0.0, -1e9)

    for i in range(len(blocks)):
        bp = blocks[str(i)]["layer"]
        sa = bp["0"]
        x = x + t5_attention(sa["SelfAttention"], _rms(sa["layer_norm"], x), bias, num_heads)
        ff = bp["1"]
        h = _rms(ff["layer_norm"], x)
        dr = ff["DenseReluDense"]
        gated = nn.gelu(nn.linear(h, {"weight": dr["wi_0"]["weight"]})) * nn.linear(
            h, {"weight": dr["wi_1"]["weight"]})
        x = x + nn.linear(gated, {"weight": dr["wo"]["weight"]})
    return _rms(params["encoder"]["final_layer_norm"], x)

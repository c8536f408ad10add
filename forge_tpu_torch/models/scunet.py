# Copied from forge_tpu/models/scunet.py (the Swin-Conv blocks, the UNet, load_scunet and infer_scunet_meta), in PyTorch.
"""SCUNet, the Swin-Conv UNet denoiser (cszn/SCUNet network_scunet.py).

Conv head → three encoder stages (Swin-Conv blocks, then a stride-2 conv)
→ body → three decoder stages (a stride-2 transposed conv, then blocks)
with additive skips → conv tail; scale 1. Each Swin-Conv block splits its
channels between a residual conv branch and a Swin window-attention branch
(window 8, alternating shifted windows by the block's key parity, as the
reference), mixed by 1×1 convs at both ends. The relative embedding is read
as the reference reads it: `relative_position_params` [(2·8−1)², heads],
indexed by the 2-d coordinate difference (network_scunet
relative_embedding); a 3-d table ([heads, 15, 15], as upstream's
constructor leaves it) raises ValueError. The input is reflect-padded to a
multiple of 64. Attention is `torch.matmul` and a softmax, no kernel.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from .swinir import device_constant, reflect_pad, shifted_windows, unwrap

WINDOW = 8  # SCUNet is trained with window 8 throughout


@functools.lru_cache(maxsize=4)
def _rel_index(ws: int):
    cord = np.array([[i, j] for i in range(ws) for j in range(ws)])
    rel = cord[:, None, :] - cord[None, :, :] + ws - 1  # [ws², ws², 2]
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def _rel_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """relative_position_params [(2ws−1)², heads] → [heads, ws², ws²]."""
    if table.dim() != 2:
        raise ValueError(f"SCUNet relative_position_params of shape {tuple(table.shape)}: the "
                         f"port reads [(2·{ws}−1)², heads], as the reference does")
    idx = device_constant(_rel_index, (ws,), table.device)
    return table[idx.reshape(-1)].reshape(ws * ws, ws * ws, -1).permute(2, 0, 1)


def _wmsa(p: Mapping[str, Any], x: torch.Tensor, head_dim: int, shifted: bool) -> torch.Tensor:
    """Window multi-head self-attention ('W' or 'SW') on [B,H,W,C]."""
    c = x.shape[-1]
    heads = c // head_dim
    l = WINDOW * WINDOW
    bias = _rel_bias(p["relative_position_params"], WINDOW)

    def attend(win, mask):
        nw = win.shape[0]
        qkv = nn.linear(win, p["embedding_layer"]).reshape(nw, l, 3, heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-2, -1)) * head_dim ** -0.5 + bias[None].to(q.dtype)
        if mask is not None:
            m = mask.shape[0]
            attn = (attn.reshape(-1, m, heads, l, l) + mask[None, :, None].to(attn.dtype))
            attn = attn.reshape(-1, heads, l, l)
        out = (F.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(nw, l, c)
        return nn.linear(out, p["linear"])

    return shifted_windows(x, WINDOW, WINDOW // 2 if shifted else 0, attend)


def _trans_block(p: Mapping[str, Any], x: torch.Tensor, head_dim: int,
                 shifted: bool) -> torch.Tensor:
    """x + msa(ln1(x)); x + mlp(ln2(x)), on [B,H,W,C]."""
    x = x + _wmsa(p["msa"], nn.layer_norm(x, p["ln1"]), head_dim, shifted)
    return x + nn.linear(F.gelu(nn.linear(nn.layer_norm(x, p["ln2"]), p["mlp"]["0"])),
                         p["mlp"]["2"])


def _conv_trans_block(p: Mapping[str, Any], x: torch.Tensor, head_dim: int,
                      shifted: bool) -> torch.Tensor:
    conv_dim = p["conv_block"]["0"]["weight"].shape[1]
    h = nn.conv2d(x, p["conv1_1"])
    conv_x, trans_x = h[:, :conv_dim], h[:, conv_dim:]
    cb = p["conv_block"]
    conv_x = conv_x + nn.conv2d(F.relu(nn.conv2d(conv_x, cb["0"], padding=1)), cb["2"], padding=1)
    trans_x = _trans_block(p["trans_block"], trans_x.permute(0, 2, 3, 1), head_dim, shifted)
    return x + nn.conv2d(torch.cat([conv_x, trans_x.permute(0, 3, 1, 2)], dim=1), p["conv1_2"])


def _stage(stage: Mapping[str, Any], x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The Swin-Conv blocks of a stage (keys holding `conv1_1`), shifted at odd keys."""
    for i in sorted((k for k in stage if "conv1_1" in stage[k]), key=int):
        x = _conv_trans_block(stage[i], x, head_dim, int(i) % 2 == 1)
    return x


def scunet_apply(params: Mapping[str, Any], img: torch.Tensor, head_dim: int = 32) -> torch.Tensor:
    """img [B,3,H,W] in [0, 1] → denoised [B,3,H,W] (SCUNet.forward)."""
    h0, w0 = img.shape[2:]
    ph, pw = (64 - h0 % 64) % 64, (64 - w0 % 64) % 64
    x0 = reflect_pad(img, ph, pw) if ph or pw else img

    def down(stage, x):
        x = _stage(stage, x, head_dim)
        key = max((k for k in stage if "weight" in stage[k] and "conv1_1" not in stage[k]),
                  key=int)
        return nn.conv2d(x, stage[key], stride=2)

    def up(stage, x, skip):
        w = stage["0"]
        x = F.conv_transpose2d(x + skip, w["weight"].to(x.dtype),
                               None if w.get("bias") is None else w["bias"].to(x.dtype), stride=2)
        return _stage(stage, x, head_dim)

    x1 = nn.conv2d(x0, params["m_head"]["0"], padding=1)
    x2 = down(params["m_down1"], x1)
    x3 = down(params["m_down2"], x2)
    x4 = down(params["m_down3"], x3)
    x = _stage(params["m_body"], x4, head_dim)
    x = up(params["m_up3"], x, x4)
    x = up(params["m_up2"], x, x3)
    x = up(params["m_up1"], x, x2)
    x = nn.conv2d(x + x1, params["m_tail"]["0"], padding=1)
    return x[:, :, :h0, :w0]


def load_scunet(sd: Mapping[str, Any]) -> Dict[str, Any]:
    from ..core.convert import nest

    return nest(dict(unwrap(sd)))


def infer_scunet_meta(params: Mapping[str, Any]) -> Dict[str, int]:
    """head_dim from the first block: its attention branch's width over its heads."""
    blk = params["m_down1"]["0"]
    half = int(blk["conv_block"]["0"]["weight"].shape[1])
    heads = int(blk["trans_block"]["msa"]["relative_position_params"].shape[-1])
    return {"head_dim": half // heads}

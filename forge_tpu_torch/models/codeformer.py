# Copied from forge_tpu/models/codeformer.py (the VQGAN blocks, the token transformer, the codebook lookup, AdaIN, the SFT fuse and load_codeformer), in PyTorch.
"""CodeFormer face restoration (sczhou/CodeFormer codeformer_arch.py and
vqgan_arch.py).

A VQGAN autoencoder whose 16×16 latent is predicted token by token by a
9-layer transformer over a 1024-code codebook (an argmax), then decoded
with the `w`-weighted SFT fusion of the encoder's features at the sizes
the checkpoint's `fuse_convs_dict` lists (w = 0: the most restoration, 1:
the most fidelity). Parameters are the official `codeformer-v0.1.0.pth`
keys (`encoder.blocks.N`, `generator.blocks.N`, `quantize.embedding`,
`ft_layers.N`, `fuse_convs_dict.{32,64,128,256}`) in their own layout;
block kinds are told apart by their keys, so the walk follows the
constructor without fixed indices. NCHW. Attention (the VQGAN's attention
block and the transformer's) is `torch.matmul` and a softmax, as the
reference's jnp is: no kernel.

Each part runs in its own weights' dtype: what picks the codes (the
encoder, the transformer, `idx_pred_layer` and the codebook) may be stored
in f32 while the generator and the fuse blocks are in bf16
(postprocessing/faces.py `FaceRestorer`): the code lookup is an argmax,
and bf16 picks other codes than f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops import nn


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _gn(x: torch.Tensor, p: Mapping[str, Any]) -> torch.Tensor:
    """GroupNorm(32, eps 1e-6), the groups clamped to the channels."""
    return nn.group_norm(x, p, num_groups=min(32, x.shape[1]), eps=1e-6)


def _resblock(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = nn.conv2d(_swish(_gn(x, p["norm1"])), p["conv1"], padding=1)
    h = nn.conv2d(_swish(_gn(h, p["norm2"])), p["conv2"], padding=1)
    if "conv_out" in p:
        x = nn.conv2d(x, p["conv_out"])
    return x + h


def _attnblock(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    hn = _gn(x, p["norm"])
    q, k, v = (nn.conv2d(hn, p[n]).reshape(b, c, h * w).transpose(1, 2) for n in "qkv")
    attn = F.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, c, h, w)
    return x + nn.conv2d(out, p["proj_out"])


def _block_type(p: Mapping[str, Any]) -> str:
    if "norm1" in p:
        return "res"
    if "q" in p:
        return "attn"
    if "conv" in p:
        return "resample"  # Downsample (encoder) / Upsample (generator)
    w = p.get("weight")
    if w is not None and w.dim() == 4:
        return "conv"
    return "norm"


def _walk_blocks(blocks: Mapping[str, Any], x: torch.Tensor, *, upsample: bool,
                 taps: Optional[Dict[int, torch.Tensor]] = None, fuse=None) -> torch.Tensor:
    """Run an encoder or generator `blocks` list in index order. `taps`
    collects {size: feature} after each block (the encoder); `fuse` {size:
    fn} runs after the first ResBlock at each size (the generator:
    codeformer_arch fuse_generator_block)."""
    fused = set()
    for i in range(len(blocks)):
        p = blocks[str(i)]
        kind = _block_type(p)
        if kind == "res":
            x = _resblock(p, x)
        elif kind == "attn":
            x = _attnblock(p, x)
        elif kind == "conv":
            x = nn.conv2d(x, p, padding=1)
        elif kind == "norm":
            x = _swish(_gn(x, p))
        elif upsample:
            x = nn.conv2d(nn.upsample_nearest_2x(x), p["conv"], padding=1)
        else:
            x = nn.conv2d(F.pad(x, (0, 1, 0, 1)), p["conv"], stride=2)
        size = x.shape[2]
        if taps is not None:
            taps[size] = x
        if fuse and kind == "res" and size in fuse and size not in fused:
            x = fuse[size](x)
            fused.add(size)
    return x


def _mha(p: Mapping[str, Any], q, k, v, heads: int = 8) -> torch.Tensor:
    """torch's nn.MultiheadAttention with its packed in_proj; inputs [L, B, C]."""
    w, b = p["in_proj_weight"], p["in_proj_bias"]
    c = q.shape[-1]
    qp, kp, vp = (F.linear(t, w[i * c:(i + 1) * c].to(t.dtype), b[i * c:(i + 1) * c].to(t.dtype))
                  for i, t in enumerate((q, k, v)))

    def split(t):  # [L, B, C] → [B, H, L, D]
        l, bb, _ = t.shape
        return t.reshape(l, bb, heads, c // heads).permute(1, 2, 0, 3)

    qh, kh, vh = split(qp), split(kp), split(vp)
    attn = F.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(c // heads), dim=-1)
    out = (attn @ vh).permute(2, 0, 1, 3).reshape(q.shape)
    return nn.linear(out, p["out_proj"])


def _transformer_layer(p: Mapping[str, Any], tgt: torch.Tensor,
                       query_pos: torch.Tensor) -> torch.Tensor:
    """The norm-first self-attention layer (codeformer_arch TransformerSALayer)."""
    t2 = nn.layer_norm(tgt, p["norm1"])
    qk = t2 + query_pos
    tgt = tgt + _mha(p["self_attn"], qk, qk, t2)
    t2 = nn.layer_norm(tgt, p["norm2"])
    return tgt + nn.linear(F.gelu(nn.linear(t2, p["linear1"])), p["linear2"])


def _fuse_sft(p: Mapping[str, Any], enc_feat: torch.Tensor, dec_feat: torch.Tensor,
              w: float) -> torch.Tensor:
    feat = _resblock(p["encode_enc"], torch.cat([enc_feat, dec_feat], dim=1))
    scale = nn.conv2d(F.leaky_relu(nn.conv2d(feat, p["scale"]["0"], padding=1), 0.2),
                      p["scale"]["2"], padding=1)
    shift = nn.conv2d(F.leaky_relu(nn.conv2d(feat, p["shift"]["0"], padding=1), 0.2),
                      p["shift"]["2"], padding=1)
    return dec_feat + w * (dec_feat * scale + shift)


def _adain(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Adaptive instance norm over the spatial axes (population std, as jnp's)."""
    cm = content.mean(dim=(2, 3), keepdim=True)
    cs = content.std(dim=(2, 3), keepdim=True, unbiased=False) + 1e-5
    sm = style.mean(dim=(2, 3), keepdim=True)
    ss = style.std(dim=(2, 3), keepdim=True, unbiased=False) + 1e-5
    return (content - cm) / cs * ss + sm


def predict_codes(params: Mapping[str, Any], lq_feat: torch.Tensor) -> torch.Tensor:
    """The token transformer over the latent's positions → the code of each,
    [B, L] (argmax of `idx_pred_layer`), in the feature's dtype."""
    b, c, hh, ww = lq_feat.shape
    feat = nn.linear(lq_feat.reshape(b, c, hh * ww).transpose(1, 2), params["feat_emb"])
    query = feat.transpose(0, 1)  # [L, B, width]
    qpos = params["position_emb"].to(lq_feat.dtype)[:, None, :]
    for i in range(len(params["ft_layers"])):
        query = _transformer_layer(params["ft_layers"][str(i)], query, qpos)
    logits = nn.linear(nn.layer_norm(query, params["idx_pred_layer"]["0"]),
                       params["idx_pred_layer"]["1"])  # [L, B, codes]
    return logits.argmax(dim=-1).transpose(0, 1)


def codeformer_apply(params: Mapping[str, Any], x: torch.Tensor, w: float = 0.5,
                     adain: bool = True, codes_out: Optional[list] = None) -> torch.Tensor:
    """x [B,3,512,512] in [−1, 1] → restored [B,3,512,512] (CodeFormer.forward):
    encode → the transformer's codes → the quantized feature (+ AdaIN) → the
    generator with the w-weighted SFT fusion, each in its weights' dtype (the
    output in the generator's). `codes_out`, a list, receives the codes [B, L]."""
    connect = sorted(params.get("fuse_convs_dict", {}), key=int)
    gen_dtype = params["generator"]["blocks"]["0"]["weight"].dtype
    taps: Dict[int, torch.Tensor] = {}
    lq_feat = _walk_blocks(params["encoder"]["blocks"],
                           x.to(params["encoder"]["blocks"]["0"]["weight"].dtype),
                           upsample=False, taps=taps)
    b, c, hh, ww = lq_feat.shape
    idx = predict_codes(params, lq_feat)
    if codes_out is not None:
        codes_out.append(idx)
    codebook = params["quantize"]["embedding"]["weight"]  # [codes, c]
    quant = codebook[idx].to(lq_feat.dtype).transpose(1, 2).reshape(b, c, hh, ww)
    if adain:
        quant = _adain(quant, lq_feat)
    fuse = {}
    if w > 0:
        for size in connect:
            if int(size) in taps:
                fuse[int(size)] = (lambda xx, _p=params["fuse_convs_dict"][size],
                                   _e=taps[int(size)]: _fuse_sft(_p, _e.to(xx.dtype), xx, w))
    return _walk_blocks(params["generator"]["blocks"], quant.to(gen_dtype), upsample=True,
                        fuse=fuse)


def load_codeformer(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint's state dict → the nested tree (the `params_ema` wrapper
    the release file uses unwrapped; `quantize.ema*` and loss buffers dropped)."""
    from ..core.convert import nest

    if isinstance(sd.get("params_ema"), dict):
        sd = sd["params_ema"]
    return nest({k: v for k, v in sd.items() if not k.startswith(("quantize.ema", "loss"))})

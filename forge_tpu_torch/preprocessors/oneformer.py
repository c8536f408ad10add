"""OneFormer semantic segmentation (seg_ofade20k, seg_ofcoco) (port of
forge_tpu/preprocessors/oneformer.py).

The reference's OneFormer stack (annotator/oneformer/ of the legacy
preprocessors): a Swin-L backbone (D2SwinTransformer: shifted-window
attention with the relative position bias, patch merging, a LayerNorm on
each stage's output), the MSDeformAttn pixel decoder (six deformable
encoder layers over the 1/32, 1/16 and 1/8 maps, their bilinear sampling
as `ms_deform_attn_core_pytorch` takes it: grid_sample's corners with zero
padding outside the map, written here as four gathers in f32; then the 1/4 FPN
level and the mask features), and the task-conditioned masked transformer
decoder (the class transformer seeded by the task token, then the masked
cross-attention, self-attention and FFN layers, each followed by the
prediction heads whose sigmoid < 0.5 masks the next layer's attention).
Inference conditions on the task token alone: "The task is semantic" in
the CLIP BPE (text/tokenizer.py), its raw float ids through `task_mlp`, as
OneFormer does. The semantic map is the argmax of softmax(class) ×
sigmoid(mask) at the image's size, painted per pixel with the ADE20K or
COCO panoptic palette.

The window attention, the deformable sampling and the decoder's attention
are plain torch (matmul, f32 softmax), as the reference's are plain XLA
einsums: no kernel. The window partition and the shifted windows' mask are
SwinIR's (models/swinir.py); index tables, masks, position embeddings and
reference points are made once a shape and kept on the device
(`device_constant`). Resizes are ops/resize.py's, as `jax.image.resize`
(antialiased when they shrink); the feed's resize is OpenCV's INTER_LINEAR
(cv2_np.py).

Checkpoints (models/oneformer): 250_16_swin_l_oneformer_ade20k_160k.pth
(150 classes, 250 queries) and 150_16_swin_l_oneformer_coco_100ep.pth (133
classes, 150 queries), or any checkpoint there whose name holds the kind;
a detectron2 file's `model` entry is read where the keys sit under it. The
text branch, the criterion and the index and mask buffers are dropped, as
the reference drops them. Every width comes from the checkpoint.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.swinir import device_constant, shift_mask, window_partition, window_reverse
from ..ops import nn
from ..ops.resize import resize
from . import cv2_np
from .annotator import Detector, inference
from .cv import resize_image
from .uniformer import ADE20K_PALETTE

# COCO panoptic (133 = 80 things + 53 stuff) category colours in the checkpoint's class order
# (detectron2 builtin_meta.COCO_CATEGORIES)
COCO_PANOPTIC_PALETTE = np.asarray([
    [220, 20, 60], [119, 11, 32], [0, 0, 142], [0, 0, 230],
    [106, 0, 228], [0, 60, 100], [0, 80, 100], [0, 0, 70],
    [0, 0, 192], [250, 170, 30], [100, 170, 30], [220, 220, 0],
    [175, 116, 175], [250, 0, 30], [165, 42, 42], [255, 77, 255],
    [0, 226, 252], [182, 182, 255], [0, 82, 0], [120, 166, 157],
    [110, 76, 0], [174, 57, 255], [199, 100, 0], [72, 0, 118],
    [255, 179, 240], [0, 125, 92], [209, 0, 151], [188, 208, 182],
    [0, 220, 176], [255, 99, 164], [92, 0, 73], [133, 129, 255],
    [78, 180, 255], [0, 228, 0], [174, 255, 243], [45, 89, 255],
    [134, 134, 103], [145, 148, 174], [255, 208, 186], [197, 226, 255],
    [171, 134, 1], [109, 63, 54], [207, 138, 255], [151, 0, 95],
    [9, 80, 61], [84, 105, 51], [74, 65, 105], [166, 196, 102],
    [208, 195, 210], [255, 109, 65], [0, 143, 149], [179, 0, 194],
    [209, 99, 106], [5, 121, 0], [227, 255, 205], [147, 186, 208],
    [153, 69, 1], [3, 95, 161], [163, 255, 0], [119, 0, 170],
    [0, 182, 199], [0, 165, 120], [183, 130, 88], [95, 32, 0],
    [130, 114, 135], [110, 129, 133], [166, 74, 118], [219, 142, 185],
    [79, 210, 114], [178, 90, 62], [65, 70, 15], [127, 167, 115],
    [59, 105, 106], [142, 108, 45], [196, 172, 0], [95, 54, 80],
    [128, 76, 255], [201, 57, 1], [246, 0, 122], [191, 162, 208],
    [255, 255, 128], [147, 211, 203], [150, 100, 100], [168, 171, 172],
    [146, 112, 198], [210, 170, 100], [92, 136, 89], [218, 88, 184],
    [241, 129, 0], [217, 17, 255], [124, 74, 181], [70, 70, 70],
    [255, 228, 255], [154, 208, 0], [193, 0, 92], [76, 91, 113],
    [255, 180, 195], [106, 154, 176], [230, 150, 140], [60, 143, 255],
    [128, 64, 128], [92, 82, 55], [254, 212, 124], [73, 77, 174],
    [255, 160, 98], [255, 255, 255], [104, 84, 109], [169, 164, 131],
    [225, 199, 255], [137, 54, 74], [135, 158, 223], [7, 246, 231],
    [107, 255, 200], [58, 41, 149], [183, 121, 142], [255, 73, 97],
    [107, 142, 35], [190, 153, 153], [146, 139, 141], [70, 130, 180],
    [134, 199, 156], [209, 226, 140], [96, 36, 108], [96, 96, 96],
    [64, 170, 64], [152, 251, 152], [208, 229, 228], [206, 186, 171],
    [152, 161, 64], [116, 112, 0], [0, 114, 143], [102, 102, 156],
    [250, 141, 255],
], np.uint8)


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    return nn.layer_norm(x, p, eps=1e-5)


def _relu_linear(x: torch.Tensor, p) -> torch.Tensor:
    return F.relu(nn.linear(x, p))


def _mha(p: Mapping[str, Any], q, k, v, heads: int,
         bias_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch's nn.MultiheadAttention on [B, L, C] (the fused in_proj split
    into q, k, v; out_proj); `bias_add` [B or 1, heads or 1, Lq, Lk] is added
    to the f32 logits (the attn_mask)."""
    w, b = p["in_proj_weight"], p["in_proj_bias"]
    c = q.shape[-1]
    qq = F.linear(q, w[:c].to(q.dtype), b[:c].to(q.dtype))
    kk = F.linear(k, w[c:2 * c].to(k.dtype), b[c:2 * c].to(k.dtype))
    vv = F.linear(v, w[2 * c:].to(v.dtype), b[2 * c:].to(v.dtype))
    bt, lq, _ = qq.shape
    lk = kk.shape[1]
    dh = c // heads
    qq = qq.reshape(bt, lq, heads, dh).transpose(1, 2) * dh ** -0.5
    kk = kk.reshape(bt, lk, heads, dh).transpose(1, 2)
    vv = vv.reshape(bt, lk, heads, dh).transpose(1, 2)
    logits = torch.matmul(qq, kk.transpose(-2, -1)).float()
    if bias_add is not None:
        logits = logits + bias_add
    attn = torch.softmax(logits, dim=-1).to(vv.dtype)
    o = torch.matmul(attn, vv).transpose(1, 2).reshape(bt, lq, c)
    return nn.linear(o, p["out_proj"])


def _sine_pos_embed(h: int, w: int, dim: int) -> np.ndarray:
    """PositionEmbeddingSine(normalize=True) → [h, w, dim] (position_encoding.py:32-55,
    N_steps = dim // 2)."""
    steps = dim // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    eps, scale = 1e-6, 2 * np.pi
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    t = np.arange(steps, dtype=np.float32)
    t = 10000.0 ** (2 * (t // 2) / steps)
    px = x[:, :, None] / t
    py = y[:, :, None] / t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], -1).reshape(h, w, steps)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], -1).reshape(h, w, steps)
    return np.concatenate([py, px], axis=-1)


def _pos_tokens(h: int, w: int, dim: int, device) -> torch.Tensor:
    """The sine embedding as tokens [1, h·w, dim], f32, on `device` (made once a shape)."""
    return device_constant(_sine_pos_embed, (h, w, dim), device).reshape(1, h * w, dim)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW → [B, H·W, C]."""
    return x.flatten(2).transpose(1, 2)


def _image(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H·W, C] → NCHW."""
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


# ---------------------------------------------------------------- Swin-L ---


def _rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int64)


def _swin_block(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int],
                ws: int, shift: int) -> torch.Tensor:
    """One Swin block on tokens [B, h·w, C]: windows padded at the bottom and
    right, rolled by −shift where shifted."""
    h, w = hw
    b, _, c = x.shape
    table = p["attn"]["relative_position_bias_table"]
    heads = table.shape[-1]
    shortcut = x
    x = _ln(x, p["norm1"]).reshape(b, h, w, c)
    pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    win = window_partition(x, ws)  # [B·nW, N, C]
    n = ws * ws
    qkv = nn.linear(win, p["attn"]["qkv"]).reshape(-1, n, 3, heads, c // heads)
    q = qkv[:, :, 0].transpose(1, 2) * (c // heads) ** -0.5
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-2, -1)).float()
    index = device_constant(_rel_pos_index, (ws,), x.device).reshape(-1)
    bias = table[index].reshape(n, n, heads).permute(2, 0, 1).float()
    logits = logits + bias[None]
    if shift:
        m = device_constant(shift_mask, (hp, wp, ws, shift), x.device)  # [nW, N, N]
        nw = m.shape[0]
        logits = (logits.reshape(-1, nw, heads, n, n) + m[None, :, None]).reshape(-1, heads, n, n)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(attn, v).transpose(1, 2).reshape(-1, n, c)
    x = window_reverse(nn.linear(o, p["attn"]["proj"]), ws, hp, wp)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x[:, :h, :w].reshape(b, h * w, c)
    h2 = nn.gelu(nn.linear(_ln(x, p["norm2"]), p["mlp"]["fc1"]))
    return x + nn.linear(h2, p["mlp"]["fc2"])


def _patch_merge(p: Mapping[str, Any], x: torch.Tensor, hw) -> Tuple[torch.Tensor, Tuple[int, int]]:
    h, w = hw
    b, _, c = x.shape
    x = x.reshape(b, h, w, c)
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    x = _ln(x.reshape(b, -1, 4 * c), p["norm"])
    return F.linear(x, p["reduction"]["weight"].to(x.dtype)), ((h + 1) // 2, (w + 1) // 2)


def swin_features(params: Mapping[str, Any], x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """D2SwinTransformer.forward (swin.py:652-680): a normalized NCHW image →
    {res2..res5}, NCHW. Depth from the block count, the window from the bias
    table's rows, the heads from its columns."""
    proj = params["patch_embed"]["proj"]
    x = nn.conv2d(x, proj, stride=proj["weight"].shape[-1])
    b, c, hh, ww = x.shape
    x = _ln(_tokens(x), params["patch_embed"]["norm"])
    outs: Dict[str, torch.Tensor] = {}
    layers = params["layers"]
    hw = (hh, ww)
    for i in range(len(layers)):
        lp = layers[str(i)]
        blocks = lp["blocks"]
        rows = blocks["0"]["attn"]["relative_position_bias_table"].shape[0]
        ws = (int(round(rows ** 0.5)) + 1) // 2
        for j in range(len(blocks)):
            x = _swin_block(blocks[str(j)], x, hw, ws, 0 if j % 2 == 0 else ws // 2)
        if f"norm{i}" in params:
            outs[f"res{i + 2}"] = _image(_ln(x, params[f"norm{i}"]), *hw)
        if "downsample" in lp:
            x, hw = _patch_merge(lp["downsample"], x, hw)
    return outs


# --------------------------------------------- MSDeformAttn pixel decoder ---


def ms_deform_sample(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                     loc: torch.Tensor, attn_w: torch.Tensor) -> torch.Tensor:
    """ms_deform_attn_core_pytorch (ms_deform_attn_func.py:58-77).

    value [B, S, M, D], the levels' maps flattened (S = Σ H_l·W_l); loc [B,
    Lq, M, L, P, 2] sampling locations (x, y) in [0, 1]; attn_w [B, Lq, M, L,
    P] → [B, Lq, M·D]. grid_sample's bilinear with align_corners=False and
    zeros outside: pixel x = gx·W − 0.5, each of the four corners weighted
    by its fractions and dropped where it lies outside the map."""
    bsz, _, m, d = value.shape
    _, lq, _, nl, npt, _ = loc.shape
    start = 0
    sampled = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].reshape(bsz, h * w, m, d)
        v = v.permute(0, 2, 1, 3).reshape(bsz * m, h * w, d)
        g = loc[:, :, :, lvl]  # [B, Lq, M, P, 2]
        gx = g[..., 0] * w - 0.5
        gy = g[..., 1] * h - 0.5
        x0, y0 = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - x0, gy - y0
        acc = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
                idx = idx.permute(0, 2, 1, 3).reshape(bsz * m, lq * npt)
                got = torch.gather(v, 1, idx[:, :, None].expand(-1, -1, d))
                got = got.reshape(bsz, m, lq, npt, d).float()
                wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy) * ok).permute(0, 2, 1, 3)
                acc = acc + got * wgt[..., None]
        sampled.append(acc)  # [B, M, Lq, P, D]
        start += h * w
    out = torch.stack(sampled, dim=3)  # [B, M, Lq, L, P, D]
    wfull = attn_w.permute(0, 2, 1, 3, 4)  # [B, M, Lq, L, P]
    out = (out * wfull[..., None].float()).sum(dim=(3, 4))  # [B, M, Lq, D]
    return out.permute(0, 2, 1, 3).reshape(bsz, lq, m * d).to(value.dtype)


def _msdeform_layer(p: Mapping[str, Any], src: torch.Tensor, pos: torch.Tensor,
                    refpts: torch.Tensor, spatial_shapes) -> torch.Tensor:
    """MSDeformAttnTransformerEncoderLayer.forward (msdeformattn.py:119-130), 8 heads."""
    sa = p["self_attn"]
    q = src + pos
    nl, m = len(spatial_shapes), 8
    npt = sa["sampling_offsets"]["weight"].shape[0] // (m * nl * 2)
    bsz, s, c = src.shape
    value = nn.linear(src, sa["value_proj"]).reshape(bsz, s, m, c // m)
    off = nn.linear(q, sa["sampling_offsets"]).reshape(bsz, s, m, nl, npt, 2)
    aw = nn.linear(q, sa["attention_weights"]).reshape(bsz, s, m, nl * npt)
    aw = torch.softmax(aw.float(), dim=-1).to(src.dtype).reshape(bsz, s, m, nl, npt)
    normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                              device=src.device)
    loc = refpts[:, :, None, :, None, :] + off.float() / normalizer[None, None, None, :, None, :]
    attn_out = ms_deform_sample(value, spatial_shapes, loc, aw)
    src = _ln(src + nn.linear(attn_out, sa["output_proj"]), p["norm1"])
    src = src + nn.linear(_relu_linear(src, p["linear1"]), p["linear2"])
    return _ln(src, p["norm2"])


def _encoder_ref_points(spatial_shapes) -> np.ndarray:
    """get_reference_points (msdeformattn.py:139-152), valid ratios 1 → [1, S, 1, 2]."""
    pts = []
    for h, w in spatial_shapes:
        ry, rx = np.meshgrid(np.linspace(0.5, h - 0.5, h, dtype=np.float32) / h,
                             np.linspace(0.5, w - 0.5, w, dtype=np.float32) / w, indexing="ij")
        pts.append(np.stack([rx.reshape(-1), ry.reshape(-1)], -1))
    return np.concatenate(pts, 0)[None, :, None, :]


def pixel_decoder_apply(p: Mapping[str, Any], feats: Dict[str, torch.Tensor]):
    """MSDeformAttnPixelDecoder.forward_features (msdeformattn.py:319-358) →
    (mask features [B, mask_dim, H/4, W/4], the three encoded maps at 1/32,
    1/16, 1/8, NCHW)."""
    srcs, poss, shapes = [], [], []
    conv_dim = p["input_proj"]["0"]["0"]["weight"].shape[0]
    for i, name in enumerate(("res5", "res4", "res3")):
        proj = p["input_proj"][str(i)]
        x = nn.group_norm(nn.conv2d(feats[name], proj["0"]), proj["1"], num_groups=32,
                          eps=1e-5).to(feats[name].dtype)
        b, _, h, w = x.shape
        srcs.append(_tokens(x))
        pe = _pos_tokens(h, w, conv_dim, x.device)
        poss.append((pe + p["transformer"]["level_embed"][i].float()[None, None]).to(x.dtype)
                    .expand(b, -1, -1))
        shapes.append((h, w))
    src, pos = torch.cat(srcs, dim=1), torch.cat(poss, dim=1)
    shapes_t = tuple(shapes)
    refpts = device_constant(_encoder_ref_points, (shapes_t,), src.device)
    enc = p["transformer"]["encoder"]["layers"]
    for i in range(len(enc)):
        src = _msdeform_layer(enc[str(i)], src, pos, refpts, shapes)
    outs, start = [], 0
    for h, w in shapes:
        outs.append(_image(src[:, start:start + h * w], h, w))
        start += h * w
    # the extra FPN level on res2: the adapter_1 lateral and the layer_1 output conv
    lat = nn.conv2d(feats["res2"], p["adapter_1"])
    lat = nn.group_norm(lat, p["adapter_1"]["norm"], num_groups=32, eps=1e-5).to(lat.dtype)
    up = resize(outs[-1], tuple(lat.shape[2:]), "bilinear").to(lat.dtype)
    y = nn.conv2d(lat + up, p["layer_1"], padding=1)
    y = F.relu(nn.group_norm(y, p["layer_1"]["norm"], num_groups=32, eps=1e-5)).to(lat.dtype)
    return nn.conv2d(y, p["mask_features"]), outs


# ------------------------------------------------------ masked decoder ---


def _mlp(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    n = len(p["layers"])
    for i in range(n):
        x = nn.linear(x, p["layers"][str(i)])
        if i < n - 1:
            x = F.relu(x)
    return x


def _class_transformer(p: Mapping[str, Any], mask_features: torch.Tensor, class_pos: torch.Tensor,
                       task: torch.Tensor, query_pos: torch.Tensor, nheads: int) -> torch.Tensor:
    """transformer.py Transformer.forward with no encoder layer, the target
    the task token. The caller's order kept (oneformer_transformer_decoder.py:
    436-439): the memory is the sine embedding of the mask features and the
    keys add class_input_proj(mask features) to it."""
    b, c, h, w = mask_features.shape
    memory = _pos_tokens(h, w, c, mask_features.device).to(mask_features.dtype).expand(b, -1, -1)
    nq = query_pos.shape[0]
    tgt = task.expand(b, nq, c)
    qp = query_pos[None]
    dec = p["class_transformer"]["decoder"]
    for i in range(len(dec["layers"])):
        lp = dec["layers"][str(i)]
        tgt = _ln(tgt + _mha(lp["self_attn"], tgt + qp, tgt + qp, tgt, nheads), lp["norm1"])
        tgt = _ln(tgt + _mha(lp["multihead_attn"], tgt + qp, memory + class_pos, memory, nheads),
                  lp["norm2"])
        tgt = _ln(tgt + nn.linear(_relu_linear(tgt, lp["linear1"]), lp["linear2"]), lp["norm3"])
    return _ln(tgt, dec["norm"])


def _prediction_heads(p, output, mask_features, target_hw):
    """forward_prediction_heads (oneformer_transformer_decoder.py:495-516) →
    (class logits, masks at 1/4, the next layer's f32 attention bias
    [B, 1, Q, h·w]: −1e9 where sigmoid < 0.5, none on a query blocked everywhere)."""
    dec = _ln(output, p["decoder_norm"])
    cls = nn.linear(dec, p["class_embed"])
    memb = _mlp(p["mask_embed"], dec)
    masks = torch.einsum("bqc,bchw->bqhw", memb, mask_features)
    am = resize(masks.float(), tuple(target_hw), "bilinear")
    b, q = am.shape[:2]
    am = torch.sigmoid(am.reshape(b, q, -1)) < 0.5  # True: blocked
    am = am & ~am.all(dim=-1, keepdim=True)
    bias = torch.where(am, -1e9, 0.0).to(torch.float32)[:, None]
    return cls, masks, bias


def predictor_apply(p: Mapping[str, Any], ms_feats: List[torch.Tensor],
                    mask_features: torch.Tensor, task_token: torch.Tensor, nheads: int = 8):
    """ContrastiveMultiScaleMaskedTransformerDecoder.forward at inference →
    (class logits [B, Q, K+1], masks [B, Q, H/4, W/4])."""
    hidden = p["query_embed"]["weight"].shape[-1]
    srcs, poss, sizes = [], [], []
    for i, x in enumerate(ms_feats):
        b, c, h, w = x.shape
        sizes.append((h, w))
        poss.append(_pos_tokens(h, w, hidden, x.device).to(x.dtype).expand(b, -1, -1))
        srcs.append(_tokens(x) + p["level_embed"]["weight"][i].to(x.dtype)[None, None])
    task = _ln(task_token, p["decoder_norm"])  # use_task_norm
    cls_proj = _tokens(nn.conv2d(mask_features, p["class_input_proj"]))
    query = p["query_embed"]["weight"].to(mask_features.dtype)
    out_t = _class_transformer(p, mask_features, cls_proj, task, query[:-1], nheads)
    output = torch.cat([out_t, task.expand(out_t.shape[0], -1, -1)], dim=1)
    qp = query[None]
    layers_sa = p["transformer_self_attention_layers"]
    layers_ca = p["transformer_cross_attention_layers"]
    layers_ff = p["transformer_ffn_layers"]
    _, _, bias = _prediction_heads(p, output, mask_features, sizes[0])
    cls = masks = None
    for i in range(len(layers_ca)):
        lvl = i % len(ms_feats)
        ca = layers_ca[str(i)]
        output = _ln(output + _mha(ca["multihead_attn"], output + qp, srcs[lvl] + poss[lvl],
                                   srcs[lvl], nheads, bias_add=bias), ca["norm"])
        sa = layers_sa[str(i)]
        output = _ln(output + _mha(sa["self_attn"], output + qp, output + qp, output, nheads),
                     sa["norm"])
        ff = layers_ff[str(i)]
        output = _ln(output + nn.linear(_relu_linear(output, ff["linear1"]), ff["linear2"]),
                     ff["norm"])
        cls, masks, bias = _prediction_heads(p, output, mask_features,
                                             sizes[(i + 1) % len(ms_feats)])
    return cls, masks


def oneformer_apply(params: Mapping[str, Any], x: torch.Tensor, task_tokens: torch.Tensor):
    """The semantic forward on a padded, normalized NCHW image → (class
    logits [B, Q, K+1], masks [B, Q, H/4, W/4])."""
    feats = swin_features(params["backbone"], x)
    maskf, ms = pixel_decoder_apply(params["sem_seg_head"]["pixel_decoder"], feats)
    # the raw ids in f32: bf16 does not hold the BPE's five-digit ids
    task = _mlp(params["task_mlp"], task_tokens.float()).to(x.dtype)
    return predictor_apply(params["sem_seg_head"]["predictor"], ms, maskf, task[:, None])


# ------------------------------------------------------------- detector ---


_CONFIGS = {
    "ade20k": {"ckpt": "250_16_swin_l_oneformer_ade20k_160k.pth", "palette": ADE20K_PALETTE},
    "coco": {"ckpt": "150_16_swin_l_oneformer_coco_100ep.pth", "palette": COCO_PANOPTIC_PALETTE},
}
# the training-only branches (oneformer_model.py: encode_text under self.training) and the
# criterion's buffers
_DROP = ("text_encoder.", "text_projector.", "prompt_ctx.", "criterion.")


def task_token_ids(task: str = "semantic", seq_len: int = 77) -> np.ndarray:
    """Tokenize(SimpleTokenizer(), 77)("The task is semantic"): the CLIP BPE
    with start and end, zero-padded (oneformer/data/tokenizer.py:86-116)."""
    from ..text.tokenizer import default_tokenizer

    tok = default_tokenizer()
    ids = [tok.bos] + list(tok.ids(f"The task is {task}")) + [tok.eos]
    out = np.zeros((seq_len,), np.int64)
    out[:len(ids)] = ids[:seq_len]
    return out


def _convert(sd: Dict[str, Any]) -> Dict[str, Any]:
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v for k, v in sd.items()
            if not any(k.startswith(d) or f".{d}" in k for d in _DROP)
            and "relative_position_index" not in k and "attn_mask" not in k}


class OneformerDetector(Detector):
    """The semantic run (the reference's api.py make_detectron2_model and
    semantic_run); `kind` "ade20k" or "coco"."""

    DTYPE = torch.float32  # in bf16 the palette map differs from f32's (PERF.md §4)
    MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
    STD = np.asarray([58.395, 57.12, 57.375], np.float32)
    MIN_TEST, MAX_TEST = 640, 2560

    def __init__(self, kind: str, model_dir: str = "models/oneformer", **kw):
        self.kind = kind
        self.cfg = _CONFIGS[kind]
        super().__init__(model_dir, convert=_convert, missing=f"no {self.cfg['ckpt']}", **kw)

    def path(self) -> Optional[str]:
        """The published file's name first, then any checkpoint whose name holds the kind."""
        if not os.path.isdir(self.model_dir):
            return None
        cands = [self.cfg["ckpt"]] + [f for f in sorted(os.listdir(self.model_dir))
                                      if self.kind in f and f.endswith((".pt", ".pth",
                                                                        ".safetensors"))]
        return next((os.path.join(self.model_dir, c) for c in cands
                     if os.path.isfile(os.path.join(self.model_dir, c))), None)

    def detect(self, img: np.ndarray) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        # detectron2's ResizeShortestEdge(640, 2560)
        scale = self.MIN_TEST / min(h, w)
        if max(h, w) * scale > self.MAX_TEST:
            scale = self.MAX_TEST / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_LINEAR)
        feed = (feed.astype(np.float32) - self.MEAN) / self.STD
        # ImageList.from_tensors(size_divisibility=32): zeros at the bottom and right
        ph, pw = -(-nh // 32) * 32, -(-nw // 32) * 32
        feed = np.pad(feed, ((0, ph - nh), (0, pw - nw), (0, 0)))
        x = self.image_tensor(feed)
        tokens = torch.from_numpy(task_token_ids("semantic")[None]).to(x.device)
        with inference():
            cls, masks = oneformer_apply(params, x, tokens)
            # oneformer_model.py:293-322: the masks to the padded size, cropped to the resized
            # image, then the semantic inference at the image's size
            masks = resize(masks.float(), (ph, pw), "bilinear")[:, :, :nh, :nw]
            masks = resize(masks, (h, w), "bilinear")
            prob = torch.softmax(cls.float(), dim=-1)[..., :-1]
            semseg = torch.einsum("bqc,bqhw->bchw", prob, torch.sigmoid(masks))
            seg = semseg[0].argmax(dim=0).cpu().numpy()
        palette = self.cfg["palette"]
        return palette[seg % len(palette)].astype(np.uint8)


_DETECTORS: Dict[str, OneformerDetector] = {}


def get_oneformer(kind: str, device=None) -> OneformerDetector:
    if kind not in _DETECTORS:
        _DETECTORS[kind] = OneformerDetector(kind, device=device)
    return _DETECTORS[kind]


def _run(kind: str, img, res):
    return np.asarray(get_oneformer(kind).detect(resize_image(img, res)), np.float32) / 255.0


def seg_ofade20k(img, res, a=0.0, b=0.0):
    return _run("ade20k", img, res)


def seg_ofcoco(img, res, a=0.0, b=0.0):
    return _run("coco", img, res)

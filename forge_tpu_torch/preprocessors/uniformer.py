"""UniFormer-S and UPerHead ADE20k segmentation (seg_ufade20k) (port of
forge_tpu/preprocessors/uniformer.py).

The reference's seg annotator (annotator/uniformer/uniformer.py backbone,
mmseg's decode_heads/uper_head.py, config upernet_global_small.py): four
stages of embed dims 64/128/320/512 and 3/4/8/3 blocks, the first two of
convolutional CBlocks (depthwise "attention" convs, BatchNorm), the last
two of global self-attention SABlocks (LayerNorm, heads of 64), feeding a
UPerNet head (pyramid pooling at 1, 2, 3 and 6 over the last stage, the FPN
top-down fusion, a 150-class 1×1 classifier). mmseg's "whole" test mode:
OpenCV's INTER_LINEAR to fit (2048, 512) keeping the ratio, the channels
reversed before the normalization (mmcv's Normalize with to_rgb=True on
the RGB input, kept as the reference keeps it), the logits resized
bilinearly (align_corners=False, as jax.image.resize without antialias:
ops/resize.py), the argmax and the ADE20k palette, back by INTER_NEAREST.
The attention carries no mask but stays plain, as the reference's is plain.
Every block count and width comes from the checkpoint
(upernet_global_small.pth, its `state_dict`); the auxiliary FCN head is
left out, as mmseg's whole mode leaves it.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize
from . import cv2_np
from .annotator import Detector, batch_norm, inference
from .cv import resize_image

# the ADE20k palette (mmseg core/evaluation/class_names.py ade_palette)
ADE20K_PALETTE = np.asarray([
    [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50],
    [4, 200, 3], [120, 120, 80], [140, 140, 140], [204, 5, 255],
    [230, 230, 230], [4, 250, 7], [224, 5, 255], [235, 255, 7],
    [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82],
    [143, 255, 140], [204, 255, 4], [255, 51, 7], [204, 70, 3],
    [0, 102, 200], [61, 230, 250], [255, 6, 51], [11, 102, 255],
    [255, 7, 71], [255, 9, 224], [9, 7, 230], [220, 220, 220],
    [255, 9, 92], [112, 9, 255], [8, 255, 214], [7, 255, 224],
    [255, 184, 6], [10, 255, 71], [255, 41, 10], [7, 255, 255],
    [224, 255, 8], [102, 8, 255], [255, 61, 6], [255, 194, 7],
    [255, 122, 8], [0, 255, 20], [255, 8, 41], [255, 5, 153],
    [6, 51, 255], [235, 12, 255], [160, 150, 20], [0, 163, 255],
    [140, 140, 140], [250, 10, 15], [20, 255, 0], [31, 255, 0],
    [255, 31, 0], [255, 224, 0], [153, 255, 0], [0, 0, 255],
    [255, 71, 0], [0, 235, 255], [0, 173, 255], [31, 0, 255],
    [11, 200, 200], [255, 82, 0], [0, 255, 245], [0, 61, 255],
    [0, 255, 112], [0, 255, 133], [255, 0, 0], [255, 163, 0],
    [255, 102, 0], [194, 255, 0], [0, 143, 255], [51, 255, 0],
    [0, 82, 255], [0, 255, 41], [0, 255, 173], [10, 0, 255],
    [173, 255, 0], [0, 255, 153], [255, 92, 0], [255, 0, 255],
    [255, 0, 245], [255, 0, 102], [255, 173, 0], [255, 0, 20],
    [255, 184, 184], [0, 31, 255], [0, 255, 61], [0, 71, 255],
    [255, 0, 204], [0, 255, 194], [0, 255, 82], [0, 10, 255],
    [0, 112, 255], [51, 0, 255], [0, 194, 255], [0, 122, 255],
    [0, 255, 163], [255, 153, 0], [0, 255, 10], [255, 112, 0],
    [143, 255, 0], [82, 0, 255], [163, 255, 0], [255, 235, 0],
    [8, 184, 170], [133, 0, 255], [0, 255, 92], [184, 0, 255],
    [255, 0, 31], [0, 184, 255], [0, 214, 255], [255, 0, 112],
    [92, 255, 0], [0, 224, 255], [112, 224, 255], [70, 184, 160],
    [163, 0, 255], [153, 0, 255], [71, 255, 0], [255, 0, 163],
    [255, 204, 0], [255, 0, 143], [0, 255, 235], [133, 255, 0],
    [255, 0, 235], [245, 0, 255], [255, 0, 122], [255, 245, 0],
    [10, 190, 212], [214, 255, 0], [0, 204, 255], [20, 0, 255],
    [255, 255, 0], [0, 153, 255], [0, 41, 255], [0, 255, 204],
    [41, 0, 255], [41, 255, 0], [173, 0, 255], [0, 245, 255],
    [71, 0, 255], [122, 0, 255], [0, 255, 184], [0, 92, 255],
    [184, 255, 0], [0, 133, 255], [255, 214, 0], [25, 194, 194],
    [102, 255, 0], [92, 0, 255],
], np.uint8)


def _bn(x, p):
    return batch_norm(x, p, 1e-5)


def _ln_c(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """LayerNorm over the channels of NCHW x."""
    return nn.layer_norm(x.permute(0, 2, 3, 1), p, eps=eps).permute(0, 3, 1, 2)


def _resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """mmseg's resize (align_corners=False), as jax.image.resize without antialias."""
    return resize(x, (int(hw[0]), int(hw[1])), "bilinear", antialias=False)


def _cblock(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The convolutional block (uniformer.py CBlock), BatchNorm."""
    dim = x.shape[1]
    x = x + nn.conv2d(x, p["pos_embed"], padding=1, groups=dim)
    h = nn.conv2d(nn.conv2d(_bn(x, p["norm1"]), p["conv1"]), p["attn"], padding=2, groups=dim)
    x = x + nn.conv2d(h, p["conv2"])
    h = nn.gelu(nn.conv2d(_bn(x, p["norm2"]), p["mlp"]["fc1"]))
    return x + nn.conv2d(h, p["mlp"]["fc2"])


def _sablock(p: Mapping[str, Any], x: torch.Tensor, head_dim: int = 64) -> torch.Tensor:
    """The global self-attention block (uniformer.py SABlock), NCHW in and out."""
    dim = x.shape[1]
    heads = max(dim // head_dim, 1)
    x = x + nn.conv2d(x, p["pos_embed"], padding=1, groups=dim)
    b, c, hh, ww = x.shape
    t = x.flatten(2).transpose(1, 2)
    h = nn.layer_norm(t, p["norm1"], eps=1e-6)
    qkv = nn.linear(h, p["attn"]["qkv"]).reshape(b, hh * ww, 3, heads, c // heads)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, L, H, D]
    logits = torch.einsum("blhd,bmhd->bhlm", q, k).float() * (c // heads) ** -0.5
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhlm,bmhd->blhd", attn, v).reshape(b, hh * ww, c)
    t = t + nn.linear(o, p["attn"]["proj"])
    h = nn.gelu(nn.linear(nn.layer_norm(t, p["norm2"], eps=1e-6), p["mlp"]["fc1"]))
    t = t + nn.linear(h, p["mlp"]["fc2"])
    return t.transpose(1, 2).reshape(b, c, hh, ww)


def uniformer_features(params: Mapping[str, Any], x: torch.Tensor, head_dim: int = 64):
    """The backbone's forward_features: four LayerNormed stage maps.
    `head_dim` splits the stage 3-4 attention (UniFormer-S and -B: 64)."""
    outs = []
    for stage in (1, 2, 3, 4):
        pe = params[f"patch_embed{stage}"]
        x = nn.conv2d(x, pe["proj"], stride=pe["proj"]["weight"].shape[-1])
        x = _ln_c(x, pe["norm"], 1e-5)  # PatchEmbed's plain nn.LayerNorm
        blocks = params[f"blocks{stage}"]
        for i in range(len(blocks)):
            bp = blocks[str(i)]
            x = _cblock(bp, x) if "conv1" in bp else _sablock(bp, x, head_dim)
        outs.append(_ln_c(x, params[f"norm{stage}"], 1e-6))
    return outs


def _conv_module(p: Mapping[str, Any], x: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """mmcv's ConvModule: conv (no bias) → BN → ReLU."""
    return F.relu(_bn(nn.conv2d(x, p["conv"], padding=padding), p["bn"]))


def upernet_apply(params: Mapping[str, Any], feats) -> torch.Tensor:
    """UPerHead's forward over the backbone's maps → logits at 1/4 of the
    input, [B, num_classes, H/4, W/4]."""
    top = feats[-1]
    psp = [top]
    ppm = params["psp_modules"]
    for i in range(len(ppm)):
        pooled = _conv_module(ppm[str(i)]["1"], F.adaptive_avg_pool2d(top, (1, 2, 3, 6)[i]))
        psp.append(_resize_bilinear(pooled, top.shape[2:]))
    laterals = [_conv_module(params["lateral_convs"][str(i)], feats[i])
                for i in range(len(feats) - 1)]
    laterals.append(_conv_module(params["bottleneck"], torch.cat(psp, 1), padding=1))
    for i in range(len(laterals) - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + _resize_bilinear(laterals[i],
                                                             laterals[i - 1].shape[2:])
    fpn = [_conv_module(params["fpn_convs"][str(i)], laterals[i], padding=1)
           for i in range(len(laterals) - 1)]
    fpn.append(laterals[-1])
    fpn = [_resize_bilinear(f, fpn[0].shape[2:]) if f.shape[2:] != fpn[0].shape[2:] else f
           for f in fpn]
    out = _conv_module(params["fpn_bottleneck"], torch.cat(fpn, 1), padding=1)
    return nn.conv2d(out, params["conv_seg"])


def segment(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """A normalized image [B,3,H,W] → the class-id map [B,H,W] (whole mode)."""
    logits = upernet_apply(params["decode_head"], uniformer_features(params["backbone"], x))
    return _resize_bilinear(logits.float(), x.shape[2:]).argmax(dim=1)


def _convert(sd):
    return {k: v for k, v in sd.items() if not k.startswith("auxiliary_head.")}


class UniformerDetector(Detector):
    DTYPE = torch.float32  # in bf16 the palette map differs from f32's (PERF.md §4)
    # mmcv's Normalize of configs/_base_/datasets/ade20k.py
    MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
    STD = np.asarray([58.395, 57.12, 57.375], np.float32)

    def __init__(self, model_dir: str = "models/uniformer", **kw):
        super().__init__(model_dir, suffixes=(".pt", ".pth", ".safetensors"), convert=_convert,
                         missing="no upernet_global_small.pth", **kw)

    def detect(self, img: np.ndarray) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        scale = min(2048 / max(h, w), 512 / min(h, w))  # mmcv's rescale into (2048, 512)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_LINEAR)
        # Normalize(to_rgb=True) reverses the channels of the RGB input first
        feed = (feed[..., ::-1].astype(np.float32) - self.MEAN) / self.STD
        with inference():
            seg = segment(params, self.image_tensor(feed))[0].cpu().numpy()
        color = ADE20K_PALETTE[seg % len(ADE20K_PALETTE)]
        return cv2_np.resize(color, (w, h), cv2_np.INTER_NEAREST)


_DETECTOR: Optional[UniformerDetector] = None


def get_uniformer(device=None) -> UniformerDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = UniformerDetector(device=device)
    return _DETECTOR


def seg_ufade20k(img, res, a, b):
    return np.asarray(get_uniformer().detect(resize_image(img, res)), np.float32) / 255.0

"""Depth Anything V2 (depth_anything_v2): a DINOv2 ViT encoder and the DPT
head (port of forge_tpu/preprocessors/depth_anything.py).

The encoder's blocks attend through ops/attention.py, so each of the 24
blocks of ViT-L/14 is one flash-attention launch on the card (at a 518²
feed: 37² patches + the class token = 1370 tokens, 16 heads of 64). Widths,
depth and taps come from the checkpoint (ViT-S/B taps [2, 5, 8, 11], ViT-L
[4, 11, 17, 23], ViT-G [9, 19, 29, 39]); the head reads the patch tokens
(use_clstoken=False). The position embedding is resized bicubically (Keys
−0.5, ops/resize.py, as jax.image.resize), the head's upsamples are
bilinear with align_corners=True, GELU is exact.

Checkpoint: the first .safetensors/.pth/.pt under models/depth_anything_v2
(depth_anything_v2_vitl's keys: pretrained.*, depth_head.*).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.attention import attention
from ..ops.resize import resize
from . import cv2_np
from .annotator import IMAGENET_MEAN, IMAGENET_STD, Detector, inference, resize_align, to_numpy
from .cv import resize_image

_TAPS = {12: (2, 5, 8, 11), 24: (4, 11, 17, 23), 40: (9, 19, 29, 39)}


def _vit_block(p: Mapping[str, Any], x: torch.Tensor, heads: int) -> torch.Tensor:
    h = nn.layer_norm(x, p["norm1"], eps=1e-6)
    q, k, v = nn.linear(h, p["attn"]["qkv"]).chunk(3, dim=-1)
    a = nn.linear(attention(q, k, v, heads=heads), p["attn"]["proj"])
    if "ls1" in p:  # DINOv2 layer scale
        a = a * p["ls1"]["gamma"]
    x = x + a
    h = nn.layer_norm(x, p["norm2"], eps=1e-6)
    h = nn.linear(F.gelu(nn.linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    if "ls2" in p:
        h = h * p["ls2"]["gamma"]
    return x + h


def _interp_pos_embed(pos: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """DINOv2 interpolate_pos_encoding: the patch grid resized bicubically."""
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    side = int(np.sqrt(patch_pos.shape[1]))
    grid = patch_pos.reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = resize(grid.float(), (ph, pw), "bicubic").to(pos.dtype)
    return torch.cat([cls_pos, grid.flatten(2).transpose(1, 2)], dim=1)


def _rcu(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = nn.conv2d(F.relu(x), p["conv1"], padding=1)
    return nn.conv2d(F.relu(h), p["conv2"], padding=1) + x


def depth_anything_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [1,3,H,W] normalized (H, W multiples of 14) → depth [1,H,W]."""
    enc, head = params["pretrained"], params["depth_head"]
    width = enc["cls_token"].shape[-1]
    n_blocks = len(enc["blocks"])
    taps = _TAPS[n_blocks]
    ph, pw = x.shape[2] // 14, x.shape[3] // 14
    h = nn.conv2d(x, enc["patch_embed"]["proj"], stride=14).flatten(2).transpose(1, 2)
    h = torch.cat([enc["cls_token"].reshape(1, 1, width).to(h.dtype), h], dim=1)
    h = h + _interp_pos_embed(enc["pos_embed"], ph, pw).to(h.dtype)
    feats = []
    for i in range(n_blocks):
        h = _vit_block(enc["blocks"][str(i)], h, width // 64)
        if i in taps:
            feats.append(h[:, 1:])
    outs = []
    for i, f in enumerate(feats):
        g = nn.conv2d(f.transpose(1, 2).reshape(1, width, ph, pw), head["projects"][str(i)])
        if i == 0:
            g = nn.conv2d_transpose(g, head["resize_layers"][str(i)], stride=4)
        elif i == 1:
            g = nn.conv2d_transpose(g, head["resize_layers"][str(i)], stride=2)
        elif i == 3:
            g = nn.conv2d(g, head["resize_layers"][str(i)], stride=2, padding=1)
        outs.append(g)
    scratch = head["scratch"]
    rn = [nn.conv2d(outs[i], scratch[f"layer{i + 1}_rn"], padding=1) for i in range(4)]

    def fuse(p, x0, x1, size):
        out = x0 if x1 is None else x0 + _rcu(p["resConfUnit1"], x1)
        return nn.conv2d(resize_align(_rcu(p["resConfUnit2"], out), size), p["out_conv"])

    path = fuse(scratch["refinenet4"], rn[3], None, rn[2].shape[2:])
    path = fuse(scratch["refinenet3"], path, rn[2], rn[1].shape[2:])
    path = fuse(scratch["refinenet2"], path, rn[1], rn[0].shape[2:])
    path = fuse(scratch["refinenet1"], path, rn[0], (rn[0].shape[2] * 2, rn[0].shape[3] * 2))
    out = nn.conv2d(path, scratch["output_conv1"], padding=1)
    out = resize_align(out, (ph * 14, pw * 14))
    out = nn.conv2d(out, scratch["output_conv2"]["0"], padding=1)
    out = nn.conv2d(F.relu(out), scratch["output_conv2"]["2"])
    return F.relu(out)[:, 0]


class DepthAnythingDetector(Detector):
    DTYPE = torch.bfloat16  # 45.14 dB against f32 on an H100 (PERF.md §4)

    def __init__(self, model_dir: str = "models/depth_anything_v2", **kw):
        super().__init__(model_dir, suffixes=(".safetensors", ".pth", ".pt"),
                         missing="no depth_anything_v2 checkpoint", **kw)

    @staticmethod
    def feed_size(h: int, w: int):
        """The reference's transform: the short side to 518, multiples of 14."""
        scale = 518.0 / min(h, w)
        return (max(int(round(h * scale / 14)) * 14, 518),
                max(int(round(w * scale / 14)) * 14, 518))

    def predict(self, img: np.ndarray) -> torch.Tensor:
        """uint8 [H,W,3] → the network's depth [nh, nw] at the feed size, f32, on the device."""
        params = self.load()
        nh, nw = self.feed_size(*img.shape[:2])
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_CUBIC).astype(np.float32) / 255.0
        x = self.image_tensor((feed - IMAGENET_MEAN) / IMAGENET_STD)
        with inference():
            return depth_anything_apply(params, x)[0].float()

    def detect(self, img: np.ndarray) -> np.ndarray:
        """uint8 [H,W,3] → normalized depth uint8 [H,W] (reference
        DepthAnythingV2Detector.__call__, colored=False)."""
        h, w = img.shape[:2]
        depth = cv2_np.resize(to_numpy(self.predict(img)), (w, h), cv2_np.INTER_LINEAR)
        lo, hi = depth.min(), depth.max()
        return ((depth - lo) / max(hi - lo, 1e-8) * 255.0).astype(np.uint8)


_DETECTOR: Optional[DepthAnythingDetector] = None


def get_depth_anything(device=None) -> DepthAnythingDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = DepthAnythingDetector(device=device)
    return _DETECTOR


def depth_anything(img, res, a, b):
    d = get_depth_anything().detect(resize_image(img, res))
    return np.repeat(d[..., None].astype(np.float32) / 255.0, 3, axis=2)

"""TEED soft edges (softedge_teed): the Tiny and Efficient Edge Detector
(port of forge_tpu/preprocessors/teed.py).

Two Smish conv stems, one dense block, three up-conv side outputs (1×1 conv,
Smish, a transpose conv of kernel 2^s and stride 2, s times) fused by the
depthwise DoubleFusion head; the four maps are resized to the feed
(bilinear, half-pixel centres: ops/resize.py), averaged and put through a
sigmoid, then resized to the image (OpenCV's INTER_LINEAR) and safe-stepped.
The feed is the image at multiples of 8 (OpenCV's INTER_CUBIC where it
differs), raw 0..255. Checkpoint: the first .pth/.pt/.safetensors under
models/TEED (7_model.pth).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize
from . import cv2_np
from .annotator import Detector, gray_map, inference, safe_step, to_numpy
from .cv import resize_image

_UP_PADS = [0, 0, 1, 3, 7]  # the transpose convs' padding by up scale


def _smish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(torch.log1p(torch.sigmoid(x)))


def _double_conv(p, x, stride=1, use_act=True):
    x = _smish(nn.conv2d(x, p["conv1"], stride=stride, padding=1))
    x = nn.conv2d(x, p["conv2"], padding=1)
    return _smish(x) if use_act else x


def _dense_layer(p, x1, x2):
    h = nn.conv2d(_smish(x1), p["conv1"], padding=2)
    h = nn.conv2d(_smish(h), p["conv2"])
    return 0.5 * (h + x2)


def _up_block(p, x, up_scale):
    for i in range(up_scale):
        x = _smish(nn.conv2d(x, p["features"][str(3 * i)]))
        x = nn.conv2d_transpose(x, p["features"][str(3 * i + 2)], stride=2,
                                padding=_UP_PADS[up_scale])
    return x


def teed_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] raw 0..255, H and W even → the averaged sigmoid edge map [B,H,W]."""
    b1 = _double_conv(params["block_1"], x, stride=2)
    b1_side = nn.conv2d(b1, params["side_1"]["conv"], stride=2)
    b2 = _double_conv(params["block_2"], b1, use_act=False)
    b2_down = F.max_pool2d(b2, 3, 2, padding=1)
    b3_pre = nn.conv2d(b2_down, params["pre_dense_3"]["conv"])
    b3 = _dense_layer(params["dblock_3"]["denselayer1"], b2_down + b1_side, b3_pre)
    out1 = _up_block(params["up_block_1"], b1, 1)
    out2 = _up_block(params["up_block_2"], b2, 1)
    out3 = _up_block(params["up_block_3"], b3, 2)
    fp = params["block_cat"]
    attn = nn.conv2d(_smish(torch.cat([out1, out2, out3], dim=1)), fp["DWconv1"], padding=1,
                     groups=3)
    attn2 = nn.conv2d(_smish(attn), fp["DWconv2"], padding=1, groups=attn.shape[1])
    fused = _smish((attn2 + attn).sum(dim=1))
    h, w = x.shape[2:]
    maps = [resize(m, (h, w), "bilinear") for m in (out1[:, 0], out2[:, 0], out3[:, 0], fused)]
    return torch.sigmoid(torch.stack(maps, dim=-1).mean(dim=-1))


class TeedDetector(Detector):
    # bf16 against f32 on an H100: 27.89 dB, under the 30 dB bar (PERF.md §4)
    DTYPE = torch.float32

    def __init__(self, model_dir: str = "models/TEED", **kw):
        super().__init__(model_dir, missing="no TEED checkpoint", **kw)

    def detect(self, img: np.ndarray, safe_steps: int = 2) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        nh, nw = ((h + 7) // 8) * 8, ((w + 7) // 8) * 8
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_CUBIC) if (nh, nw) != (h, w) else img
        with inference():
            edge = to_numpy(teed_apply(params, self.image_tensor(feed))[0])
        edge = cv2_np.resize(edge, (w, h), cv2_np.INTER_LINEAR)
        if safe_steps:
            edge = safe_step(edge, safe_steps)
        return (edge * 255.0).clip(0, 255).astype(np.uint8)


_DETECTOR: Optional[TeedDetector] = None


def get_teed(device=None) -> TeedDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = TeedDetector(device=device)
    return _DETECTOR


def softedge_teed(img, res, a, b):
    return gray_map(get_teed().detect(resize_image(img, res), safe_steps=int(a) if a else 2))

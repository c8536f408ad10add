"""MangaLineExtraction (lineart_anime_denoise): the res_skip net "erika"
(port of forge_tpu/preprocessors/manga_line.py).

A grayscale residual hourglass: blocks of BatchNorm (eps 1e-3), LeakyReLU
0.2 and a conv; five down stages (2, 3, 5, 7, 12 blocks, the last block of
stages 1–4 at stride 2), four nearest-upsample stages with the encoder's
skips, two more blocks and a 1×1 head; the map is 255 − the net's output.
The input is OpenCV's RGB→GRAY of the image, edge-padded to multiples of 16.
Checkpoint: the first .pth/.pt/.safetensors under models/manga_line
(erika.pth).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.nn import upsample_nearest_2x
from . import cv2_np
from .annotator import Detector, batch_norm, gray_map, inference, strip_module, to_numpy
from .cv import resize_image


def _bn_relu_conv(p, x, stride=1, up=False):
    x = F.leaky_relu(batch_norm(x, p["0"], 1e-3), 0.2)
    k = p["2"]["weight"].shape[-1]
    x = nn.conv2d(x, p["2"], stride=stride, padding=k // 2)
    return upsample_nearest_2x(x) if up else x


def _basic(p, x, stride=1):
    y = _bn_relu_conv(p["residual"]["model"], _bn_relu_conv(p["conv1"]["model"], x, stride))
    sc = nn.conv2d(x, p["shortcut"]["model"]["0"], stride=stride) if "shortcut" in p else x
    return sc + y


def _u_basic(p, x):
    y = _bn_relu_conv(p["residual"]["model"], _bn_relu_conv(p["conv1"]["model"], x, up=True))
    sc = nn.conv2d(x, p["shortcut"]["model"]["0"]) if "shortcut" in p else x
    return upsample_nearest_2x(sc) + y


def _down_block(p, x, reps, first):
    for i in range(reps):
        x = _basic(p["model"][str(i)], x, stride=2 if (i == reps - 1 and not first) else 1)
    return x


def _up_block(p, x, reps):
    x = _u_basic(p["model"]["0"], x)
    for i in range(1, reps):
        x = _basic(p["model"][str(i)], x)
    return x


def _skip_merge(p, enc, dec):
    return (nn.conv2d(enc, p["model"]["0"]) if "model" in p else enc) + dec


def manga_line_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,1,H,W] grayscale 0..255 (H, W multiples of 16) → line logits [B,1,H,W]."""
    x0 = _down_block(params["block0"], x, 2, True)
    x1 = _down_block(params["block1"], x0, 3, False)
    x2 = _down_block(params["block2"], x1, 5, False)
    x3 = _down_block(params["block3"], x2, 7, False)
    x4 = _down_block(params["block4"], x3, 12, False)
    h = _skip_merge(params.get("res1", {}), x3, _up_block(params["block5"], x4, 7))
    h = _skip_merge(params.get("res2", {}), x2, _up_block(params["block6"], h, 5))
    h = _skip_merge(params.get("res3", {}), x1, _up_block(params["block7"], h, 3))
    h = _skip_merge(params.get("res4", {}), x0, _up_block(params["block8"], h, 2))
    h = _down_block(params["block9"], h, 2, True)
    return _bn_relu_conv(params["conv15"]["model"], h)


class MangaLineDetector(Detector):
    DTYPE = torch.bfloat16  # 32.20 dB against f32 on an H100, over the 30 dB bar (PERF.md §4)

    def __init__(self, model_dir: str = "models/manga_line", **kw):
        super().__init__(model_dir, convert=strip_module, missing="no erika.pth", **kw)

    def detect(self, img: np.ndarray) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        gray = cv2_np.rgb_to_gray(img).astype(np.float32)
        nh, nw = ((h + 15) // 16) * 16, ((w + 15) // 16) * 16
        gray = np.pad(gray, ((0, nh - h), (0, nw - w)), mode="edge")
        with inference():
            line = to_numpy(manga_line_apply(params, self.image_tensor(gray))[0, 0, :h, :w])
        return (255.0 - line).clip(0, 255).astype(np.uint8)


_DETECTOR: Optional[MangaLineDetector] = None


def get_manga_line(device=None) -> MangaLineDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = MangaLineDetector(device=device)
    return _DETECTOR


def manga_line(img, res, a, b):
    return gray_map(get_manga_line().detect(resize_image(img, res)))

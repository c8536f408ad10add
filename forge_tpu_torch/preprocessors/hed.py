"""HED soft edges (softedge_hed, softedge_hedsafe, scribble_hed):
ControlNetHED_Apache2 (port of forge_tpu/preprocessors/hed.py).

Five blocks of 3×3 convs (2, 2, 3, 3, 3 layers; 2×2 max pools between
blocks), each with a 1-channel side projection; the side maps are resized
to the image (OpenCV's INTER_LINEAR, pipeline/images.py), averaged in
float64 and put through a sigmoid. The input is raw 0..255 RGB minus the
checkpoint's `norm`. Checkpoint: the first .pth/.pt/.safetensors under
models/hed (ControlNetHED.pth).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, gray_map, inference, max_pool_2x, safe_step, to_numpy
from .cv import gaussian_blur, resize_image

_LAYERS = {1: 2, 2: 2, 3: 3, 4: 3, 5: 3}


def hed_apply(params: Mapping[str, Any], x: torch.Tensor):
    """x [B,3,H,W] (raw 0..255) → five side maps [B,1,h_i,w_i]."""
    h = x - params["norm"].reshape(1, 3, 1, 1).to(x.dtype)
    outs = []
    for b in range(1, 6):
        blk = params[f"block{b}"]
        if b > 1:
            h = max_pool_2x(h)
        for i in range(_LAYERS[b]):
            h = F.relu(nn.conv2d(h, blk["convs"][str(i)], padding=1))
        outs.append(nn.conv2d(h, blk["projection"]))
    return outs


class HedDetector(Detector):
    DTYPE = torch.bfloat16  # 52.24 dB against f32 on an H100 (PERF.md §4)

    def __init__(self, model_dir: str = "models/hed", **kw):
        super().__init__(model_dir, missing="no ControlNetHED checkpoint", **kw)

    def detect(self, img: np.ndarray, is_safe: bool = False) -> np.ndarray:
        """uint8 [H,W,3] → soft edges uint8 [H,W]."""
        params = self.load()
        h, w = img.shape[:2]
        with inference():
            edges = hed_apply(params, self.image_tensor(img))
        maps = [cv2_np.resize(to_numpy(e[0, 0]), (w, h), cv2_np.INTER_LINEAR) for e in edges]
        edge = 1.0 / (1.0 + np.exp(-np.mean(np.stack(maps, 2), axis=2, dtype=np.float64)))
        if is_safe:
            edge = safe_step(edge)
        return (edge * 255.0).clip(0, 255).astype(np.uint8)


_DETECTOR: Optional[HedDetector] = None


def get_hed(device=None) -> HedDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = HedDetector(device=device)
    return _DETECTOR


def softedge_hed(img, res, a, b):
    return gray_map(get_hed().detect(resize_image(img, res)))


def softedge_hedsafe(img, res, a, b):
    return gray_map(get_hed().detect(resize_image(img, res), is_safe=True))


def scribble_hed(img, res, a, b):
    """HED, a σ-3 Gaussian and a threshold at 4/255."""
    edge = get_hed().detect(resize_image(img, res)).astype(np.float32) / 255.0
    g = gaussian_blur(edge[..., None], 3.0)[..., 0]
    return np.repeat((g > 4.0 / 255.0).astype(np.float32)[..., None], 3, axis=2)

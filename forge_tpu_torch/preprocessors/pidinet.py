"""PiDiNet soft edges (softedge_pidinet, softedge_pidisafe,
scribble_pidinet): config carv4, 60 channels, CDCM dilation 24 and CSAM
attention (port of forge_tpu/preprocessors/pidinet.py).

The pixel-difference convolutions (cd, ad, rd) are rewritten once, at load,
as plain convolutions (`convert_pidinet_sd`, host numpy copied from the
reference; rd becomes a 5×5 kernel), so the forward pass is a plain
convnet: 16 depthwise-separable residual blocks in 4 stages (2×2 max pools
into stages 2–4), each stage's CDCM (four dilated 3×3 convs, dilations 5,
7, 9, 11) and CSAM, 1-channel maps resized to the image (bilinear, half-pixel
centres: ops/resize.py) and fused by a 1×1 classifier and a sigmoid. The
input is BGR in [0, 1]. Checkpoint: models/pidinet/table5_pidinet.pth.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops import nn
from ..ops.resize import resize
from .annotator import (Detector, gray_map, inference, max_pool_2x, safe_step, strip_module,
                         to_numpy)
from .cv import resize_image

_CARV4 = ["cd", "ad", "rd", "cv"] * 4  # the pdc op of each layer (init_block is layer 0)


def _convert_pdc(w: np.ndarray, op: str) -> np.ndarray:
    """OIHW [C,1,3,3] pdc kernel → plain conv kernel (3×3, or 5×5 for rd)."""
    w = np.asarray(w, np.float32)
    if op == "cv":
        return w
    if op == "cd":
        out = w.copy()
        out[:, :, 1, 1] -= w.sum(axis=(2, 3))
        return out
    if op == "ad":
        flat = w.reshape(w.shape[0], w.shape[1], 9)
        rot = flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]  # clockwise
        return (flat - rot).reshape(w.shape)
    if op == "rd":
        flat = w.reshape(w.shape[0], w.shape[1], 9)
        buf = np.zeros((w.shape[0], w.shape[1], 25), np.float32)
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, 1:]
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, 1:]
        return buf.reshape(w.shape[0], w.shape[1], 5, 5)
    raise ValueError(op)


def convert_pidinet_sd(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The pdc → plain kernel rewrite of a checkpoint (OIHW)."""
    out = dict(sd)
    out["init_block.weight"] = _convert_pdc(sd["init_block.weight"], _CARV4[0])
    for s in range(1, 5):
        for j in range(1, 4 + (s > 1)):
            key = f"block{s}_{j}.conv1.weight"
            out[key] = _convert_pdc(sd[key], _CARV4[[0, 1, 4, 8, 12][s] + (j - 1)])
    return out


def _block(p: Mapping[str, Any], x: torch.Tensor, stride: int) -> torch.Tensor:
    if stride > 1:
        x = max_pool_2x(x)
    k = p["conv1"]["weight"].shape[-1]
    y = nn.conv2d(x, p["conv1"], padding=k // 2, groups=x.shape[1])
    y = nn.conv2d(torch.relu(y), p["conv2"])
    if "shortcut" in p:
        x = nn.conv2d(x, p["shortcut"])
    return y + x


def _cdcm(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    x = nn.conv2d(torch.relu(x), p["conv1"])
    return sum(nn.conv2d(x, p[name], padding=dil, dilation=dil)
               for name, dil in (("conv2_1", 5), ("conv2_2", 7), ("conv2_3", 9), ("conv2_4", 11)))


def _csam(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    y = nn.conv2d(torch.relu(x), p["conv1"])
    return x * torch.sigmoid(nn.conv2d(y, p["conv2"], padding=1))


def pidinet_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] BGR in [0, 1] → the fused edge map [B,1,H,W] in (0, 1)."""
    h, w = x.shape[2:]
    init_k = params["init_block"]["weight"].shape[-1]
    z = nn.conv2d(x, params["init_block"], padding=init_k // 2)
    stages = []
    for s in range(1, 5):
        for j in range(1, 4 + (s > 1)):
            z = _block(params[f"block{s}_{j}"], z, stride=2 if (s > 1 and j == 1) else 1)
        stages.append(z)
    maps = []
    for i, xi in enumerate(stages):
        f = _csam(params["attentions"][str(i)], _cdcm(params["dilations"][str(i)], xi))
        maps.append(resize(nn.conv2d(f, params["conv_reduces"][str(i)]["conv"]), (h, w),
                           "bilinear"))
    return torch.sigmoid(nn.conv2d(torch.cat(maps, dim=1), params["classifier"]))


class PidiDetector(Detector):
    DTYPE = torch.bfloat16  # 52.54 dB against f32 on an H100 (PERF.md §4)

    def __init__(self, model_dir: str = "models/pidinet", **kw):
        super().__init__(model_dir, filename="table5_pidinet.pth",
                         convert=lambda sd: convert_pidinet_sd(strip_module(sd)),
                         missing="no table5_pidinet.pth", **kw)

    def detect(self, img: np.ndarray, is_safe: bool = False,
               apply_filter: bool = False) -> np.ndarray:
        """uint8 RGB [H,W,3] → edges uint8 [H,W]."""
        params = self.load()
        with inference():
            edge = to_numpy(pidinet_apply(params, self.image_tensor(
                img[:, :, ::-1].astype(np.float32) / 255.0))[0, 0])
        if apply_filter:
            edge = (edge > 0.5).astype(np.float32)
        if is_safe:
            edge = safe_step(edge)
        return (edge * 255.0).clip(0, 255).astype(np.uint8)


_DETECTOR: Optional[PidiDetector] = None


def get_pidinet(device=None) -> PidiDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = PidiDetector(device=device)
    return _DETECTOR


def softedge_pidinet(img, res, a, b):
    return gray_map(get_pidinet().detect(resize_image(img, res)))


def softedge_pidisafe(img, res, a, b):
    return gray_map(get_pidinet().detect(resize_image(img, res), is_safe=True))


def scribble_pidinet(img, res, a, b):
    return gray_map(get_pidinet().detect(resize_image(img, res), apply_filter=True))

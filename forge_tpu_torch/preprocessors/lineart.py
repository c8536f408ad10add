"""Lineart (lineart_realistic, lineart_coarse, lineart_anime) (port of
forge_tpu/preprocessors/lineart.py).

  * realistic and coarse: the sketch-simplification Generator(3, 1, n):
    a reflection-padded 7×7 stem, two stride-2 convs, n residual blocks (n
    from the keys), two transpose convs (k3, s2, p1, output padding 1), a
    7×7 head and a sigmoid; InstanceNorm without affine weights.
  * anime: UnetGenerator(3, 1, 8, 64) with InstanceNorm, eight stride-2
    downs with skip concats and a tanh head, its nested Sequential keys
    walked recursively (an innermost block is the one whose index 3 is the
    up-conv). The feed is the image at multiples of 256 (OpenCV's
    INTER_CUBIC), and the map goes back to the image's size the same way.

InstanceNorm's variance is E[x²] − E[x]² in float32, as the reference's.
Checkpoints: models/lineart/sk_model.pth (realistic), sk_model2.pth
(coarse), models/lineart_anime/netG.pth.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, gray_map, inference, strip_module, to_numpy
from .cv import resize_image


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per sample and channel, f32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _refl_conv(x, p, pad):
    return nn.conv2d(F.pad(x, (pad, pad, pad, pad), mode="reflect"), p)


def lineart_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] in [0, 1] → the line map [B,1,H,W] in [0, 1]."""
    h = F.relu(_instance_norm(_refl_conv(x, params["model0"]["1"], 3)))
    for i in ("0", "3"):
        h = F.relu(_instance_norm(nn.conv2d(h, params["model1"][i], stride=2, padding=1)))
    for i in range(len(params["model2"])):
        blk = params["model2"][str(i)]["conv_block"]
        r = F.relu(_instance_norm(_refl_conv(h, blk["1"], 1)))
        h = h + _instance_norm(_refl_conv(r, blk["5"], 1))
    for i in ("0", "3"):
        h = F.relu(_instance_norm(nn.conv2d_transpose(h, params["model3"][i], stride=2,
                                                      padding=1, output_padding=1)))
    return torch.sigmoid(_refl_conv(h, params["model4"]["1"], 3))


def lineart_anime_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] in [−1, 1], H and W multiples of 256 → [B,1,H,W] in [−1, 1]."""

    def block(p: Mapping[str, Any], h: torch.Tensor, outermost: bool) -> torch.Tensor:
        if outermost:
            d = block(p["1"]["model"], nn.conv2d(h, p["0"], stride=2, padding=1), False)
            return torch.tanh(nn.conv2d_transpose(F.relu(d), p["3"], stride=2, padding=1))
        down = nn.conv2d(F.leaky_relu(h, 0.2), p["1"], stride=2, padding=1)
        if "model" in p["3"]:  # a middle block: norm → submodule → up → norm
            d = block(p["3"]["model"], _instance_norm(down), False)
            u = nn.conv2d_transpose(F.relu(d), p["5"], stride=2, padding=1)
        else:  # the innermost: no norm after the down conv, the up conv at index 3
            u = nn.conv2d_transpose(F.relu(down), p["3"], stride=2, padding=1)
        return torch.cat([h, _instance_norm(u)], dim=1)

    return block(params["model"]["model"], x, True)


class LineartDetector(Detector):
    # bf16 against f32 on an H100: 44.97 dB (realistic), 46.14 (coarse) (PERF.md §4)
    DTYPE = torch.bfloat16

    def __init__(self, coarse: bool = False, model_dir: str = "models/lineart", **kw):
        super().__init__(model_dir, filename="sk_model2.pth" if coarse else "sk_model.pth",
                         convert=strip_module, missing="no lineart checkpoint", **kw)

    def detect(self, img: np.ndarray) -> np.ndarray:
        """uint8 [H,W,3] → the line map uint8 [H,W] (white lines on black)."""
        params = self.load()
        with inference():
            line = to_numpy(lineart_apply(params, self.image_tensor(
                img.astype(np.float32) / 255.0))[0, 0])
        return (line * 255.0).clip(0, 255).astype(np.uint8)


class LineartAnimeDetector(Detector):
    DTYPE = torch.bfloat16  # 44.56 dB against f32 on an H100 (PERF.md §4)

    def __init__(self, model_dir: str = "models/lineart_anime", **kw):
        super().__init__(model_dir, filename="netG.pth", convert=strip_module,
                         missing="no netG checkpoint", **kw)

    def detect(self, img: np.ndarray) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        hn, wn = [256 * int(np.ceil(s / 256.0)) for s in (h, w)]
        feed = cv2_np.resize(img, (wn, hn), cv2_np.INTER_CUBIC)
        with inference():
            line = to_numpy(lineart_anime_apply(params, self.image_tensor(
                feed.astype(np.float32) / 127.5 - 1.0))[0, 0]) * 127.5 + 127.5
        line = cv2_np.resize(line.astype(np.float32), (w, h), cv2_np.INTER_CUBIC)
        return line.clip(0, 255).astype(np.uint8)


_DETECTORS: Dict[str, Detector] = {}


def get_lineart(kind: str = "realistic", device=None) -> Detector:
    if kind not in _DETECTORS:
        _DETECTORS[kind] = (LineartAnimeDetector(device=device) if kind == "anime"
                            else LineartDetector(coarse=kind == "coarse", device=device))
    return _DETECTORS[kind]


def _entry(kind: str):
    def call(img, res, a, b):
        return gray_map(255 - get_lineart(kind).detect(resize_image(img, res)))

    return call


lineart_realistic = _entry("realistic")
lineart_coarse = _entry("coarse")
lineart_anime = _entry("anime")

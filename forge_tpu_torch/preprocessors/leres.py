"""LeReS relative depth (depth_leres), AdelaiDepth's RelDepthModel (port of
forge_tpu/preprocessors/leres.py).

A torchvision ResNeXt101-32x8d backbone (its four lateral features) and the
FTB/FFM/AO decoder (network_auxi.py:15 Decoder). Block counts, the group
width and the downsamples come from the checkpoint, so res50 files load
too. The reference's input quirks are kept (depthmap.py:17 scale_torch):
the image is not divided by 255 before the (0.485, 0.229) normalization,
and its channels are flipped to BGR (leres/__init__.py:36). The feed and
the depth map go through OpenCV's INTER_CUBIC (preprocessors/cv2_np.py);
the two sliders cut the map at its Remove Near and Remove Background
percentiles. The reference's optional pix2pix "boost" merge is not ported,
as the reference does not port it.

Checkpoint: models/leres/res*.pth (its `depth_model` dict, `module.`
dropped, or the flat `depth_model.*` keys).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, batch_norm, inference, resize_align, strip_module, to_numpy
from .cv import resize_image

_BN_EPS = 1e-5


def _bn(x, p):
    return batch_norm(x, p, _BN_EPS)


def _bottleneck(p: Mapping[str, Any], x: torch.Tensor, stride: int, groups: int) -> torch.Tensor:
    h = F.relu(_bn(nn.conv2d(x, p["conv1"]), p["bn1"]))
    h = F.relu(_bn(nn.conv2d(h, p["conv2"], stride=stride, padding=1, groups=groups), p["bn2"]))
    h = _bn(nn.conv2d(h, p["conv3"]), p["bn3"])
    if "downsample" in p:
        x = _bn(nn.conv2d(x, p["downsample"]["0"], stride=stride), p["downsample"]["1"])
    return F.relu(h + x)


def _resnext_features(p: Mapping[str, Any], x: torch.Tensor):
    """torchvision's ResNet._forward_impl without the classifier: the
    [1/4, 1/8, 1/16, 1/32] lateral features."""
    w = p["layer1"]["0"]["conv2"]["weight"]  # [out, in/groups, 3, 3], in == out in a bottleneck
    groups = max(int(w.shape[0]) // int(w.shape[1]), 1)
    h = F.relu(_bn(nn.conv2d(x, p["conv1"], stride=2, padding=3), p["bn1"]))
    h = F.max_pool2d(h, 3, 2, padding=1)
    feats = []
    for li in range(1, 5):
        layer = p[f"layer{li}"]
        for bi in range(len(layer)):
            h = _bottleneck(layer[str(bi)], h, 2 if (li > 1 and bi == 0) else 1, groups)
        feats.append(h)
    return feats


def _ftb(p, x):
    x = nn.conv2d(x, p["conv1"], padding=1)
    b = nn.conv2d(F.relu(x), p["conv_branch"]["1"], padding=1)
    b = nn.conv2d(F.relu(_bn(b, p["conv_branch"]["2"])), p["conv_branch"]["4"], padding=1)
    return F.relu(x + b)


def _ffm(p, low, high, upfactor=2):
    x = _ftb(p["ftb2"], _ftb(p["ftb1"], low) + high)
    return resize_align(x, (x.shape[2] * upfactor, x.shape[3] * upfactor))


def leres_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] normalized, BGR (H, W multiples of 32) → depth [B,H,W]."""
    enc = params["depth_model"]["encoder_modules"]["encoder"]
    dec = params["depth_model"]["decoder_modules"]
    f4, f8, f16, f32 = _resnext_features(enc, x)
    h = nn.conv2d(_ftb(dec["conv"], f32), dec["conv1"], padding=1)
    h = resize_align(h, (h.shape[2] * 2, h.shape[3] * 2))  # 1/16
    h = _ffm(dec["ffm2"], f16, h)                           # 1/8
    h = _ffm(dec["ffm1"], f8, h)                            # 1/4
    h = _ffm(dec["ffm0"], f4, h)                            # 1/2
    ao = dec["outconv"]["adapt_conv"]
    h = F.relu(_bn(nn.conv2d(h, ao["0"], padding=1), ao["1"]))
    h = nn.conv2d(h, ao["3"], padding=1)
    return resize_align(h, (h.shape[2] * 2, h.shape[3] * 2))[:, 0]  # full size


def _convert(sd):
    if isinstance(sd.get("depth_model"), dict):
        sd = {f"depth_model.{k}": v for k, v in sd["depth_model"].items()}
    return strip_module(sd)


class LeresDetector(Detector):
    DTYPE = torch.bfloat16  # PERF.md §4

    def __init__(self, model_dir: str = "models/leres", **kw):
        super().__init__(model_dir, match="res", suffixes=(".pth", ".pt", ".safetensors"),
                         convert=_convert, missing="no res101.pth", **kw)

    def path(self):
        p = super().path()  # the reference takes a file whose name starts "res"
        return p if p is None or p.rsplit("/", 1)[-1].startswith("res") else None

    def detect(self, img: np.ndarray, thr_a: float = 0.0, thr_b: float = 0.0) -> np.ndarray:
        """uint8 RGB [H,W,3] → the normalized depth uint8 [H,W] (the
        reference's apply_leres with its remove-near and background cuts)."""
        params = self.load()
        h, w = img.shape[:2]
        nh, nw = ((h + 31) // 32) * 32, ((w + 31) // 32) * 32
        feed = cv2_np.resize(np.ascontiguousarray(img[:, :, ::-1]), (nw, nh),
                             cv2_np.INTER_CUBIC).astype(np.float32)
        feed = (feed - np.asarray([0.485, 0.456, 0.406], np.float32)) \
            / np.asarray([0.229, 0.224, 0.225], np.float32)
        with inference():
            depth = to_numpy(leres_apply(params, self.image_tensor(feed))[0])
        depth = cv2_np.resize(depth, (w, h), cv2_np.INTER_CUBIC)
        lo, hi = depth.min(), depth.max()
        out = (depth - lo) / max(hi - lo, np.finfo(np.float32).eps)
        if thr_a:  # the remove-near and remove-background cuts
            out = np.where(out < np.percentile(out, thr_a), 0.0, out)
        if thr_b:
            out = np.where(out > np.percentile(out, 100 - thr_b), 1.0, out)
        return (out * 255.0).clip(0, 255).astype(np.uint8)


_DETECTOR: Optional[LeresDetector] = None


def get_leres(device=None) -> LeresDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = LeresDetector(device=device)
    return _DETECTOR


def depth_leres(img, res, a, b):
    d = get_leres().detect(resize_image(img, res), thr_a=a or 0, thr_b=b or 0)
    return np.repeat(d[..., None].astype(np.float32) / 255.0, 3, axis=2)

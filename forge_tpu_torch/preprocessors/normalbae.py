"""NormalBAE surface normals (normalbae): NNET's tf_efficientnet_b5_ap
encoder and its BN decoder (port of forge_tpu/preprocessors/normalbae.py).

The encoder is geffnet's EfficientNet with TF "SAME" padding (the smaller
half before, the larger after, from the input's size), swish and
squeeze-excite, in the stage plan all of B0–B7 share (strides 1, 2, 2, 2,
1, 2, 1); every width, kernel, expansion and block kind comes from the
checkpoint. The decoder reads blocks 0, 1, 2 and 4 and the conv head
before its BatchNorm: a 1×1 conv, four UpSampleBN stages (bilinear with
align_corners=True), a 3×3 head at 1/8, then three pixel-MLP refinements,
each after a ×2 upsample of the features and of the previous estimate,
with norm_normalize (unit normal; kappa = elu + 1.01) after every head.
The map is (n + 1)/2 of the full-resolution head, back to the image's size
by OpenCV's INTER_LINEAR. The feed is OpenCV's INTER_AREA to multiples of 32.
Checkpoint: the first .pt/.pth/.safetensors under models/normalbae
(scannet.pt: its `model` dict, `module.` dropped).
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import (IMAGENET_MEAN, IMAGENET_STD, Detector, batch_norm, inference,
                        resize_align, strip_module, to_numpy)
from .cv import resize_image

_BN_EPS = 1e-3  # geffnet's BN_EPS_TF_DEFAULT
_STAGE_STRIDES = (1, 2, 2, 2, 1, 2, 1)


def _bn(x, p):
    return batch_norm(x, p, _BN_EPS)


def _conv_same(x, p, stride=1, groups=1):
    """TF "SAME": the padding total from the input's size, the smaller half first."""
    kh, kw = p["weight"].shape[2:]

    def pad(i, k):
        total = max((math.ceil(i / stride) - 1) * stride + k - i, 0)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = pad(x.shape[2], kh), pad(x.shape[3], kw)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return nn.conv2d(x, p, stride=stride, groups=groups)


def _se(p, x):
    s = F.silu(_conv_same(x.mean(dim=(2, 3), keepdim=True), p["conv_reduce"]))
    return x * torch.sigmoid(_conv_same(s, p["conv_expand"]))


def _eff_block(p: Mapping[str, Any], x: torch.Tensor, stride: int) -> torch.Tensor:
    cin = x.shape[1]
    if "conv_pwl" in p:  # InvertedResidual: pw expand, dw, SE, pw linear
        h = F.silu(_bn(_conv_same(x, p["conv_pw"]), p["bn1"]))
        h = F.silu(_bn(_conv_same(h, p["conv_dw"], stride=stride, groups=h.shape[1]), p["bn2"]))
        h = _bn(_conv_same(_se(p["se"], h), p["conv_pwl"]), p["bn3"])
    else:  # DepthwiseSeparable (stage 0)
        h = F.silu(_bn(_conv_same(x, p["conv_dw"], stride=stride, groups=cin), p["bn1"]))
        h = _bn(_conv_same(_se(p["se"], h), p["conv_pw"]), p["bn2"])
    return h + x if stride == 1 and cin == h.shape[1] else h


def _norm_normalize(out: torch.Tensor) -> torch.Tensor:
    n, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt(n.square().sum(dim=1, keepdim=True)) + 1e-10
    return torch.cat([n / norm, F.elu(kappa) + 1.01], dim=1)


def _upsample_bn(p, x, skip):
    h = torch.cat([resize_align(x, skip.shape[2:]), skip], dim=1)
    h = F.leaky_relu(_bn(nn.conv2d(h, p["0"], padding=1), p["1"]), 0.01)
    return F.leaky_relu(_bn(nn.conv2d(h, p["3"], padding=1), p["4"]), 0.01)


def _pixel_mlp(p, feat, prev):
    """Conv1d(k=1) refinement over ×2 upsampled features and estimate."""
    size = (feat.shape[2] * 2, feat.shape[3] * 2)
    h = torch.cat([resize_align(feat, size), resize_align(prev, size)], dim=1)
    n = len(p)
    for i in range(0, 2 * n - 1, 2):  # the Sequential's indices 0, 2, 4, 6
        w = p[str(i)]["weight"]  # [O, I, 1]
        h = torch.einsum("bihw,oi->bohw", h, w[..., 0].to(h.dtype)) \
            + p[str(i)]["bias"].to(h.dtype)[None, :, None, None]
        if i < 2 * (n - 1):
            h = F.relu(h)
    return _norm_normalize(h)


def normalbae_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] ImageNet-normalized → [B,4,H,W] (unit normal, kappa)."""
    enc = params["encoder"]["original_model"]
    h = F.silu(_bn(_conv_same(x, enc["conv_stem"], stride=2), enc["bn1"]))
    stage_outs = []
    for b in range(len(enc["blocks"])):
        stage = enc["blocks"][str(b)]
        for i in range(len(stage)):
            h = _eff_block(stage[str(i)], h, _STAGE_STRIDES[b] if i == 0 else 1)
        stage_outs.append(h)
    xb0, xb1, xb2, xb3 = stage_outs[0], stage_outs[1], stage_outs[2], stage_outs[4]
    xb4 = _conv_same(stage_outs[-1], enc["conv_head"])  # before bn2
    dec = params["decoder"]
    x_d1 = _upsample_bn(dec["up1"]["_net"], nn.conv2d(xb4, dec["conv2"]), xb3)
    x_d2 = _upsample_bn(dec["up2"]["_net"], x_d1, xb2)
    x_d3 = _upsample_bn(dec["up3"]["_net"], x_d2, xb1)
    x_d4 = _upsample_bn(dec["up4"]["_net"], x_d3, xb0)
    out = _norm_normalize(nn.conv2d(x_d2, dec["out_conv_res8"], padding=1))
    out = _pixel_mlp(dec["out_conv_res4"], x_d2, out)
    out = _pixel_mlp(dec["out_conv_res2"], x_d3, out)
    return _pixel_mlp(dec["out_conv_res1"], x_d4, out)


def _convert(sd):
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v for k, v in strip_module(sd).items() if not k.startswith("n_")}


class NormalBaeDetector(Detector):
    DTYPE = torch.bfloat16  # 47.63 dB against f32 on an H100 (PERF.md §4)

    def __init__(self, model_dir: str = "models/normalbae", **kw):
        super().__init__(model_dir, suffixes=(".pt", ".pth", ".safetensors"), convert=_convert,
                         missing="no scannet.pt", **kw)

    def detect(self, img: np.ndarray) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        nh, nw = ((h + 31) // 32) * 32, ((w + 31) // 32) * 32
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_AREA)
        feed = (feed.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        with inference():
            out = to_numpy(normalbae_apply(params, self.image_tensor(feed))[0]).transpose(1, 2, 0)
        rgb = ((out[..., :3] + 1.0) * 0.5).clip(0, 1)
        return cv2_np.resize((rgb * 255.0).astype(np.uint8), (w, h), cv2_np.INTER_LINEAR)


_DETECTOR: Optional[NormalBaeDetector] = None


def get_normalbae(device=None) -> NormalBaeDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = NormalBaeDetector(device=device)
    return _DETECTOR


def normalbae(img, res, a, b):
    return np.asarray(get_normalbae().detect(resize_image(img, res)), np.float32) / 255.0

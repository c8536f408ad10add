"""Anime face segmentation (seg_anime_face): a UNet over MobileNetV2 (port
of forge_tpu/preprocessors/anime_face.py).

The reference's annotator/anime_face_segment/__init__.py:29: five slices
of torchvision's MobileNetV2 features (symmetric padding, ReLU6, BatchNorm)
as the encoder, a decoder of nearest ×2 upsamples, 3×3 convs, instance
norm and leaky ReLU 0.1 with the skips resized bilinearly
(align_corners=True) and concatenated, and a 7-class softmax head; the map
is the argmax's palette colour (background, hair, eye, mouth, face, skin,
clothes). The feed is OpenCV's INTER_CUBIC to the short side 512 in
multiples of 32, the map back by INTER_NEAREST (preprocessors/cv2_np.py).
Checkpoint: the first .pth/.pt/.safetensors under models/anime_face_segment
(UNet.pth, `module.` dropped).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, batch_norm, inference, resize_align, strip_module
from .cv import resize_image

PALETTE = np.asarray([(255, 255, 0), (0, 0, 255), (255, 0, 0), (255, 255, 255),
                      (0, 255, 0), (0, 255, 255), (255, 0, 255)], np.uint8)

# torchvision MobileNetV2's feature strides (inverted-residual config
# (1,16,1,1), (6,24,2,2), (6,32,3,2), (6,64,4,2), (6,96,3,1), (6,160,3,2))
_STRIDES = {1: 1, 2: 2, 3: 1, 4: 2, 5: 1, 6: 1, 7: 2, 8: 1, 9: 1, 10: 1,
            11: 1, 12: 1, 13: 1, 14: 2, 15: 1, 16: 1}
_EN_BLOCKS = {0: (0, 1), 1: (2, 3), 2: (4, 6), 3: (7, 13), 4: (14, 16)}


def _bn(x, p):
    return batch_norm(x, p, 1e-5)


def _conv_bn_relu6(p, x, stride=1, groups=1):
    k = p["0"]["weight"].shape[-1]
    x = nn.conv2d(x, p["0"], stride=stride, padding=(k - 1) // 2, groups=groups)
    return _bn(x, p["1"]).clamp(0.0, 6.0)


def _inverted_residual(p, x, stride):
    seq = p["conv"]
    h, i = x, 0
    if len(seq) == 4:  # expand ratio > 1: [pw ConvBNReLU, dw ConvBNReLU, conv, bn]
        h, i = _conv_bn_relu6(seq["0"], h), 1
    dw = seq[str(i)]
    h = _conv_bn_relu6(dw, h, stride=stride, groups=dw["0"]["weight"].shape[0])
    h = _bn(nn.conv2d(h, seq[str(i + 1)]), seq[str(i + 2)])
    if stride == 1 and x.shape[1] == h.shape[1]:
        h = h + x
    return h


def _instance_norm(x, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _de_block(p, x, final=False):
    x = nn.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), p["1"], padding=1)
    if final:
        return torch.softmax(x.float(), dim=1)
    return F.leaky_relu(_instance_norm(x), 0.1)


def anime_face_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] in [0,1] → class probabilities [B,7,H,W] f32."""
    feats, h = [], x
    for blk in range(5):
        p = params[f"en_block{blk}"]
        lo, hi = _EN_BLOCKS[blk]
        for seq_i, feat_i in enumerate(range(lo, hi + 1)):
            sub = p[str(seq_i)]
            h = (_conv_bn_relu6(sub, h, stride=2) if feat_i == 0  # the stem ConvBNReLU
                 else _inverted_residual(sub, h, _STRIDES[feat_i]))
        feats.append(h)
    e0, e1, e2, e3, e4 = feats
    d = resize_align(_de_block(params["de_block4"], e4), e3.shape[2:])
    d = resize_align(_de_block(params["de_block3"], torch.cat([d, e3], 1)), e2.shape[2:])
    d = resize_align(_de_block(params["de_block2"], torch.cat([d, e2], 1)), e1.shape[2:])
    d = resize_align(_de_block(params["de_block1"], torch.cat([d, e1], 1)), e0.shape[2:])
    return _de_block(params["de_block0"], torch.cat([d, e0], 1), final=True)


class AnimeFaceSegmenter(Detector):
    DTYPE = torch.float32  # in bf16 the palette map differs from f32's (PERF.md §4)

    def __init__(self, model_dir: str = "models/anime_face_segment", **kw):
        super().__init__(model_dir, suffixes=(".pth", ".pt", ".safetensors"),
                         convert=strip_module, missing="no UNet.pth", **kw)

    def detect(self, img: np.ndarray) -> np.ndarray:
        params = self.load()
        h, w = img.shape[:2]
        scale = 512.0 / min(h, w)
        nh = int(round(h * scale / 32)) * 32
        nw = int(round(w * scale / 32)) * 32
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_CUBIC).astype(np.float32) / 255.0
        with inference():
            labels = anime_face_apply(params, self.image_tensor(feed))[0].argmax(dim=0)
        out = PALETTE[labels.cpu().numpy()]
        return cv2_np.resize(out, (w, h), cv2_np.INTER_NEAREST)


_DETECTOR: Optional[AnimeFaceSegmenter] = None


def get_anime_face(device=None) -> AnimeFaceSegmenter:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = AnimeFaceSegmenter(device=device)
    return _DETECTOR


def seg_anime_face(img, res, a, b):
    return np.asarray(get_anime_face().detect(resize_image(img, res)), np.float32) / 255.0

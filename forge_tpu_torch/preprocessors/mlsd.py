"""M-LSD line segments (mlsd): MobileV2_MLSD_Large and its line decode
(port of forge_tpu/preprocessors/mlsd.py).

A truncated MobileNetV2 backbone (a 4-channel input: RGB and a plane of
ones; TFLite's asymmetric stride-2 padding, one row and column at the
bottom and right), an FPN of 1×1 fuses (bilinear ×2 with align_corners=True)
and residual 3×3 blocks, and a dilated head whose channels 7:16 carry the
line centres and the start and end displacements. The decode (sigmoid,
3×3 max NMS through scipy, top 200, the displacement endpoints) is host
numpy copied from the reference; the segments are drawn with
preprocessors/cv2_np.py `line`. The feed is OpenCV's INTER_AREA to 512².
Checkpoint: the first .pth/.pt/.safetensors under models/mlsd
(mlsd_large_512_fp32.pth).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, batch_norm, gray_map, inference, resize_align, to_numpy
from .cv import resize_image

_BN_EPS = 1e-5
# the truncated MobileNetV2: (expand ratio, repeats, first stride) a stage
_MBV2 = [(1, 1, 1), (6, 2, 2), (6, 3, 2), (6, 4, 2), (6, 3, 1)]
_FPN_SELECTED = (1, 3, 6, 10, 13)


def _conv_bn_relu6(x, p, stride=1, groups=1):
    """ConvBNReLU: at stride 2 TFLite's (0, 1, 0, 1) padding and none in the conv."""
    k = p["0"]["weight"].shape[-1]
    if stride == 2:
        x, pad = F.pad(x, (0, 1, 0, 1)), 0
    else:
        pad = (k - 1) // 2
    x = nn.conv2d(x, p["0"], stride=stride, padding=pad, groups=groups)
    return batch_norm(x, p["1"], _BN_EPS).clamp(0.0, 6.0)


def _inverted_residual(x, p, stride, expand):
    h, seq, i = x, p["conv"], 0
    if expand:
        h, i = _conv_bn_relu6(h, seq["0"]), 1
    h = _conv_bn_relu6(h, seq[str(i)], stride=stride, groups=seq[str(i)]["0"]["weight"].shape[0])
    h = batch_norm(nn.conv2d(h, seq[str(i + 1)]), seq[str(i + 2)], _BN_EPS)
    return h + x if stride == 1 and x.shape[1] == h.shape[1] else h


def _block_a(pa, a, b, upscale=True):
    b = F.relu(batch_norm(nn.conv2d(b, pa["conv1"]["0"]), pa["conv1"]["1"], _BN_EPS))
    a = F.relu(batch_norm(nn.conv2d(a, pa["conv2"]["0"]), pa["conv2"]["1"], _BN_EPS))
    if upscale:
        b = resize_align(b, (b.shape[2] * 2, b.shape[3] * 2))
    return torch.cat([a, b], dim=1)


def _block_b(pb, x):
    x = F.relu(batch_norm(nn.conv2d(x, pb["conv1"]["0"], padding=1), pb["conv1"]["1"],
                          _BN_EPS)) + x
    return F.relu(batch_norm(nn.conv2d(x, pb["conv2"]["0"], padding=1), pb["conv2"]["1"],
                             _BN_EPS))


def _block_c(pc, x):
    h = F.relu(batch_norm(nn.conv2d(x, pc["conv1"]["0"], padding=5, dilation=5),
                          pc["conv1"]["1"], _BN_EPS))
    h = F.relu(batch_norm(nn.conv2d(h, pc["conv2"]["0"], padding=1), pc["conv2"]["1"], _BN_EPS))
    return nn.conv2d(h, pc["conv3"])


def mlsd_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [1,4,H,W] in [−1, 1] → [1,9,H/2,W/2]."""
    feats = params["backbone"]["features"]
    h = _conv_bn_relu6(x, feats["0"], stride=2)
    fpn, idx = [], 1
    for t, n, s in _MBV2:
        for i in range(n):
            h = _inverted_residual(h, feats[str(idx)], s if i == 0 else 1, t != 1)
            if idx in _FPN_SELECTED:
                fpn.append(h)
            idx += 1
    c1, c2, c3, c4, c5 = fpn
    h = _block_b(params["block16"], _block_a(params["block15"], c4, c5, upscale=False))
    h = _block_b(params["block18"], _block_a(params["block17"], c3, h))
    h = _block_b(params["block20"], _block_a(params["block19"], c2, h))
    h = _block_b(params["block22"], _block_a(params["block21"], c1, h))
    return _block_c(params["block23"], h)[:, 7:]


def decode_lines(tp_map: np.ndarray, topk: int = 200, ksize: int = 3,
                 score_thr: float = 0.10, dist_thr: float = 20.0) -> np.ndarray:
    """[h,w,9] head output → [N,4] line segments in map coordinates
    (reference utils.py:20 deccode_output_score_and_ptss + :48 pred_lines)."""
    from scipy.ndimage import maximum_filter

    center = tp_map[:, :, 0]
    displacement = tp_map[:, :, 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    keep = maximum_filter(heat, size=ksize, mode="constant") == heat
    heat = heat * keep
    flat = heat.reshape(-1)
    idx = np.argsort(-flat)[:topk]
    scores = flat[idx]
    yy, xx = np.unravel_index(idx, heat.shape)
    start = displacement[:, :, :2]
    end = displacement[:, :, 2:]
    dist_map = np.sqrt(np.sum((start - end) ** 2, axis=-1))
    segments = []
    for y, x, score in zip(yy, xx, scores):
        if score > score_thr and dist_map[y, x] > dist_thr:
            dx0, dy0, dx1, dy1 = displacement[y, x]
            segments.append([x + dx0, y + dy0, x + dx1, y + dy1])
    return np.asarray(segments, np.float32).reshape(-1, 4)


class MlsdDetector(Detector):
    # 37.75 dB against f32 on an H100, at the 0.01 distance slider: the defaults draw nothing
    # from a random net (PERF.md §4)
    DTYPE = torch.bfloat16

    def __init__(self, model_dir: str = "models/mlsd", **kw):
        super().__init__(model_dir, missing="no mlsd checkpoint", **kw)

    def segments(self, img: np.ndarray, thr_v: float = 0.1, thr_d: float = 0.1) -> np.ndarray:
        """uint8 [H,W,3] → [N,4] segments in the 512² feed's coordinates."""
        params = self.load()
        size = 512
        resized = cv2_np.resize(img, (size, size), cv2_np.INTER_AREA)
        feed = np.concatenate([resized, np.ones((size, size, 1))], axis=-1)
        feed = feed.astype(np.float32) / 127.5 - 1.0
        with inference():
            tp = to_numpy(mlsd_apply(params, self.image_tensor(feed))[0]).transpose(1, 2, 0)
        return 2 * decode_lines(tp, 200, 3, float(thr_v or 0.1), float(thr_d or 0.1))

    def detect(self, img: np.ndarray, thr_v: float = 0.1, thr_d: float = 0.1) -> np.ndarray:
        """uint8 [H,W,3] → the line drawing uint8 [H,W]."""
        h, w = img.shape[:2]
        size = 512
        out = np.zeros((h, w), np.uint8)
        for x0, y0, x1, y1 in self.segments(img, thr_v, thr_d):
            cv2_np.line(out, (int(x0 * w / size), int(y0 * h / size)),
                        (int(x1 * w / size), int(y1 * h / size)), 255, 1)
        return out


_DETECTOR: Optional[MlsdDetector] = None


def get_mlsd(device=None) -> MlsdDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = MlsdDetector(device=device)
    return _DETECTOR


def mlsd(img, res, a, b):
    return gray_map(get_mlsd().detect(resize_image(img, res), thr_v=a or 0.1, thr_d=b or 0.1))

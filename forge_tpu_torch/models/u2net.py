"""U²-Net salient-object segmentation, the background-removal net behind
the birefnet Space (port of forge_tpu/models/u2net.py).

The published U²-Net (the rembg standard; the reference's stand-in for
BiRefNet, which it cannot download): six encoder stages and five decoder
stages of residual U-blocks (RSU-L: L−1 convs down by 2×2 max pools with
ceil mode, a dilated bottom conv, the convs back up concatenating the skip
and bilinear upsamples; RSU-4F for stage5, stage6 and stage5d: dilations
1, 2, 4, 8 and no pooling), a 3×3 side output a stage, all six at the
input's size fused by a 1×1 conv and a sigmoid. Each conv is conv →
BatchNorm (eval) → ReLU. Depths from the `rebnconvK` keys, widths from the
convs. Plain torch: no kernel. The resizes are OpenCV's (cv2_np.py), the
upsamples ops/resize.py's bilinear, as `jax.image.resize`.

Checkpoint: the first .pth/.pt/.safetensors under models/u2net (u2net or
u2netp, their keys stage1.rebnconvin.conv_s1.weight …).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize
from ..preprocessors import cv2_np
from ..preprocessors.annotator import IMAGENET_MEAN, IMAGENET_STD, batch_norm, inference

_F_STAGES = {"stage5", "stage6", "stage5d"}


def _rebnconv(p: Mapping[str, Any], x: torch.Tensor, dirate: int = 1) -> torch.Tensor:
    y = nn.conv2d(x, p["conv_s1"], padding=dirate, dilation=dirate)
    return F.relu(batch_norm(y, p["bn_s1"], 1e-5))


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2, the odd row and column kept (ceil mode, XLA's "SAME")."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return resize(x, tuple(like.shape[2:]), "bilinear").to(x.dtype)


def _rsu_depth(p: Mapping[str, Any]) -> int:
    return max(int(k[len("rebnconv"):]) for k in p
               if k.startswith("rebnconv") and not k.endswith("d") and k != "rebnconvin")


def _rsu(p: Mapping[str, Any], x: torch.Tensor, dilated: bool) -> torch.Tensor:
    depth = _rsu_depth(p)
    hin = _rebnconv(p["rebnconvin"], x)
    if dilated:  # RSU-F: dilations 1, 2, 4, 8…, no change of size
        feats = [hin]
        h = hin
        for i in range(1, depth + 1):
            h = _rebnconv(p[f"rebnconv{i}"], h, dirate=2 ** (i - 1))
            feats.append(h)
        d = feats[-1]
        for i in range(depth - 1, 0, -1):
            d = _rebnconv(p[f"rebnconv{i}d"], torch.cat([d, feats[i]], dim=1), dirate=2 ** (i - 1))
        return d + hin
    feats = []
    h = hin
    for i in range(1, depth):
        h = _rebnconv(p[f"rebnconv{i}"], h)
        feats.append(h)
        if i < depth - 1:
            h = _pool2(h)
    d = _rebnconv(p[f"rebnconv{depth}"], h, dirate=2)
    for i in range(depth - 1, 0, -1):
        d = _rebnconv(p[f"rebnconv{i}d"], torch.cat([d, feats[i - 1]], dim=1))
        if i > 1:
            d = _up_to(d, feats[i - 2])
    return d + hin


def u2net_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] normalized → the fused saliency [B, 1, H, W]: the
    sigmoid of the d0 fusion of the six side outputs."""
    enc = []
    h = x
    for i in range(1, 7):
        name = f"stage{i}"
        h = _rsu(params[name], h, name in _F_STAGES)
        enc.append(h)
        if i < 6:
            h = _pool2(h)
    d = enc[5]
    sides = [nn.conv2d(d, params["side6"], padding=1)]
    for i in range(5, 0, -1):
        d = _up_to(d, enc[i - 1])
        name = f"stage{i}d"
        d = _rsu(params[name], torch.cat([d, enc[i - 1]], dim=1), name in _F_STAGES)
        sides.append(nn.conv2d(d, params[f"side{i}"], padding=1))
    sides = [_up_to(s, x) for s in reversed(sides)]  # d1..d6 at the input's size
    return torch.sigmoid(nn.conv2d(torch.cat(sides, dim=1), params["outconv"]).float())


class U2NetMatter:
    """The loader and the mask and cutout calls; the weights on the card
    unless `device` is given, in `dtype` (DTYPE on the card, f32 on the CPU)."""

    DTYPE = torch.bfloat16  # the mask at 30 dB or more against f32's (PERF.md §4)

    def __init__(self, model_dir: str = "models/u2net", device=None,
                 dtype: Optional[torch.dtype] = None):
        self.model_dir = model_dir
        self.device = device
        self.dtype = dtype
        self.params: Optional[Dict[str, Any]] = None

    @property
    def available(self) -> bool:
        try:
            self.load()
            return self.params is not None
        except Exception:
            return False

    def placement(self):
        from ..core.device import placement

        return placement(self.device, self.dtype, self.DTYPE)

    def load(self):
        if self.params is not None or not os.path.isdir(self.model_dir):
            return
        cands = [f for f in sorted(os.listdir(self.model_dir))
                 if f.endswith((".pth", ".pt", ".safetensors"))]
        if not cands:
            return
        from ..core.convert import nest, tree_to
        from ..core.state_dict import load_state_dict

        sd = load_state_dict(os.path.join(self.model_dir, cands[0]))
        self.params = tree_to(nest(sd), *self.placement())

    def mask(self, img: np.ndarray, size: int = 320) -> np.ndarray:
        """uint8 [H, W, 3] → float32 mask [H, W] in [0, 1] (min-max normalized,
        as rembg)."""
        self.load()
        if self.params is None:
            raise RuntimeError(f"no u2net checkpoint under {self.model_dir}")
        h, w = img.shape[:2]
        feed = cv2_np.resize(img, (size, size), cv2_np.INTER_AREA).astype(np.float32) / 255.0
        feed = (feed - IMAGENET_MEAN) / IMAGENET_STD
        device, dtype = self.placement()
        x = torch.from_numpy(np.ascontiguousarray(feed.transpose(2, 0, 1)[None])).to(device, dtype)
        with inference():
            m = u2net_apply(self.params, x)[0, 0].cpu().numpy()
        lo, hi = m.min(), m.max()
        m = (m - lo) / max(hi - lo, 1e-8)
        return cv2_np.resize(m.astype(np.float32), (w, h), cv2_np.INTER_LINEAR)

    def cutout(self, img: np.ndarray, flat_bg: Optional[tuple] = None,
               size: int = 320) -> np.ndarray:
        """→ the RGBA cutout, or RGB over a flat background colour (the
        birefnet Space's two outputs)."""
        m = self.mask(img, size=size)
        alpha = (m * 255).astype(np.uint8)
        if flat_bg is not None:
            bg = np.asarray(flat_bg, np.float32)[None, None, :]
            out = img.astype(np.float32) * m[..., None] + bg * (1 - m[..., None])
            return out.clip(0, 255).astype(np.uint8)
        return np.concatenate([img, alpha[..., None]], axis=-1)

"""MiDaS depth (depth_midas): DPT-Large (port of forge_tpu/preprocessors/depth.py).

ViT-L/16 at 384² with its tokens tapped after blocks {5, 11, 17, 23}, the
"project" readout (cat(patch, cls) → linear + GELU), the reassemble convs
to strides {4, 8, 16, 32}, the RefineNet fusion and the monodepth head.
The blocks' attention is a softmax between two matmuls, as the reference
has it, outside any kernel (577 tokens, 16 heads of 64). The position
embedding and the decoder's ×2 upsamples are bilinear with half-pixel
centres (ops/resize.py, as jax.image.resize). A hybrid (ResNet-stem)
checkpoint is refused.

Checkpoint: the first .pt/.pth/.safetensors under models/midas
(dpt_large-midas's keys: pretrained.model.*, pretrained.act_postprocess{1..4}.*,
scratch.*).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize
from . import cv2_np
from .annotator import Detector, inference, to_numpy
from .cv import resize_image


def _vit_block(p: Mapping[str, Any], x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, c = x.shape
    h = nn.layer_norm(x, p["norm1"])
    qkv = nn.linear(h, p["attn"]["qkv"]).reshape(b, l, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    a = torch.softmax(((q * (c // heads) ** -0.5) @ k.transpose(-1, -2)).float(), dim=-1)
    h = (a.to(v.dtype) @ v).transpose(1, 2).reshape(b, l, c)
    x = x + nn.linear(h, p["attn"]["proj"])
    h = nn.layer_norm(x, p["norm2"])
    return x + nn.linear(F.gelu(nn.linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])


def _resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[1, 1+N, C] trained grid → the target grid (bilinear), the class token kept."""
    cls, grid = pos[:, :1], pos[:, 1:]
    side = int(np.sqrt(grid.shape[1]))
    g = grid.reshape(1, side, side, -1).permute(0, 3, 1, 2)
    g = resize(g.float(), (gh, gw), "bilinear").to(pos.dtype)
    return torch.cat([cls, g.flatten(2).transpose(1, 2)], dim=1)


def _readout_project(p: Mapping[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    patches = tokens[:, 1:]
    cat = torch.cat([patches, tokens[:, :1].expand_as(patches)], dim=-1)
    return F.gelu(nn.linear(cat, p["project"]["0"]))


def _rcu(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = nn.conv2d(F.relu(x), p["conv1"], padding=1)
    return x + nn.conv2d(F.relu(h), p["conv2"], padding=1)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize(x, (x.shape[2] * 2, x.shape[3] * 2), "bilinear")


def _fusion(p: Mapping[str, Any], x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
    if skip is not None:
        x = x + _rcu(p["resConfUnit1"], skip)
    return nn.conv2d(_up2(_rcu(p["resConfUnit2"], x)), p["out_conv"])


def dpt_apply(params: Mapping[str, Any], img: torch.Tensor, heads: int = 16) -> torch.Tensor:
    """img [B,3,H,W] (normalized) → inverse depth [B,H,W]."""
    vit = params["pretrained"]["model"]
    x = nn.conv2d(img, vit["patch_embed"]["proj"], stride=16)
    b, c, gh, gw = x.shape
    tokens = torch.cat([vit["cls_token"].reshape(1, 1, c).expand(b, 1, c).to(x.dtype),
                        x.flatten(2).transpose(1, 2)], dim=1)
    tokens = tokens + _resize_pos_embed(vit["pos_embed"].reshape(1, -1, c), gh, gw).to(x.dtype)
    taps = {}
    hook_at = {5: 1, 11: 2, 17: 3, 23: 4}
    for i in range(len(vit["blocks"])):
        tokens = _vit_block(vit["blocks"][str(i)], tokens, heads)
        if i in hook_at:
            taps[hook_at[i]] = tokens
    for n in (1, 2, 3, 4):  # shallow test models: the final block's tokens
        taps.setdefault(n, tokens)
    feats = {}
    for n in (1, 2, 3, 4):
        pp = params["pretrained"][f"act_postprocess{n}"]
        t = _readout_project(pp["0"], taps[n]).transpose(1, 2).reshape(b, -1, gh, gw)
        t = nn.conv2d(t, pp["3"])
        if n == 1:
            t = nn.conv2d_transpose(t, pp["4"], stride=4)
        elif n == 2:
            t = nn.conv2d_transpose(t, pp["4"], stride=2)
        elif n == 4:
            t = nn.conv2d(t, pp["4"], stride=2, padding=1)
        feats[n] = nn.conv2d(t, params["scratch"][f"layer{n}_rn"], padding=1)
    s = params["scratch"]
    path = _fusion(s["refinenet4"], feats[4], None)
    path = _fusion(s["refinenet3"], path, feats[3])
    path = _fusion(s["refinenet2"], path, feats[2])
    path = _fusion(s["refinenet1"], path, feats[1])
    head = s["output_conv"]
    x = _up2(nn.conv2d(path, head["0"], padding=1))
    x = F.relu(nn.conv2d(x, head["2"], padding=1))
    return F.relu(nn.conv2d(x, head["4"]))[:, 0]


def _refuse_hybrid(sd):
    if any("pretrained.model.patch_embed.backbone" in k for k in sd):
        raise RuntimeError("dpt_hybrid (ResNet-stem) checkpoints are not supported; "
                           "use dpt_large-midas")
    return sd


class MidasDetector(Detector):
    DTYPE = torch.bfloat16  # 45.12 dB against f32 on an H100 (PERF.md §4)
    MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
    STD = np.asarray([0.5, 0.5, 0.5], np.float32)

    def __init__(self, model_dir: str = "models/midas", **kw):
        super().__init__(model_dir, suffixes=(".pt", ".pth", ".safetensors"),
                         convert=_refuse_hybrid, missing="no MiDaS checkpoint", **kw)

    def predict(self, img: np.ndarray, res: int = 384) -> torch.Tensor:
        small = cv2_np.resize(img, (res, res), cv2_np.INTER_AREA)
        x = (small.astype(np.float32) / 255.0 - self.MEAN) / self.STD
        params = self.load()
        with inference():
            return dpt_apply(params, self.image_tensor(x))[0].float()

    def detect(self, img: np.ndarray, res: int = 384) -> np.ndarray:
        """uint8 [H,W,3] → normalized inverse depth uint8 [H,W,3] (the net at
        384², min–max normalized)."""
        h, w = img.shape[:2]
        depth = cv2_np.resize(to_numpy(self.predict(img, res)), (w, h), cv2_np.INTER_CUBIC)
        lo, hi = depth.min(), depth.max()
        depth = (depth - lo) / max(hi - lo, 1e-6)
        return np.repeat((depth * 255).astype(np.uint8)[..., None], 3, axis=2)


_DETECTOR: Optional[MidasDetector] = None


def get_midas(device=None) -> MidasDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = MidasDetector(device=device)
    return _DETECTOR


def depth_midas(img, res, a, b):
    return np.asarray(get_midas().detect(resize_image(img, res)), np.float32) / 255.0

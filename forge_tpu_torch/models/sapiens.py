"""Sapiens ViT dense predictor, the normal-estimation net behind the
sapiens_normal Space (port of forge_tpu/models/sapiens.py).

The reference's stand-in for Meta's Sapiens torchscript exports, which run
as opaque modules: the published architecture (a plain ViT encoder, no
class token, and the VitHead's 4×4 stride-2 transpose convs with a last
conv to the outputs) as a function of an ordinary state dict, its depth,
width, patch and head read from the checkpoint. Keys:

    patch_embed.proj.{weight, bias}        the patch conv, OIHW
    pos_embed                              [1, L, D] or [L, D] (a leading class
                                           position is dropped)
    blocks.{i}.norm1|norm2, attn.qkv, attn.proj, mlp.fc1|fc2
    norm
    head.deconv.{j}.{weight, bias}         ConvTranspose2d, stride 2
    head.conv.{weight, bias}               the last conv (1×1 or 3×3)

Each block attends through ops/attention.py with 64-wide heads: at the
Space's 1024×768 feed (3072 tokens of 16² patches) every block is one
flash-attention launch on the card, so Sapiens-1B makes 40 a forward.
The rest is plain torch. Resizes are OpenCV's (cv2_np.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.attention import attention
from ..preprocessors import cv2_np
from ..preprocessors.annotator import inference

# the reference app's inference size and statistics (forge_space_sapiens_normal forge_app.py:58-62)
INPUT_H, INPUT_W = 1024, 768
MEAN = np.asarray([123.5, 116.5, 103.5], np.float32) / 255.0
STD = np.asarray([58.5, 57.0, 57.5], np.float32) / 255.0


def sapiens_apply(params: Mapping[str, Any], pixels: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] normalized pixels → [B, C_out, H', W'] (the patch grid
    upsampled ×2 a transpose conv)."""
    proj = params["patch_embed"]["proj"]
    x = nn.conv2d(pixels, proj, stride=proj["weight"].shape[-1])
    b, width, gh, gw = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = params["pos_embed"]
    pos = pos.reshape(-1, pos.shape[-1])
    if pos.shape[0] == x.shape[1] + 1:  # a checkpoint with a class position
        pos = pos[1:]
    x = x + pos[: x.shape[1]].to(x.dtype)
    blocks = params["blocks"]
    heads = max(1, width // 64)
    for i in range(len(blocks)):
        bp = blocks[str(i)]
        q, k, v = nn.linear(nn.layer_norm(x, bp["norm1"]), bp["attn"]["qkv"]).chunk(3, dim=-1)
        x = x + nn.linear(attention(q, k, v, heads=heads), bp["attn"]["proj"])
        h = nn.layer_norm(x, bp["norm2"])
        x = x + nn.linear(nn.gelu(nn.linear(h, bp["mlp"]["fc1"])), bp["mlp"]["fc2"])
    y = nn.layer_norm(x, params["norm"]).transpose(1, 2).reshape(b, width, gh, gw)
    head = params["head"]
    deconvs = head.get("deconv", {})
    for j in range(len(deconvs)):
        dp = deconvs[str(j)]
        y = F.relu(nn.conv2d_transpose(y, dp, stride=2, padding=(dp["weight"].shape[-1] - 2) // 2))
    kh = head["conv"]["weight"].shape[-1]
    return nn.conv2d(y, head["conv"], padding=kh // 2)


class SapiensNormal:
    """The runner: the feed, the forward and the visualization of the
    reference app's process_image (forge_app.py:66-95) with its person mask
    from the U²-Net matter under `mask_model_dir`, where one is there. The
    weights live on the card unless `device` is given, in `dtype` (DTYPE on
    the card, f32 on the CPU); the matter runs on the same device."""

    DTYPE = torch.bfloat16  # the normals at 30 dB or more against f32's (PERF.md §4)

    def __init__(self, model_dir: str = "models/sapiens",
                 mask_model_dir: Optional[str] = "models/u2net", device=None,
                 dtype: Optional[torch.dtype] = None):
        self.model_dir = model_dir
        self.mask_model_dir = mask_model_dir
        self.device = device
        self.dtype = dtype
        self.params: Optional[Dict[str, Any]] = None
        self._matter = None

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

    def normals(self, img: np.ndarray, mask_background: bool = True) -> np.ndarray:
        """uint8 [H, W, 3] → the uint8 [H, W, 3] normal map: (n̂ + 1) / 2 · 255,
        the background at −1 where the matter finds it."""
        self.load()
        if self.params is None:
            raise RuntimeError(f"no sapiens checkpoint under {self.model_dir}")
        h, w = img.shape[:2]
        feed = cv2_np.resize(img, (INPUT_W, INPUT_H), cv2_np.INTER_AREA)
        feed = (feed.astype(np.float32) / 255.0 - MEAN) / STD
        device, dtype = self.placement()
        x = torch.from_numpy(np.ascontiguousarray(feed.transpose(2, 0, 1)[None])).to(device, dtype)
        with inference():
            out = sapiens_apply(self.params, x)[0].float().permute(1, 2, 0).cpu().numpy()
        normal = cv2_np.resize(out, (w, h), cv2_np.INTER_LINEAR)
        if mask_background and self.mask_model_dir:
            if self._matter is None:
                from .u2net import U2NetMatter

                self._matter = U2NetMatter(model_dir=self.mask_model_dir, device=self.device)
            if self._matter.available:
                normal[~(self._matter.mask(img) > 0.5)] = -1.0
        norm = np.linalg.norm(normal, axis=-1, keepdims=True)
        unit = normal / (norm + 1e-5)
        return ((unit + 1.0) / 2.0 * 255.0).clip(0, 255).astype(np.uint8)

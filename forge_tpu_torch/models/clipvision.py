"""CLIP ViT image encoder for the IP-Adapter (port of forge_tpu/models/clipvision.py).

HF CLIPVisionModelWithProjection's key layout (`vision_model.embeddings.*`,
`pre_layrnorm`, `encoder.layers.N.*`, `post_layernorm`, `visual_projection`):
a stride-`patch` conv patch embedding, the class token and positions, then
pre-LN transformer layers. Returns the projected image embed, the pooled
class token and the penultimate hidden states (IP-Adapter-plus reads the
latter). Pixels are NCHW.

The heads and the MLP's activation come from `ClipVisionConfig.for_width`:
OpenAI ViT-L/14 (width 1024) has 16 heads of 64 and quick_gelu; laion
ViT-H/14 (1280, the SDXL IP-Adapter's encoder) and ViT-bigG/14 (1664) have
16 heads (of 80 and 104) and gelu. The reference takes width // 64 heads and
quick_gelu at every width, which is right at ViT-L only; the port keeps that
rule for other widths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops import nn
from ..ops.attention import attention
from ..pipeline.images import bicubic_resize

# OpenAI CLIP normalization (public constants)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    num_heads: int
    act: str  # "quick_gelu" | "gelu"

    @staticmethod
    def for_width(width: int) -> "ClipVisionConfig":
        if width == 1024:  # OpenAI CLIP-ViT-L/14
            return ClipVisionConfig(16, "quick_gelu")
        if width in (1280, 1664):  # laion CLIP-ViT-H/14, CLIP-ViT-bigG/14
            return ClipVisionConfig(16, "gelu")
        return ClipVisionConfig(max(width // 64, 1), "quick_gelu")


def preprocess(image: np.ndarray, size: int = 224) -> torch.Tensor:
    """uint8/float [H,W,3] → normalized [1,3,size,size] f32 (Pillow's BICUBIC resize)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    x = bicubic_resize(arr, size, size).astype(np.float32) / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))


def clip_vision_apply(params: Mapping[str, Any], pixels: torch.Tensor,
                      cfg: Optional[ClipVisionConfig] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pixels [B,3,H,W] normalized → (projected [B,P], pooled [B,D],
    penultimate hidden states [B,L,D])."""
    vm = params["vision_model"]
    emb = vm["embeddings"]
    pw = emb["patch_embedding"]["weight"]  # [D, 3, patch, patch]
    patch = pw.shape[-1]
    x = nn.conv2d(pixels.to(pw.dtype), {"weight": pw}, stride=patch)
    b, width = x.shape[:2]
    cfg = cfg or ClipVisionConfig.for_width(width)
    x = x.reshape(b, width, -1).transpose(1, 2)
    cls = emb["class_embedding"].reshape(1, 1, width).expand(b, 1, width)
    x = torch.cat([cls.to(x.dtype), x], dim=1)
    x = x + emb["position_embedding"]["weight"][: x.shape[1]].to(x.dtype)
    if "pre_layrnorm" in vm:  # HF's historical typo is part of the key space
        x = nn.layer_norm(x, vm["pre_layrnorm"])

    layers = vm["encoder"]["layers"]
    penultimate = None
    for i in range(len(layers)):
        lp = layers[str(i)]
        if i == len(layers) - 1:
            penultimate = x
        h = nn.layer_norm(x, lp["layer_norm1"])
        sa = lp["self_attn"]
        q, k, v = (nn.linear(h, sa[name]) for name in ("q_proj", "k_proj", "v_proj"))
        x = x + nn.linear(attention(q, k, v, heads=cfg.num_heads), sa["out_proj"])
        h = nn.linear(nn.layer_norm(x, lp["layer_norm2"]), lp["mlp"]["fc1"])
        h = nn.quick_gelu(h) if cfg.act == "quick_gelu" else nn.gelu(h)
        x = x + nn.linear(h, lp["mlp"]["fc2"])

    pooled = nn.layer_norm(x[:, 0:1], vm["post_layernorm"])[:, 0]
    projected = pooled
    if "visual_projection" in params:
        projected = nn.linear(pooled, {"weight": params["visual_projection"]["weight"]})
    return projected, pooled, penultimate

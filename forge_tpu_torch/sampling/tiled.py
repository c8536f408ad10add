"""MultiDiffusion tiled denoising (port of forge_tpu/sampling/tiled.py).

The latent is split into overlapping tiles, the σ-space denoiser runs on
each tile, and the tiles' outputs are blended back with Gaussian weights in
f32 accumulators. The wrapper sits inside the CFG model function, so each
tile's forward sees the whole CFG batch. Activations are NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch


def split_bboxes(size: int, tile: int, overlap: int) -> List[int]:
    """1-D tile start offsets covering [0, size)."""
    if size <= tile:
        return [0]
    stride = tile - overlap
    n = math.ceil((size - overlap) / stride)
    starts = [min(i * stride, size - tile) for i in range(n)]
    return sorted(set(starts))


def _gaussian_weights(tile_h: int, tile_w: int) -> np.ndarray:
    """Per-pixel Gaussian blend weights [tile_h, tile_w] (Mixture-of-Diffusers)."""
    def axis(n):
        mid = (n - 1) / 2
        var = (n / 3.0) ** 2 / 4
        return np.exp(-((np.arange(n) - mid) ** 2) / (2 * var))

    return np.outer(axis(tile_h), axis(tile_w)).astype(np.float32)


def make_tiled_apply(apply_model: Callable, latent_h: int, latent_w: int, tile: int = 96,
                     overlap: int = 32) -> Callable:
    """Wrap apply_model(x, σ, cond) → denoised with MultiDiffusion tiling of
    an [B, C, latent_h, latent_w] latent."""
    th, tw = min(tile, latent_h), min(tile, latent_w)
    boxes = [(y0, x0) for y0 in split_bboxes(latent_h, th, overlap)
             for x0 in split_bboxes(latent_w, tw, overlap)]
    weights = _gaussian_weights(th, tw)
    total = np.zeros((latent_h, latent_w), np.float32)  # the weights' sum, tile by tile
    for y0, x0 in boxes:
        total[y0:y0 + th, x0:x0 + tw] += weights
    norm = np.maximum(total, np.float32(1e-8))

    def tiled(x: torch.Tensor, sigma, cond) -> torch.Tensor:
        w = torch.from_numpy(weights).to(x.device)
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for y0, x0 in boxes:
            out = apply_model(x[:, :, y0:y0 + th, x0:x0 + tw], sigma, cond).float() * w
            acc[:, :, y0:y0 + th, x0:x0 + tw] += out
        return (acc / torch.from_numpy(norm).to(x.device)).to(x.dtype)

    return tiled

"""Bilinear resize with the reference's weights (`jax.image.resize`, "bilinear").

`jax.image.resize` builds, for each resized axis, a weight matrix from the
triangle kernel at half-pixel centres: widened by 1/scale when it shrinks and
`antialias` is on (its default), renormalised where the kernel leaves the
image, and zero for outputs whose centre falls outside it. `resize_weights`
builds the same matrix in numpy (float32, as the reference computes it);
`resize_bilinear` applies one matrix per axis to the last two axes of an
array or tensor. The latent inpaint mask, the "latent" resize mode and the
ControlNet hint go through it.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def resize_weights(n_in: int, n_out: int, antialias: bool = True) -> np.ndarray:
    """[n_in, n_out] float32: output j = Σ_i in[i]·W[i, j]."""
    scale = np.float32(n_out / n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(dist))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


Array = Union[np.ndarray, torch.Tensor]


def resize_bilinear(x: Array, size: Tuple[int, int], antialias: bool = True) -> Array:
    """Resize the last two axes of `x` (numpy or torch, [..., H, W]) to `size`."""
    if isinstance(x, np.ndarray):
        return resize_bilinear(torch.from_numpy(x.astype(np.float32)), size, antialias).numpy()
    (h, w), (oh, ow) = x.shape[-2:], size
    if oh != h:
        wy = torch.from_numpy(resize_weights(h, oh, antialias)).to(x.device, x.dtype)
        x = torch.einsum("...hw,ho->...ow", x, wy)
    if ow != w:
        wx = torch.from_numpy(resize_weights(w, ow, antialias)).to(x.device, x.dtype)
        x = torch.einsum("...hw,wo->...ho", x, wx)
    return x

"""Resizes with the reference's weights (`jax.image.resize`: "bilinear", "bicubic", "nearest").

`jax.image.resize` builds, for each resized axis, a weight matrix from its
kernel at half-pixel centres: the triangle for bilinear, Keys' cubic with
a = −0.5 for bicubic. When the axis shrinks and `antialias` is on (its
default) the kernel is widened by 1/scale; columns are renormalised where
the kernel leaves the image, and zero for outputs whose centre falls
outside it. "nearest" ignores `antialias` and takes input index
floor((j + 0.5)·n_in/n_out), computed in float32. `resize_weights` builds
the same matrices in numpy (float32, as the reference computes them);
`resize` applies one per axis to the last two axes of an array or tensor.
The latent inpaint mask, the "latent" resize mode, the ControlNet hint and
the hires fix's latent modes go through it.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

METHODS = ("bilinear", "bicubic", "nearest")


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """[n_out] int64: the input index each output of "nearest" takes."""
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) \
        / np.float32(n_out)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize_weights(n_in: int, n_out: int, antialias: bool = True,
                   method: str = "bilinear") -> np.ndarray:
    """[n_in, n_out] float32: output j = Σ_i in[i]·W[i, j]."""
    if method == "nearest":
        w = np.zeros((n_in, n_out), np.float32)
        w[nearest_indices(n_in, n_out), np.arange(n_out)] = 1.0
        return w
    kernel = _KERNELS[method]
    scale = np.float32(n_out / n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(dist.astype(np.float32))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


Array = Union[np.ndarray, torch.Tensor]


def resize(x: Array, size: Tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> Array:
    """Resize the last two axes of `x` (numpy or torch, [..., H, W]) to `size`
    as `jax.image.resize(x, ..., method, antialias)` does."""
    if method not in METHODS:
        raise ValueError(f"resize: method must be one of {METHODS}, not {method!r}")
    if isinstance(x, np.ndarray):
        return resize(torch.from_numpy(x.astype(np.float32)), size, method, antialias).numpy()
    (h, w), (oh, ow) = x.shape[-2:], size
    if method == "nearest":
        if oh != h:
            x = x[..., torch.from_numpy(nearest_indices(h, oh)).to(x.device), :]
        if ow != w:
            x = x[..., torch.from_numpy(nearest_indices(w, ow)).to(x.device)]
        return x
    if oh != h:
        wy = torch.from_numpy(resize_weights(h, oh, antialias, method)).to(x.device, x.dtype)
        x = torch.einsum("...hw,ho->...ow", x, wy)
    if ow != w:
        wx = torch.from_numpy(resize_weights(w, ow, antialias, method)).to(x.device, x.dtype)
        x = torch.einsum("...hw,wo->...ho", x, wx)
    return x

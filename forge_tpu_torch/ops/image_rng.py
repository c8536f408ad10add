# Copied from forge_tpu/ops/image_rng.py; numpy/stdlib only, so the port imports no JAX.
"""Per-image noise streams with reference-compatible seed semantics.

Reproduces the reference's NV/Philox noise source (modules/rng.py:113-177
ImageRNG): per-image Philox generators, subseed slerp variation, seed-resize
center crop/pad, eta-noise-seed-delta (ENSD) regeneration, and a `next()`
stream used by ancestral/SDE samplers for per-step noise. All host-side numpy;
shapes are (C, H, W) per image, stacked to (B, C, H, W) — NCHW, because that
is the layout the seeds encode (element order of the Philox counter walk).
The JAX pipeline transposes to NHWC after generation; the port keeps NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .rng_philox import Generator


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical interpolation with the webui's exact conventions: norms and
    the angle are taken along axis 1 (H for a CHW latent), with a linear
    fallback when the vectors are nearly parallel."""
    low64 = low.astype(np.float64)
    high64 = high.astype(np.float64)
    low_norm = low64 / np.linalg.norm(low64, axis=1, keepdims=True)
    high_norm = high64 / np.linalg.norm(high64, axis=1, keepdims=True)
    dot = (low_norm * high_norm).sum(axis=1)

    if dot.mean() > 0.9995:
        return (low64 * val + high64 * (1 - val)).astype(np.float32)

    omega = np.arccos(dot)
    so = np.sin(omega)
    res = (np.sin((1.0 - val) * omega) / so)[:, None] * low64 + (
        np.sin(val * omega) / so
    )[:, None] * high64
    return res.astype(np.float32)


class ImageRNG:
    """Noise source for one batch of images.

    first()/next() mirror the reference: `first` builds the initial latents
    (with subseed/seed-resize handling), `next` yields per-step sampler noise
    from the (possibly ENSD-shifted) per-image generators.
    """

    def __init__(
        self,
        shape: Sequence[int],
        seeds: Sequence[int],
        subseeds: Optional[Sequence[int]] = None,
        subseed_strength: float = 0.0,
        seed_resize_from_h: int = 0,
        seed_resize_from_w: int = 0,
        eta_noise_seed_delta: int = 0,
    ):
        self.shape = tuple(int(x) for x in shape)  # (C, H, W)
        self.seeds = [int(s) for s in seeds]
        self.subseeds = list(subseeds) if subseeds is not None else None
        self.subseed_strength = float(subseed_strength)
        self.seed_resize_from_h = int(seed_resize_from_h)
        self.seed_resize_from_w = int(seed_resize_from_w)
        self.eta_noise_seed_delta = int(eta_noise_seed_delta)

        self.generators = [Generator(seed) for seed in self.seeds]
        self.is_first = True

    def _resize_shape(self):
        if self.seed_resize_from_h <= 0 or self.seed_resize_from_w <= 0:
            return self.shape
        return (self.shape[0], self.seed_resize_from_h // 8, self.seed_resize_from_w // 8)

    def first(self) -> np.ndarray:
        noise_shape = self._resize_shape()
        xs = []
        for i, (seed, generator) in enumerate(zip(self.seeds, self.generators)):
            subnoise = None
            if self.subseeds is not None and self.subseed_strength != 0:
                subseed = 0 if i >= len(self.subseeds) else int(self.subseeds[i])
                subnoise = Generator(subseed).randn(noise_shape)

            if noise_shape != self.shape:
                noise = Generator(seed).randn(noise_shape)
            else:
                noise = generator.randn(self.shape)

            if subnoise is not None:
                noise = slerp(self.subseed_strength, noise, subnoise)

            if noise_shape != self.shape:
                # Center-place the resized noise into a fresh full-size field,
                # reproducing the reference's crop/pad arithmetic.
                x = generator.randn(self.shape)
                dx = (self.shape[2] - noise_shape[2]) // 2
                dy = (self.shape[1] - noise_shape[1]) // 2
                w = noise_shape[2] if dx >= 0 else noise_shape[2] + 2 * dx
                h = noise_shape[1] if dy >= 0 else noise_shape[1] + 2 * dy
                tx = 0 if dx < 0 else dx
                ty = 0 if dy < 0 else dy
                dx = max(-dx, 0)
                dy = max(-dy, 0)
                x[:, ty : ty + h, tx : tx + w] = noise[:, dy : dy + h, dx : dx + w]
                noise = x

            xs.append(noise)

        if self.eta_noise_seed_delta:
            self.generators = [Generator(seed + self.eta_noise_seed_delta) for seed in self.seeds]

        return np.stack(xs)

    def next(self) -> np.ndarray:
        if self.is_first:
            self.is_first = False
            return self.first()
        return np.stack([g.randn(self.shape) for g in self.generators])

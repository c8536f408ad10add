# Copied from forge_tpu/sampling/brownian.py; numpy only, so the port imports no JAX.
"""Deterministic Brownian-tree noise for the SDE samplers.

The reference routes SDE sampler noise through torchsde's BrownianTree
seeded per image (modules/sd_samplers_common.py:343-350), which gives two
properties plain sequential draws lack:

  1. determinism per (seed, σ-interval) — the noise used between σ_a and σ_b
     does not depend on how many steps the schedule was cut into, so a 20-step
     and a 40-step run share the same underlying Brownian path;
  2. correct Brownian-bridge correlation between nested intervals.

This is a from-scratch numpy implementation of the same construction
(binary dyadic bridge subdivision, per-node counter-based Philox draws);
torchsde's exact bit layout is NOT reproduced — seeds are reproducible
within this framework, not against CUDA reference images for SDE samplers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_DEPTH = 24  # dyadic resolution: intervals resolved to (t1-t0)·2⁻²⁴


class BrownianTree:
    """W(u) on u∈[0,1] with W(0)=0, built by deterministic bridge subdivision.

    Every dyadic node (level, index) draws its midpoint displacement from
    Philox keyed by (seed, level, index), so any evaluation order yields the
    same path. Physical σ-values are affinely mapped onto [0,1] by the caller.
    """

    def __init__(self, shape: Tuple[int, ...], seed: int):
        self.shape = tuple(shape)
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._cache: Dict[float, np.ndarray] = {}

    def _node_randn(self, level: int, index: int) -> np.ndarray:
        bits = np.random.Philox(key=self.seed, counter=[0, 0, level, index])
        return np.random.Generator(bits).standard_normal(self.shape, dtype=np.float32)

    def _w(self, u: float) -> np.ndarray:
        """W(u) − W(0) at dyadic resolution 2^-_DEPTH (unit variance/unit u)."""
        u = min(max(float(u), 0.0), 1.0)
        # snap to the dyadic grid: the path is defined on grid points
        q = round(u * (1 << _DEPTH))
        key = q / (1 << _DEPTH)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if q == 0:
            w = np.zeros(self.shape, np.float32)
            self._cache[key] = w
            return w
        # endpoint draw: W(1) ~ N(0, 1)
        u_l, u_r = 0.0, 1.0
        w_l = np.zeros(self.shape, np.float32)
        w_r = self._node_randn(0, 0)
        if key == 1.0:
            self._cache[key] = w_r
            return w_r
        idx = 0
        for level in range(1, _DEPTH + 1):
            u_m = 0.5 * (u_l + u_r)
            idx = idx * 2
            w_m = 0.5 * (w_l + w_r) + np.sqrt((u_r - u_l) / 4.0) * self._node_randn(level, idx)
            if key <= u_m:
                u_r, w_r = u_m, w_m
            else:
                u_l, w_l = u_m, w_m
                idx += 1
            if key in (u_l, u_r):
                break
        w = w_r if key == u_r else w_l
        self._cache[key] = w
        return w

    def increment(self, u_a: float, u_b: float) -> np.ndarray:
        """Unit-variance noise over [u_a, u_b]: (W(u_b)−W(u_a))/√|u_b−u_a|."""
        du = abs(float(u_b) - float(u_a))
        if du <= 0:
            return np.zeros(self.shape, np.float32)
        return (self._w(u_b) - self._w(u_a)) / np.sqrt(du)


def brownian_step_noise(
    sigmas: np.ndarray,
    shape: Tuple[int, ...],
    seeds,
    draws: int = 1,
) -> np.ndarray:
    """Precompute per-step SDE noise [n_steps, draws, B, *shape].

    One tree per (image, draw); σ-schedule points are mapped onto [0,1] by
    the run's (σ_min, σ_max) so the path is shared across step counts —
    mirroring k_diffusion.BrownianTreeNoiseSampler(x, σ_min, σ_max, seed).
    """
    sigmas = np.asarray(sigmas, np.float64)
    n_steps = len(sigmas) - 1
    pos = sigmas[sigmas > 0]
    s_min, s_max = float(pos.min()), float(pos.max())
    span = max(s_max - s_min, 1e-12)

    def u_of(s):
        return (min(max(float(s), s_min), s_max) - s_min) / span

    out = np.zeros((n_steps, draws, len(seeds)) + tuple(shape), np.float32)
    for b, seed in enumerate(seeds):
        for d in range(draws):
            tree = BrownianTree(shape, int(seed) + d * 0x9E3779B9)
            for i in range(n_steps):
                sa, sb = sigmas[i], sigmas[i + 1]
                if sb <= 0:  # final denoise step draws no noise
                    continue
                out[i, d, b] = tree.increment(u_of(sa), u_of(sb))
    return out

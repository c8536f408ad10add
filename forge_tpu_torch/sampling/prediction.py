"""σ-space prediction wrapper for eps/v models (port of forge_tpu/sampling/prediction.py).

How a diffusion net's raw output becomes an x0 ("denoised") estimate:

    input' = calculate_input(σ, x)         (c_in scaling)
    t      = timestep(σ)                   (the net's native conditioning)
    out    = net(input', t, ...)
    x0     = calculate_denoised(σ, out, x)

σ is a host scalar in the port's sampling loop, so the σ-table lookups run
in numpy; the x-side formulas work on tensors or arrays alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_beta_schedule(n: int = 1000, linear_start: float = 0.00085,
                       linear_end: float = 0.012) -> np.ndarray:
    """LDM 'scaled linear' (sqrt-space linear) beta schedule."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n, dtype=np.float64) ** 2


class DiscretePrediction:
    """eps- or v-prediction over a discrete 1000-step beta schedule (SD1.5)."""

    sigma_data = 1.0

    def __init__(self, betas: Optional[np.ndarray] = None, prediction_type: str = "eps"):
        betas = make_beta_schedule() if betas is None else betas
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        self.sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod).astype(np.float32)
        self.log_sigmas = np.log(self.sigmas)
        self.prediction_type = prediction_type
        self.sigma_min = float(self.sigmas[0])
        self.sigma_max = float(self.sigmas[-1])

    def timestep(self, sigma):
        """σ → fractional t by piecewise-linear interpolation in log σ."""
        table = self.log_sigmas
        log_sigma = np.log(np.asarray(sigma))
        dists = log_sigma[..., None] - table
        low_idx = np.clip((dists >= 0).sum(axis=-1) - 1, 0, table.shape[0] - 2)
        high_idx = low_idx + 1
        low = table[low_idx]
        high = table[high_idx]
        w = np.clip((low - log_sigma) / (low - high), 0, 1)
        return (1 - w) * low_idx + w * high_idx

    def sigma(self, timestep):
        table = self.log_sigmas
        t = np.clip(np.asarray(timestep, dtype=np.float32), 0, len(self.sigmas) - 1)
        low_idx = np.floor(t).astype(np.int32)
        high_idx = np.ceil(t).astype(np.int32)
        w = t - low_idx
        return np.exp((1 - w) * table[low_idx] + w * table[high_idx])

    def calculate_input(self, sigma, noisy):
        return noisy / (sigma**2 + self.sigma_data**2) ** 0.5

    def noise_scaling(self, sigma, noise, latent):
        return noise * sigma + latent

    def calculate_denoised(self, sigma, model_output, noisy):
        if self.prediction_type == "v":
            sd = self.sigma_data
            return noisy * sd**2 / (sigma**2 + sd**2) - (
                model_output * sigma * sd / (sigma**2 + sd**2) ** 0.5)
        return noisy - model_output * sigma

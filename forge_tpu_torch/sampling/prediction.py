"""σ-space prediction wrappers (port of forge_tpu/sampling/prediction.py):
discrete eps/v (SD1.5, SD2, SDXL), EDM (Playground v2.5), rectified flow
(SD3) and Flux's resolution-shifted flow.

How a diffusion net's raw output becomes an x0 ("denoised") estimate:

    input' = calculate_input(σ, x)         (c_in scaling)
    t      = timestep(σ)                   (the net's native conditioning)
    out    = net(input', t, ...)
    x0     = calculate_denoised(σ, out, x)

σ is a host scalar in the port's sampling loop, so the σ-table lookups run
in numpy; the x-side formulas work on tensors or arrays alike. The engine
tags each predictor with its model family (`family`), which the
Align-Your-Steps schedules read to pick their anchor table.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def make_beta_schedule(n: int = 1000, linear_start: float = 0.00085,
                       linear_end: float = 0.012) -> np.ndarray:
    """LDM 'scaled linear' (sqrt-space linear) beta schedule."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n, dtype=np.float64) ** 2


class AbstractPrediction:
    """The σ_data-aware input scaling and the variance-exploding noising
    every predictor shares unless it overrides them."""

    sigma_data = 1.0
    family = None

    def __init__(self, sigma_min: float, sigma_max: float):
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def calculate_input(self, sigma, noisy):
        return noisy / (sigma**2 + self.sigma_data**2) ** 0.5

    def noise_scaling(self, sigma, noise, latent):
        return noise * sigma + latent


class DiscretePrediction(AbstractPrediction):
    """eps- or v-prediction over a discrete 1000-step beta schedule (SD1.5, SD2, SDXL)."""

    def __init__(self, betas: Optional[np.ndarray] = None, prediction_type: str = "eps"):
        betas = make_beta_schedule() if betas is None else betas
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        self.sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod).astype(np.float32)
        self.log_sigmas = np.log(self.sigmas)
        self.prediction_type = prediction_type
        super().__init__(float(self.sigmas[0]), float(self.sigmas[-1]))

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

    def calculate_denoised(self, sigma, model_output, noisy):
        if self.prediction_type == "v":
            sd = self.sigma_data
            return noisy * sd**2 / (sigma**2 + sd**2) - (
                model_output * sigma * sd / (sigma**2 + sd**2) ** 0.5)
        return noisy - model_output * sigma


class PredictionEDM(AbstractPrediction):
    """EDM (Karras) parametrisation, Playground v2.5's: σ_data 0.5 and the σ
    range 0.002–120; the model's timestep is 0.25·log σ."""

    def __init__(self, sigma_data: float = 0.5, sigma_min: float = 0.002,
                 sigma_max: float = 120.0):
        super().__init__(sigma_min, sigma_max)
        self.sigma_data = sigma_data

    def timestep(self, sigma):
        return 0.25 * np.log(np.asarray(sigma))

    def sigma(self, timestep):
        return np.exp(np.asarray(timestep) / 0.25)

    def calculate_denoised(self, sigma, model_output, noisy):
        sd = self.sigma_data
        c_skip = sd**2 / (sigma**2 + sd**2)
        c_out = sigma * sd / (sigma**2 + sd**2) ** 0.5
        return noisy * c_skip + model_output * c_out


class PredictionFlow(AbstractPrediction):
    """Rectified flow (SD3): σ ∈ (0, 1], the model predicts velocity. The
    time shift is baked into the σ table; the model's timestep is σ·1000."""

    def __init__(self, shift: float = 3.0, timesteps: int = 1000):
        self.shift = shift
        t = np.arange(1, timesteps + 1, dtype=np.float64) / timesteps
        self.sigmas = self._shift_sigma(t).astype(np.float32)  # ascending
        super().__init__(float(self.sigmas[0]), float(self.sigmas[-1]))

    def _shift_sigma(self, x):
        return self.shift * x / (1 + (self.shift - 1) * x)

    def calculate_input(self, sigma, noisy):
        return noisy

    def timestep(self, sigma):
        return sigma * 1000.0

    def sigma(self, timestep):
        return self._shift_sigma(timestep / 1000.0)

    def calculate_denoised(self, sigma, model_output, noisy):
        return noisy - model_output * sigma

    def noise_scaling(self, sigma, noise, latent):
        return sigma * noise + (1.0 - sigma) * latent


class PredictionFlux(PredictionFlow):
    """Flux flow: shift factor exp(μ), μ linear in the image token count
    (4096 at 1024², the reference's fixed value; 256 floor)."""

    def __init__(self, seq_len: int = 4096, base_shift: float = 0.5, max_shift: float = 1.15):
        m = (max_shift - base_shift) / (4096 - 256)
        b = base_shift - m * 256
        self.mu = seq_len * m + b
        super().__init__(shift=math.exp(self.mu))

    def _shift_sigma(self, x):
        emu = math.exp(self.mu)
        return emu / (emu + (1.0 / np.maximum(x, 1e-9) - 1.0))

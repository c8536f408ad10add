"""Euler-family and DPM++ 2M samplers as Python step loops (port of forge_tpu/sampling/samplers.py).

`model_fn(x, σ) -> denoised` is the CFG-combined x0 prediction (sampling/cfg.py).
σ values are host float32 scalars; per-step gaussian noise is precomputed on
the host from the Philox stream (`noise[n_steps, draws, B, C, h, w]`), so a
seed gives the same image as the reference. Conventions:

    d = to_d(x, σ, denoised) = (x - denoised) / σ
    ancestral split: σ_up = min(σ_next, η·sqrt(σ_next²·(σ²-σ_next²)/σ²)),
                     σ_down = sqrt(σ_next² - σ_up²)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def to_d(x, sigma, denoised):
    return (x - denoised) / sigma


def ancestral_step(sigma_from, sigma_to, eta=1.0) -> Tuple[float, float]:
    """(σ_down, σ_up) for one ancestral step, in float32 as the reference."""
    f, t, eta = np.float32(sigma_from), np.float32(sigma_to), np.float32(eta)
    sigma_up = np.minimum(t, eta * np.sqrt(t**2 * (f**2 - t**2) / np.maximum(f**2, np.float32(1e-20))))
    sigma_down = np.sqrt(np.maximum(t**2 - sigma_up**2, np.float32(0.0)))
    return float(sigma_down), float(sigma_up)


@torch.no_grad()
def sample_euler(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                 noise: Optional[torch.Tensor] = None, s_churn: float = 0.0,
                 s_noise: float = 1.0) -> torch.Tensor:
    n = len(sigmas) - 1
    for i in range(n):
        sigma, sigma_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
        sigma_hat = sigma
        if s_churn > 0 and noise is not None:
            gamma = np.float32(min(s_churn / n, 2**0.5 - 1))
            sigma_hat = sigma * (gamma + np.float32(1.0))
            eps = noise[i][0] * s_noise
            x = x + eps * float(np.sqrt(max(sigma_hat**2 - sigma**2, np.float32(0.0))))
        denoised = model_fn(x, sigma_hat)
        d = to_d(x, float(sigma_hat), denoised)
        x = x + d * float(sigma_next - sigma_hat)
    return x


@torch.no_grad()
def sample_euler_ancestral(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                           noise: torch.Tensor, eta: float = 1.0,
                           s_noise: float = 1.0) -> torch.Tensor:
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
        denoised = model_fn(x, sigma)
        sigma_down, sigma_up = ancestral_step(sigma, sigma_next, eta)
        d = to_d(x, float(sigma), denoised)
        x = x + d * float(np.float32(sigma_down) - sigma)
        if sigma_next > 0:
            x = x + noise[i][0] * s_noise * sigma_up
    return x


@torch.no_grad()
def sample_dpmpp_2m(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM++ 2M: a second-order multistep update in t = −log σ. The first step
    (no previous step) and the last (σ_next = 0) take `denoised` as it is;
    the others extrapolate it from the previous step's."""
    old_denoised, h_last = None, np.float32(0.0)
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
        denoised = model_fn(x, sigma)
        t = -np.log(np.maximum(sigma, np.float32(1e-10)))
        t_next = -np.log(np.maximum(sigma_next, np.float32(1e-10)))
        h = t_next - t
        if h_last == 0 or sigma_next == 0:
            denoised_d = denoised
        else:
            c = np.float32(1.0) / (np.float32(2.0) * (h_last / h))
            denoised_d = denoised * float(np.float32(1.0) + c) - old_denoised * float(c)
        x = x * float(sigma_next / sigma) - denoised_d * float(np.expm1(-h))
        old_denoised, h_last = denoised, h
    return x


@dataclasses.dataclass(frozen=True)
class SamplerInfo:
    fn: Callable
    noise_draws: int = 0          # gaussian draws per step
    uses_ensd: bool = False       # eta-noise-seed-delta reseeds the step noise
    aliases: tuple = ()


SAMPLERS: Dict[str, SamplerInfo] = {
    "Euler a": SamplerInfo(sample_euler_ancestral, 1, uses_ensd=True,
                           aliases=("k_euler_a", "euler_ancestral")),
    "Euler": SamplerInfo(sample_euler, 0, aliases=("k_euler", "euler")),
    "DPM++ 2M": SamplerInfo(sample_dpmpp_2m, 0, aliases=("k_dpmpp_2m", "dpmpp_2m")),
}


def get_sampler(name: str) -> SamplerInfo:
    if name in SAMPLERS:
        return SAMPLERS[name]
    for canonical, info in SAMPLERS.items():
        if name in info.aliases or name.lower() == canonical.lower():
            return info
    raise NotImplementedError(
        f"sampler {name!r} is not ported to forge_tpu_torch yet "
        f"(ported: {', '.join(SAMPLERS)})")

# Copied from forge_tpu/sampling/schedules.py; numpy/stdlib only, so the port imports no JAX.
"""Named σ-schedules (reference modules/sd_schedulers.py:29-228, 16 entries).

Each schedule maps (n_steps, σ_min, σ_max, predictor) → descending float32
σ array of length n+1 ending in 0. All host-side numpy: schedules are tiny
and precomputed before the compiled sampling loop.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np


def _append_zero(sigmas: np.ndarray) -> np.ndarray:
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def karras(n, sigma_min, sigma_max, predictor=None, rho: float = 7.0):
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return _append_zero(sigmas)


def exponential(n, sigma_min, sigma_max, predictor=None):
    sigmas = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n, dtype=np.float64))
    return _append_zero(sigmas)


def polyexponential(n, sigma_min, sigma_max, predictor=None, rho: float = 1.0):
    ramp = np.linspace(1, 0, n, dtype=np.float64) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return _append_zero(sigmas)


def normal(n, sigma_min, sigma_max, predictor):
    """Uniform in the predictor's timestep space ('normal'/'uniform')."""
    start = predictor.timestep(np.asarray(sigma_max, dtype=np.float64))
    end = predictor.timestep(np.asarray(sigma_min, dtype=np.float64))
    ts = np.linspace(float(start), float(end), n, dtype=np.float64)
    sigmas = np.asarray([float(predictor.sigma(np.asarray(t))) for t in ts])
    return _append_zero(sigmas)


def sgm_uniform(n, sigma_min, sigma_max, predictor):
    """Like normal but sampling n+1 points and dropping the final one before
    the trailing zero (SGM convention; needed by turbo/lightning models)."""
    start = predictor.timestep(np.asarray(sigma_max, dtype=np.float64))
    end = predictor.timestep(np.asarray(sigma_min, dtype=np.float64))
    ts = np.linspace(float(start), float(end), n + 1, dtype=np.float64)[:-1]
    sigmas = np.asarray([float(predictor.sigma(np.asarray(t))) for t in ts])
    return _append_zero(sigmas)


def simple(n, sigma_min, sigma_max, predictor):
    table = predictor.sigmas  # ascending [1000]
    ss = len(table) / n
    sigmas = [float(table[-(1 + int(x * ss))]) for x in range(n)]
    return _append_zero(np.asarray(sigmas))


def ddim_uniform(n, sigma_min, sigma_max, predictor):
    table = predictor.sigmas
    ss = max(len(table) // n, 1)
    timesteps = list(range(1, len(table), ss))[:n]
    sigmas = [float(table[t]) for t in reversed(timesteps)]
    return _append_zero(np.asarray(sigmas))


def kl_optimal(n, sigma_min, sigma_max, predictor=None):
    """AYS paper's KL-optimal analytic schedule (arXiv:2404.14507 eq. 33)."""
    adj_idxs = np.arange(n, dtype=np.float64) / (n - 1)
    sigmas = np.tan(adj_idxs * math.atan(sigma_min) + (1 - adj_idxs) * math.atan(sigma_max))
    return _append_zero(sigmas)


# Align-Your-Steps anchor tables (NVIDIA AYS; reference
# modules/sd_schedulers.py:44-70 selects SDXL vs SD1.5 per-model at :60-63):
_AYS_SD15 = [14.615, 6.475, 3.861, 2.697, 1.886, 1.396, 0.963, 0.652, 0.399, 0.152, 0.029]
_AYS_SDXL = [14.615, 6.315, 3.771, 2.181, 1.342, 0.862, 0.555, 0.380, 0.234, 0.113, 0.029]
# GITS variants (reference sd_schedulers.py:137-162):
_AYS_GITS_SD15 = [14.615, 4.617, 2.507, 1.236, 0.702, 0.402, 0.240, 0.156, 0.104, 0.094, 0.029]
_AYS_GITS_SDXL = [14.615, 4.734, 2.567, 1.529, 0.987, 0.652, 0.418, 0.268, 0.179, 0.127, 0.029]
# 32-anchor tables (reference sd_schedulers.py:190-210):
_AYS_32_SD15 = [
    14.615, 11.23951352, 8.64363081, 6.64729424, 5.57250862, 4.71648546,
    3.99196065, 3.5195609, 3.13490466, 2.79228788, 2.48773628, 2.21663865,
    1.97508351, 1.7793172, 1.61475335, 1.46540953, 1.314849, 1.16642497,
    1.03475547, 0.91573744, 0.80748169, 0.71202361, 0.621739, 0.53065202,
    0.4529096, 0.37491455, 0.27461819, 0.2011529, 0.14105873, 0.06682881,
    0.03166121, 0.015,
]
_AYS_32_SDXL = [
    14.615, 11.1491618, 8.50522127, 6.48827151, 5.43707402, 4.60398619,
    3.89854704, 3.27407457, 2.74396527, 2.29968659, 1.95448514, 1.67108715,
    1.42878152, 1.23181009, 1.06789649, 0.92579443, 0.80290886, 0.69660121,
    0.60436903, 0.52852552, 0.46773344, 0.41393379, 0.36258186, 0.31008517,
    0.26518925, 0.22326461, 0.17653877, 0.13959192, 0.10587381, 0.05519369,
    0.02877334, 0.015,
]


def _is_xl_like(predictor) -> bool:
    """AYS anchor choice: reference keys on is_sdxl; everything non-SD1.5-like
    (SDXL and larger) uses the SDXL table."""
    fam = getattr(predictor, "family", None)
    return fam in ("sdxl", "sdxl_refiner", "sd3", "flux", "chroma")


def _loglinear_interp(t_steps, num_steps):
    """Log-linearly resample an anchor σ-list to num_steps points."""
    xs = np.linspace(0, 1, len(t_steps))
    ys = np.log(np.asarray(t_steps)[::-1])
    new_xs = np.linspace(0, 1, num_steps)
    new_ys = np.interp(new_xs, xs, ys)
    return np.exp(new_ys)[::-1].copy()


def _ays(n, anchors):
    if n != len(anchors):
        sigmas = _loglinear_interp(anchors, n)
    else:
        sigmas = np.asarray(anchors, dtype=np.float64)
    return _append_zero(sigmas)


def align_your_steps(n, sigma_min, sigma_max, predictor=None):
    return _ays(n, _AYS_SDXL if _is_xl_like(predictor) else _AYS_SD15)


def align_your_steps_gits(n, sigma_min, sigma_max, predictor=None):
    return _ays(n, _AYS_GITS_SDXL if _is_xl_like(predictor) else _AYS_GITS_SD15)


# _11/_32 are the same tables at fixed anchor counts (reference :164-210)
align_your_steps_11 = align_your_steps


def align_your_steps_32(n, sigma_min, sigma_max, predictor=None):
    return _ays(n, _AYS_32_SDXL if _is_xl_like(predictor) else _AYS_32_SD15)


def beta_schedule(n, sigma_min, sigma_max, predictor=None, alpha=None, beta=None):
    from ..runtime.options import opts

    alpha = float(opts.get("beta_dist_alpha")) if alpha is None else alpha
    beta = float(opts.get("beta_dist_beta")) if beta is None else beta
    import scipy.stats

    timesteps = 1 - np.linspace(0, 1, n)
    timesteps = scipy.stats.beta.ppf(timesteps, alpha, beta)
    sigmas = sigma_min + (timesteps * (sigma_max - sigma_min))
    return _append_zero(sigmas)


def turbo(n, sigma_min, sigma_max, predictor):
    """Trailing timesteps for few-step distilled models."""
    table = predictor.sigmas
    ts = [int(max(1000 / n * (n - i) - 1, 0)) for i in range(n)]
    sigmas = [float(predictor.sigma(np.asarray(float(t)))) for t in ts]
    return _append_zero(np.asarray(sigmas))


SCHEDULES: Dict[str, Callable] = {
    "automatic": None,  # resolved by the sampler (karras-default samplers etc.)
    "uniform": normal,
    "normal": normal,
    "karras": karras,
    "exponential": exponential,
    "polyexponential": polyexponential,
    "sgm_uniform": sgm_uniform,
    "kl_optimal": kl_optimal,
    "align_your_steps": align_your_steps,
    "align_your_steps_GITS": align_your_steps_gits,
    "align_your_steps_11": align_your_steps_11,
    "align_your_steps_32": align_your_steps_32,
    "simple": simple,
    "ddim": ddim_uniform,
    "beta": beta_schedule,
    "turbo": turbo,
}


def get_sigmas(
    name: str,
    n: int,
    predictor,
    sigma_min: Optional[float] = None,
    sigma_max: Optional[float] = None,
    discard_next_to_last: bool = False,
) -> np.ndarray:
    """Resolve a named schedule against a predictor. `discard_next_to_last`
    reproduces the reference's 'discard penultimate sigma' sampler quirk
    (sd_samplers_kdiffusion.py:81-134, needed by dpm2/dpm2-a samplers)."""
    sigma_min = predictor.sigma_min if sigma_min is None else sigma_min
    sigma_max = predictor.sigma_max if sigma_max is None else sigma_max
    steps = n + 1 if discard_next_to_last else n
    fn = SCHEDULES.get(name) or karras
    sigmas = fn(steps, sigma_min, sigma_max, predictor)
    if discard_next_to_last:
        sigmas = np.concatenate([sigmas[:-2], sigmas[-1:]])
    return sigmas.astype(np.float32)

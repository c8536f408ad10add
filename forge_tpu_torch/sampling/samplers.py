"""The 25 samplers as Python step loops (port of forge_tpu/sampling/samplers.py).

`model_fn(x, σ) -> denoised` is the CFG-combined x0 prediction
(sampling/cfg.py); the CFG++ sampler's returns the pair (x0, uncond x0).
σ values and every step scalar are host float32, computed as the reference
computes them; coefficient tables (LMS, ipndm_v, DEIS, UniPC, Restart's
plan) are host numpy. Per-step gaussian noise is precomputed on the host
(`noise[n_steps, draws, B, C, h, w]`: the Philox stream, or the Brownian
tree for the SDE samplers), so a seed gives the reference's image.
Multistep history is a short Python list of tensors, newest first.

The reference's scan evaluates both branches of its final-step `where`, so
seven of its samplers (Heun, DPM2, DPM2 a, DPM++ 2S a, DPM++ SDE, Heun++2,
Restart) make a model call at σ = 0 and throw it away. These loops skip it,
as k-diffusion does: the image is the same. DPM adaptive reads its error
norm back each iteration (`.item()`), since the next σ depends on it.

Conventions:
    d = to_d(x, σ, denoised) = (x - denoised) / σ
    ancestral split: σ_up = min(σ_next, η·sqrt(σ_next²·(σ²-σ_next²)/σ²)),
                     σ_down = sqrt(σ_next² - σ_up²)
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

F = np.float32


def to_d(x, sigma, denoised):
    return (x - denoised) / float(sigma)


def ancestral_step(sigma_from, sigma_to, eta=1.0) -> Tuple[np.float32, np.float32]:
    """(σ_down, σ_up) for one ancestral step, in float32 as the reference."""
    f, t, eta = F(sigma_from), F(sigma_to), F(eta)
    sigma_up = np.minimum(t, eta * np.sqrt(t**2 * (f**2 - t**2) / np.maximum(f**2, F(1e-20))))
    sigma_down = np.sqrt(np.maximum(t**2 - sigma_up**2, F(0.0)))
    return sigma_down, sigma_up


def _t_of(sigma) -> np.float32:
    """t = −log σ, σ floored at 1e-10 (float32)."""
    return -np.log(np.maximum(F(sigma), F(1e-10)))


def _sig_of(t) -> np.float32:
    return np.exp(-F(t))


def _pairs(sigmas):
    sig = np.asarray(sigmas, np.float32)
    return [(sig[i], sig[i + 1]) for i in range(len(sig) - 1)]


def _dot(coeffs, history: List[torch.Tensor]) -> torch.Tensor:
    """Σ coeffs[j]·history[j] over the history there is (a coefficient past
    it is 0 in the reference's zero-padded tables)."""
    out = history[0] * float(coeffs[0])
    for c, h in zip(coeffs[1:len(history)], history[1:]):
        out = out + h * float(c)
    return out


# ---------------------------------------------------------------------------
# first-order


@torch.no_grad()
def sample_euler(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                 noise: Optional[torch.Tensor] = None, s_churn: float = 0.0,
                 s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0) -> torch.Tensor:
    n = len(sigmas) - 1
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        sigma_hat = sigma
        if s_churn > 0 and noise is not None:
            gamma = F(min(s_churn / n, 2**0.5 - 1) if s_tmin <= sigma <= s_tmax else 0.0)
            sigma_hat = sigma * (gamma + F(1.0))
            eps = noise[i][0] * s_noise
            x = x + eps * float(np.sqrt(max(sigma_hat**2 - sigma**2, F(0.0))))
        denoised = model_fn(x, sigma_hat)
        d = to_d(x, sigma_hat, denoised)
        x = x + d * float(sigma_next - sigma_hat)
    return x


@torch.no_grad()
def sample_euler_ancestral(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                           noise: torch.Tensor, eta: float = 1.0,
                           s_noise: float = 1.0) -> torch.Tensor:
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        sigma_down, sigma_up = ancestral_step(sigma, sigma_next, eta)
        x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        if sigma_next > 0:
            x = x + noise[i][0] * s_noise * float(sigma_up)
    return x


# ---------------------------------------------------------------------------
# second-order single-step


@torch.no_grad()
def sample_heun(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                noise: Optional[torch.Tensor] = None, s_noise: float = 1.0) -> torch.Tensor:
    for sigma, sigma_next in _pairs(sigmas):
        d = to_d(x, sigma, model_fn(x, sigma))
        dt = float(sigma_next - sigma)
        x_euler = x + d * dt
        if sigma_next == 0:
            x = x_euler
            continue
        d_2 = to_d(x_euler, sigma_next, model_fn(x_euler, sigma_next))
        x = x + (d + d_2) / 2 * dt
    return x


@torch.no_grad()
def sample_dpm_2(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                 noise: Optional[torch.Tensor] = None, s_noise: float = 1.0) -> torch.Tensor:
    for sigma, sigma_next in _pairs(sigmas):
        d = to_d(x, sigma, model_fn(x, sigma))
        if sigma_next == 0:
            x = x + d * float(sigma_next - sigma)
            continue
        sigma_mid = np.exp(F(0.5) * (np.log(sigma) + np.log(np.maximum(sigma_next, F(1e-10)))))
        x_2 = x + d * float(sigma_mid - sigma)
        d_2 = to_d(x_2, sigma_mid, model_fn(x_2, sigma_mid))
        x = x + d_2 * float(sigma_next - sigma)
    return x


@torch.no_grad()
def sample_dpm_2_ancestral(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                           noise: torch.Tensor, eta: float = 1.0,
                           s_noise: float = 1.0) -> torch.Tensor:
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        d = to_d(x, sigma, model_fn(x, sigma))
        sigma_down, sigma_up = ancestral_step(sigma, sigma_next, eta)
        if sigma_down == 0:
            x = x + d * float(sigma_down - sigma)
            continue
        sigma_mid = np.exp(F(0.5) * (np.log(sigma) + np.log(np.maximum(sigma_down, F(1e-10)))))
        x_2 = x + d * float(sigma_mid - sigma)
        d_2 = to_d(x_2, sigma_mid, model_fn(x_2, sigma_mid))
        x = x + d_2 * float(sigma_down - sigma) + noise[i][0] * s_noise * float(sigma_up)
    return x


@torch.no_grad()
def sample_dpmpp_2s_ancestral(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                              noise: torch.Tensor, eta: float = 1.0,
                              s_noise: float = 1.0) -> torch.Tensor:
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        sigma_down, sigma_up = ancestral_step(sigma, sigma_next, eta)
        if sigma_down == 0:  # the Euler step to σ_down
            x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        else:
            t, t_next = _t_of(sigma), _t_of(np.maximum(sigma_down, F(1e-10)))
            h = t_next - t
            s_mid = t + F(0.5) * h
            x_2 = x * float(_sig_of(s_mid) / _sig_of(t)) - denoised * float(np.expm1(-h * F(0.5)))
            denoised_2 = model_fn(x_2, _sig_of(s_mid))
            x = x * float(_sig_of(t_next) / _sig_of(t)) - denoised_2 * float(np.expm1(-h))
        if sigma_next > 0:
            x = x + noise[i][0] * s_noise * float(sigma_up)
    return x


# ---------------------------------------------------------------------------
# DPM++ multistep and SDE


@torch.no_grad()
def sample_dpmpp_2m(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM++ 2M: a second-order multistep update in t = −log σ. The first step
    (no previous step) and the last (σ_next = 0) take `denoised` as it is;
    the others extrapolate it from the previous step's."""
    old_denoised, h_last = None, F(0.0)
    for sigma, sigma_next in _pairs(sigmas):
        denoised = model_fn(x, sigma)
        h = _t_of(sigma_next) - _t_of(sigma)
        if h_last == 0 or sigma_next == 0:
            denoised_d = denoised
        else:
            c = F(1.0) / (F(2.0) * (h_last / h))
            denoised_d = denoised * float(F(1.0) + c) - old_denoised * float(c)
        x = x * float(sigma_next / sigma) - denoised_d * float(np.expm1(-h))
        old_denoised, h_last = denoised, h
    return x


@torch.no_grad()
def sample_dpmpp_sde(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                     noise: torch.Tensor, eta: float = 1.0, s_noise: float = 1.0,
                     r: float = 1 / 2) -> torch.Tensor:
    """DPM++ SDE (2-stage); noise [n, 2, ...]: two draws a step."""
    c1 = 1 / (2 * r)
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        if sigma_next == 0:
            x = x + to_d(x, sigma, denoised) * float(sigma_next - sigma)
            continue
        t, t_next = _t_of(sigma), _t_of(np.maximum(sigma_next, F(1e-10)))
        h = t_next - t
        s_mid = t + h * F(r)
        sd, su = ancestral_step(_sig_of(t), _sig_of(s_mid), eta)
        s_ = _t_of(sd)
        x_2 = x * float(_sig_of(s_) / _sig_of(t)) - denoised * float(np.expm1(t - s_))
        x_2 = x_2 + noise[i][0] * s_noise * float(su)
        denoised_2 = model_fn(x_2, _sig_of(s_mid))
        sd2, su2 = ancestral_step(_sig_of(t), _sig_of(t_next), eta)
        t_next_ = _t_of(sd2)
        denoised_d = denoised * (1 - c1) + denoised_2 * c1
        x = x * float(_sig_of(t_next_) / _sig_of(t)) - denoised_d * float(np.expm1(t - t_next_))
        x = x + noise[i][1] * s_noise * float(su2)
    return x


@torch.no_grad()
def sample_dpmpp_2m_sde(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                        noise: torch.Tensor, eta: float = 1.0, s_noise: float = 1.0,
                        solver_type: str = "midpoint") -> torch.Tensor:
    old_denoised, h_last = None, F(0.0)
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        h = _t_of(sigma_next) - _t_of(sigma)
        if sigma_next == 0:
            x = denoised
            continue
        eta_h = F(eta) * h
        x = x * float(sigma_next / sigma * np.exp(-eta_h)) + denoised * float(-np.expm1(-h - eta_h))
        if h_last != 0:
            r = h_last / h
            if solver_type == "heun":
                c = (-np.expm1(-h - eta_h) / (-h - eta_h) + F(1)) / r
            else:  # midpoint
                c = F(0.5) * (-np.expm1(-h - eta_h)) / r
            x = x + (denoised - old_denoised) * float(c)
        if eta:
            sigma_up = sigma_next * np.sqrt(np.maximum(-np.expm1(F(-2) * eta_h), F(0.0)))
            x = x + noise[i][0] * s_noise * float(sigma_up)
        old_denoised, h_last = denoised, h
    return x


@torch.no_grad()
def sample_dpmpp_3m_sde(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                        noise: torch.Tensor, eta: float = 1.0,
                        s_noise: float = 1.0) -> torch.Tensor:
    den_1 = den_2 = None
    h_1 = h_2 = F(0.0)
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        h = _t_of(sigma_next) - _t_of(sigma)
        if sigma_next == 0:
            x = denoised
            continue
        h_eta = h * F(eta + 1)
        x = x * float(np.exp(-h_eta)) + denoised * float(-np.expm1(-h_eta))
        phi_2 = np.expm1(-h_eta) / h_eta + F(1)
        if h_1 != 0 and h_2 != 0:
            r0, r1 = h_1 / h, h_2 / h
            d1_0 = (denoised - den_1) / float(r0)
            d1_1 = (den_1 - den_2) / float(r1)
            d1 = d1_0 + (d1_0 - d1_1) * float(r0) / float(r0 + r1)
            d2 = (d1_0 - d1_1) / float(r0 + r1)
            phi_3 = phi_2 / h_eta - F(0.5)
            x = x + d1 * float(phi_2) - d2 * float(phi_3)
        elif h_1 != 0:
            x = x + (denoised - den_1) / float(h_1 / h) * float(phi_2)
        if eta:
            sigma_up = sigma_next * np.sqrt(np.maximum(-np.expm1(F(-2) * h * F(eta)), F(0.0)))
            x = x + noise[i][0] * s_noise * float(sigma_up)
        den_1, den_2, h_1, h_2 = denoised, den_1, h, h_1
    return x


# ---------------------------------------------------------------------------
# linear multistep (coefficients precomputed on the host)


def _lms_coeffs(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Integrated Lagrange-basis coefficients per step, [n, order]."""
    import scipy.integrate

    sig = np.asarray(sigmas, dtype=np.float64)
    n = len(sig) - 1
    coeffs = np.zeros((n, order))
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            def fn(tau, j=j, i=i):
                prod = 1.0
                for k in range(cur_order):
                    if k == j:
                        continue
                    prod *= (tau - sig[i - k]) / (sig[i - j] - sig[i - k])
                return prod

            coeffs[i, j] = scipy.integrate.quad(fn, sig[i], sig[i + 1], epsrel=1e-4)[0]
    return coeffs.astype(np.float32)


def _multistep(model_fn, x, sigmas, coeffs, order, scale_by_dt: bool):
    """x += Σ cs[j]·d_j over the newest-first derivative history; with
    `scale_by_dt` the sum is taken times σ_next − σ (the ipndm family)."""
    ds: List[torch.Tensor] = []
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        ds = [to_d(x, sigma, model_fn(x, sigma))] + ds[:order - 1]
        update = _dot(coeffs[i], ds)
        x = x + (update * float(sigma_next - sigma) if scale_by_dt else update)
    return x


@torch.no_grad()
def sample_lms(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
               noise: Optional[torch.Tensor] = None, order: int = 4) -> torch.Tensor:
    return _multistep(model_fn, x, sigmas, _lms_coeffs(np.asarray(sigmas), order), order, False)


@torch.no_grad()
def sample_heunpp2(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                   noise: Optional[torch.Tensor] = None, s_noise: float = 1.0) -> torch.Tensor:
    """Heun++: a third probe direction on interior steps, σ-weighted blend."""
    sig = np.asarray(sigmas, np.float32)
    two_s0, three_s0 = F(2 * float(sig[0])), F(3 * float(sig[0]))
    for i, (sigma, sigma_next) in enumerate(_pairs(sig)):
        sigma_next2 = sig[i + 2] if i + 2 < len(sig) else F(0.0)
        d = to_d(x, sigma, model_fn(x, sigma))
        dt = float(sigma_next - sigma)
        x_2 = x + d * dt
        if sigma_next == 0:
            x = x_2
            continue
        s2 = np.maximum(sigma_next, F(1e-8))
        d_2 = to_d(x_2, s2, model_fn(x_2, s2))
        if sigma_next2 == 0:
            w2h = sigma_next / two_s0
            x = x + (d * float(1 - w2h) + d_2 * float(w2h)) * dt
            continue
        x_3 = x_2 + d_2 * float(sigma_next2 - sigma_next)
        s3 = np.maximum(sigma_next2, F(1e-8))
        d_3 = to_d(x_3, s3, model_fn(x_3, s3))
        w2, w3 = sigma_next / three_s0, sigma_next2 / three_s0
        x = x + (d * float(1 - w2 - w3) + d_2 * float(w2) + d_3 * float(w3)) * dt
    return x


# Adams-Bashforth coefficients (the ipndm family), by order
_AB_COEFFS = (
    (1.0,),
    (3 / 2, -1 / 2),
    (23 / 12, -16 / 12, 5 / 12),
    (55 / 24, -59 / 24, 37 / 24, -9 / 24),
)


@torch.no_grad()
def sample_ipndm(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                 noise: Optional[torch.Tensor] = None, order: int = 4) -> torch.Tensor:
    """Improved pseudo-numerical method: fixed-coefficient Adams-Bashforth
    over the probe-flow derivative, warming up through orders 1..order."""
    n = len(sigmas) - 1
    coeffs = [_AB_COEFFS[min(i + 1, order) - 1] for i in range(n)]
    return _multistep(model_fn, x, sigmas, coeffs, order, True)


def _ipndm_v_coeffs(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Variable-step Adams-Bashforth coefficients from the step-size ratios,
    [n, order], as the zju-pi diff-sampler solvers publish them."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    coeff_table = np.zeros((n, order))
    for i in range(n):
        cur = min(i + 1, order)
        if cur == 1:
            coeff_table[i, 0] = 1.0
            continue
        h_n = sig[i + 1] - sig[i]
        h_1 = sig[i] - sig[i - 1]
        if cur == 2:
            coeff_table[i, 0] = (2 + h_n / h_1) / 2
            coeff_table[i, 1] = -(h_n / h_1) / 2
            continue
        h_2 = sig[i - 1] - sig[i - 2]
        if cur == 3:
            temp = (1 - h_n / (3 * (h_n + h_1)) * (h_n * (h_n + h_1)) / (h_1 * (h_1 + h_2))) / 2
            coeff_table[i, 0] = (2 + h_n / h_1) / 2 + temp
            coeff_table[i, 1] = -(h_n / h_1) / 2 - (1 + h_1 / h_2) * temp
            coeff_table[i, 2] = temp * h_1 / h_2
            continue
        h_3 = sig[i - 2] - sig[i - 3]
        t1 = (1 - h_n / (3 * (h_n + h_1)) * (h_n * (h_n + h_1)) / (h_1 * (h_1 + h_2))) / 2
        t2 = ((1 - h_n / (3 * (h_n + h_1))) / 2
              + (1 - h_n / (2 * (h_n + h_1))) * h_n / (6 * (h_n + h_1 + h_2))) \
            * (h_n * (h_n + h_1) * (h_n + h_1 + h_2)) / (h_1 * (h_1 + h_2) * (h_1 + h_2 + h_3))
        coeff_table[i, 0] = (2 + h_n / h_1) / 2 + t1 + t2
        coeff_table[i, 1] = -(h_n / h_1) / 2 - (1 + h_1 / h_2) * t1 \
            - (1 + h_1 / h_2 + h_1 * (h_1 + h_2) / (h_2 * (h_2 + h_3))) * t2
        coeff_table[i, 2] = t1 * h_1 / h_2 \
            + (h_1 / h_2 + h_1 * (h_1 + h_2) / (h_2 * (h_2 + h_3)) * (1 + h_2 / h_3)) * t2
        coeff_table[i, 3] = -t2 * (h_1 * (h_1 + h_2) / (h_2 * (h_2 + h_3))) * h_1 / h_2
    return coeff_table.astype(np.float32)


@torch.no_grad()
def sample_ipndm_v(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                   noise: Optional[torch.Tensor] = None, order: int = 4) -> torch.Tensor:
    return _multistep(model_fn, x, sigmas, _ipndm_v_coeffs(sigmas, order), order, True)


def _deis_coeffs(sigmas: np.ndarray, max_order: int = 3, n_quad: int = 10000) -> np.ndarray:
    """DEIS 'tab' coefficients, [n, max_order]: the integrand's d log α/dτ
    in closed form (−τ(β1−β0) − β0 for log α = −½τ²(β1−β0) − τβ0)."""
    sig = np.asarray(sigmas, np.float64)
    eps_s, s_min, s_max = 1e-3, 0.002, 80.0
    beta_d = 2 * (np.log(s_min**2 + 1) / eps_s - np.log(s_max**2 + 1)) / (eps_s - 1)
    beta_min = np.log(s_max**2 + 1) - 0.5 * beta_d

    def sigma_inv(s):
        return (np.sqrt(beta_min**2 + 2 * beta_d * np.log(s**2 + 1)) - beta_min) / beta_d

    t_steps = sigma_inv(np.maximum(sig, 1e-10))
    n = len(sig) - 1
    coeffs = np.zeros((n, max_order), np.float64)
    for i in range(n):
        order = min(i + 1, max_order)
        if sig[i + 1] <= 0:
            order = 1
        if order == 1:
            coeffs[i, 0] = sig[i + 1] - sig[i]  # plain Euler on d
            continue
        taus = np.linspace(t_steps[i], t_steps[i + 1], n_quad)
        dtau = (t_steps[i + 1] - t_steps[i]) / n_quad
        alpha = np.exp(-0.5 * taus**2 * (beta_d) - taus * beta_min)
        dlog_alpha = -taus * beta_d - beta_min
        integrand = -0.5 * dlog_alpha / np.sqrt(np.maximum(alpha * (1 - alpha), 1e-12))
        prev_t = t_steps[[i - k for k in range(order)]]
        for j in range(order):
            poly = np.ones_like(taus)
            for k in range(order):
                if k != j:
                    poly *= (taus - prev_t[k]) / (prev_t[j] - prev_t[k])
            coeffs[i, j] = np.sum(integrand * poly) * dtau
    return coeffs.astype(np.float32)


@torch.no_grad()
def sample_deis(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                noise: Optional[torch.Tensor] = None, max_order: int = 3) -> torch.Tensor:
    return _multistep(model_fn, x, sigmas, _deis_coeffs(np.asarray(sigmas), max_order),
                      max_order, False)


# ---------------------------------------------------------------------------
# DDPM, LCM, DDIM


@torch.no_grad()
def sample_ddpm(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                noise: torch.Tensor, s_noise: float = 1.0) -> torch.Tensor:
    """The DDPM ancestral update in σ-space: ᾱ = 1/(1+σ²)."""
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        if not sigma_next > 0:
            x = denoised
            continue
        abar_t = F(1.0) / (F(1.0) + sigma**2)
        abar_prev = F(1.0) / (F(1.0) + sigma_next**2)
        alpha_t = abar_t / abar_prev
        beta_t = F(1.0) - alpha_t
        eps = (x - denoised) / float(sigma)
        x_ddpm = x * float(np.sqrt(abar_t))
        mean = (x_ddpm - eps * float(beta_t / np.sqrt(F(1.0) - abar_t))) / float(np.sqrt(alpha_t))
        sigma_up = np.sqrt(beta_t) / np.sqrt(abar_prev)
        x = mean / float(np.sqrt(abar_prev)) + noise[i][0] * s_noise * float(sigma_up)
    return x


@torch.no_grad()
def sample_lcm(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
               noise: torch.Tensor, s_noise: float = 1.0) -> torch.Tensor:
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        x = model_fn(x, sigma)
        if sigma_next > 0:
            x = x + noise[i][0] * float(sigma_next)
    return x


@torch.no_grad()
def sample_ddim(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                noise: Optional[torch.Tensor] = None, eta: float = 0.0) -> torch.Tensor:
    """DDIM in σ-space: with η = 0 it is Euler on the ddim schedule."""
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        denoised = model_fn(x, sigma)
        sigma_down, sigma_up = ancestral_step(sigma, sigma_next, eta)
        x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        if eta > 0 and noise is not None and sigma_next > 0:
            x = x + noise[i][0] * float(sigma_up)
    return x


@torch.no_grad()
def sample_ddim_cfgpp(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                      noise: Optional[torch.Tensor] = None, eta: float = 0.0) -> torch.Tensor:
    """DDIM CFG++: the direction term takes the uncond prediction; model_fn
    returns the pair (x0 with CFG, x0 of the uncond)."""
    for i, (sigma, sigma_next) in enumerate(_pairs(sigmas)):
        den, den_un = model_fn(x, sigma)
        if sigma_next == 0:
            x = den
            continue
        sigma_down, sigma_up = ancestral_step(sigma, sigma_next, eta)
        x = den + to_d(x, sigma, den_un) * float(sigma_down)
        if eta > 0 and noise is not None:
            x = x + noise[i][0] * float(sigma_up)
    return x


# ---------------------------------------------------------------------------
# Restart (Heun steps over an expanded step list, noise at each jump back up)


def _karras_np(n, sigma_min, sigma_max, rho=7.0):
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return np.append((hi + ramp * (lo - hi)) ** rho, 0.0).astype(np.float32)


def _restart_plan(sigmas: np.ndarray):
    """Expanded (σ_old, σ_new, noise_scale, jump_idx) step list, on the host."""
    sig = np.asarray(sigmas, np.float64)
    steps = len(sig) - 1
    restart_list = {}
    if steps >= 20:
        restart_steps, restart_times = 9, 1
        if steps >= 36:
            restart_steps, restart_times = steps // 4, 2
        sig = _karras_np(steps - restart_steps * restart_times,
                         float(sig[-2]), float(sig[0])).astype(np.float64)
        restart_list = {0.1: [restart_steps + 1, restart_times, 2]}
    restart_list = {int(np.argmin(np.abs(sig - key))): value
                    for key, value in restart_list.items()}
    pairs = []
    for i in range(len(sig) - 1):
        pairs.append((sig[i], sig[i + 1]))
        if i + 1 in restart_list:
            r_steps, r_times, r_max = restart_list[i + 1]
            min_idx, max_idx = i + 1, int(np.argmin(np.abs(sig - r_max)))
            if max_idx < min_idx:
                sr = _karras_np(r_steps, float(sig[min_idx]), float(sig[max_idx]))[:-1]
                for _ in range(r_times):
                    pairs.extend(zip(sr[:-1], sr[1:]))
    old = np.asarray([p[0] for p in pairs], np.float32)
    new = np.asarray([p[1] for p in pairs], np.float32)
    # noise is injected whenever σ jumps back up (last_new < old)
    scale = np.zeros(len(pairs), np.float32)
    jump = np.zeros(len(pairs), np.int32)
    nj = 0
    for k in range(1, len(pairs)):
        if new[k - 1] < old[k]:
            scale[k] = np.sqrt(max(old[k] ** 2 - new[k - 1] ** 2, 0.0))
            jump[k] = nj
            nj += 1
    return old, new, scale, jump


@torch.no_grad()
def sample_restart(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                   noise: Optional[torch.Tensor] = None, s_noise: float = 1.0) -> torch.Tensor:
    old, new, scale, jump = _restart_plan(np.asarray(sigmas))
    for k in range(len(old)):
        if noise is not None and scale[k] != 0:
            # the jump's noise, from the per-step stream
            x = x + noise[min(int(jump[k]), noise.shape[0] - 1)][0] * float(F(s_noise) * scale[k])
        d = to_d(x, old[k], model_fn(x, old[k]))
        dt = float(new[k] - old[k])
        x_euler = x + d * dt
        if new[k] == 0:
            x = x_euler
            continue
        sn = np.maximum(new[k], F(1e-8))
        d_2 = to_d(x_euler, sn, model_fn(x_euler, sn))
        x = x + (d + d_2) / 2 * dt
    return x


# ---------------------------------------------------------------------------
# DPM-Solver fast and adaptive (arXiv:2206.00927), eps-space, t = −ln σ


def _dpm_eps(model_fn, x, sigma):
    return (x - model_fn(x, sigma)) / float(sigma)


@torch.no_grad()
def sample_dpm_fast(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                    noise: Optional[torch.Tensor] = None, s_noise: float = 1.0) -> torch.Tensor:
    """Fixed-plan DPM-Solver-Fast: order-3 blocks over uniform t (the plan
    depends only on the σ schedule)."""
    sig = np.asarray(sigmas, np.float64)
    sigma_min, sigma_max = float(sig[sig > 0].min()), float(sig.max())
    nfe = len(sig) - 1
    t_start, t_end = -np.log(sigma_max), -np.log(sigma_min)
    m = nfe // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1)
    orders = [3] * (m - 2) + [2, 1] if nfe % 3 == 0 else [3] * (m - 1) + [nfe % 3]

    def s_of(t):
        return F(np.exp(-t))

    for i, order in enumerate(orders):
        t, t_next = ts[i], ts[i + 1]
        h = t_next - t
        e_h = F(np.expm1(h))
        eps = _dpm_eps(model_fn, x, s_of(t))
        x_1 = x - eps * float(s_of(t_next) * e_h)
        if order == 1:
            x = x_1
        elif order == 2:
            r1 = 0.5
            s1 = t + r1 * h
            u1 = x - eps * float(s_of(s1) * F(np.expm1(r1 * h)))
            eps_r1 = _dpm_eps(model_fn, u1, s_of(s1))
            x = x_1 - (eps_r1 - eps) * float(s_of(t_next) / F(2 * r1) * e_h)
        else:
            r1, r2 = 1 / 3, 2 / 3
            s1, s2 = t + r1 * h, t + r2 * h
            u1 = x - eps * float(s_of(s1) * F(np.expm1(r1 * h)))
            eps_r1 = _dpm_eps(model_fn, u1, s_of(s1))
            u2 = (x - eps * float(s_of(s2) * F(np.expm1(r2 * h)))
                  - (eps_r1 - eps) * float(s_of(s2) * F(r2 / r1) * F(np.expm1(r2 * h) / (r2 * h) - 1)))
            eps_r2 = _dpm_eps(model_fn, u2, s_of(s2))
            x = x_1 - (eps_r2 - eps) * float(s_of(t_next) / F(r2) * F(np.expm1(h) / h - 1))
    return x


@torch.no_grad()
def sample_dpm_adaptive(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                        noise: Optional[torch.Tensor] = None, rtol: float = 0.05,
                        atol: float = 0.0078, h_init: float = 0.05,
                        accept_safety: float = 0.81, max_steps: int = 200) -> torch.Tensor:
    """Adaptive DPM-Solver-23 with the I-controller (pcoeff 0, icoeff 1,
    dcoeff 0, η 0). The step's error norm is read back each iteration; the
    controller's arithmetic is float32, as the reference's."""
    sig = np.asarray(sigmas, np.float64)
    sigma_min, sigma_max = float(sig[sig > 0].min()), float(sig.max())
    t_end = F(-math.log(sigma_min))
    stop = F(-math.log(sigma_min) - 1e-5)
    s, h = F(-math.log(sigma_max)), F(h_init)
    r1, r2 = F(1 / 3), F(2 / 3)
    x_prev = x
    for _ in range(max_steps):
        if not s < stop:
            break
        t = np.minimum(t_end, s + h)
        hh = t - s
        eps = _dpm_eps(model_fn, x, np.exp(-s))
        s1 = s + r1 * hh
        u1 = x - eps * float(np.exp(-s1) * np.expm1(r1 * hh))
        eps_r1 = _dpm_eps(model_fn, u1, np.exp(-s1))
        e_h = np.expm1(hh)
        x_1 = x - eps * float(np.exp(-t) * e_h)
        x_low = x_1 - (eps_r1 - eps) * float(np.exp(-t) / (F(2) * r1) * e_h)
        s2 = s + r2 * hh
        u2 = (x - eps * float(np.exp(-s2) * np.expm1(r2 * hh))
              - (eps_r1 - eps) * float(np.exp(-s2) * (r2 / r1) * (np.expm1(r2 * hh) / (r2 * hh) - F(1))))
        eps_r2 = _dpm_eps(model_fn, u2, np.exp(-s2))
        x_high = x_1 - (eps_r2 - eps) * float(np.exp(-t) / r2 * (e_h / hh - F(1)))
        delta = torch.clamp_min(torch.maximum(x_low.abs(), x_prev.abs()) * rtol, atol)
        error = F(torch.sqrt(torch.mean(((x_low - x_high) / delta) ** 2)).item())
        inv_err = F(1.0) / (error + F(1e-8))
        root = inv_err ** F(1 / 3)
        factor = np.minimum(np.maximum(root, F(0.333)), F(1) + np.arctan(root - F(1)))
        if factor >= F(accept_safety):
            x, x_prev, s = x_high, x_low, t
        h = h * factor
    return x


# ---------------------------------------------------------------------------
# PLMS (pseudo linear multistep, σ-space: the DDIM update is the Euler step)

_PLMS_COEFFS = (
    (1.0, 0.0, 0.0, 0.0),                       # (the first step is peeled: RK2)
    (3 / 2, -1 / 2, 0.0, 0.0),
    (23 / 12, -16 / 12, 5 / 12, 0.0),
    (55 / 24, -59 / 24, 37 / 24, -9 / 24),
)


@torch.no_grad()
def sample_plms(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    sig = np.asarray(sigmas, np.float32)
    n = len(sig) - 1
    # step 0: pseudo improved Euler (RK2 across the first interval)
    s0, s1 = sig[0], np.maximum(sig[1], F(1e-8))
    e_t = to_d(x, s0, model_fn(x, s0))
    x_prev = x + e_t * float(s1 - s0)
    e_t_next = to_d(x_prev, s1, model_fn(x_prev, s1))
    x = x + (e_t + e_t_next) / 2 * float(s1 - s0)
    es = [e_t]
    for i in range(1, n):
        sigma, sigma_next = sig[i], sig[i + 1]
        es = [to_d(x, sigma, model_fn(x, sigma))] + es[:3]
        coeffs = np.asarray(_PLMS_COEFFS[min(i, 3)], np.float32)
        x = x + _dot(coeffs, es) * float(sigma_next - sigma)
    return x


# ---------------------------------------------------------------------------
# UniPC (arXiv:2302.04867, bh2, x0-prediction) in σ-space (λ = −ln σ); the
# R-matrix solves happen on the host: the σ schedule is static.

_UNIPC_ORDER = 3


def _unipc_coeffs(sigmas: np.ndarray, order: int = _UNIPC_ORDER):
    """Per-step host coefficients for the update from σ_i to σ_{i+1}: ratio
    σ_{i+1}/σ_i, φ₁ = expm1(−h), B_h, predictor weights cp[k] and corrector
    weights cc[k] on (m_{k+1} − m₀) with 1/r_k folded in, and the
    corrector's weight on the fresh model evaluation."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    lam = -np.log(np.maximum(sig, 1e-10))
    K = order
    out = {
        "ratio": np.zeros(n), "phi1": np.zeros(n), "bh": np.zeros(n),
        "cp": np.zeros((n, K - 1)), "cc": np.zeros((n, K - 1)),
        "cc_new": np.zeros(n), "use_corr": np.zeros(n),
    }
    for i in range(n):  # history at i, i-1, ...
        cur_order = min(i + 1, K, n - i)  # lower_order_final
        h = lam[i + 1] - lam[i]
        hh = -h
        rk_vals = [(lam[i - k] - lam[i]) / h for k in range(1, cur_order)]
        rks = np.asarray(rk_vals + [1.0])
        h_phi_1 = np.expm1(hh)
        b_h = np.expm1(hh)  # bh2
        R, b = [], []
        h_phi_k = h_phi_1 / hh - 1
        fac = 1
        for k in range(1, cur_order + 1):
            R.append(rks ** (k - 1))
            b.append(h_phi_k * fac / b_h)
            fac *= k + 1
            h_phi_k = h_phi_k / hh - 1 / fac
        R = np.stack(R)
        b = np.asarray(b)
        if cur_order > 1:
            rhos_p = (np.asarray([0.5]) if cur_order == 2
                      else np.linalg.solve(R[:-1, :-1], b[:-1]))
        else:
            rhos_p = np.zeros(0)
        rhos_c = np.asarray([0.5]) if cur_order == 1 else np.linalg.solve(R, b)
        out["ratio"][i] = sig[i + 1] / sig[i]
        out["phi1"][i] = h_phi_1
        out["bh"][i] = b_h
        for k in range(cur_order - 1):
            out["cp"][i, k] = (rhos_p[k] / rk_vals[k]) if k < len(rhos_p) else 0.0
            out["cc"][i, k] = rhos_c[k] / rk_vals[k]
        out["cc_new"][i] = rhos_c[-1]
        out["use_corr"][i] = 0.0 if i == n - 1 else 1.0
    return {k: v.astype(np.float32) for k, v in out.items()}


def _unipc_sum(weights, ms: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """Σ w[k]·(m_{k+1} − m₀) over the history there is and the nonzero weights."""
    out = None
    for w, m in zip(weights, ms[1:]):
        if w != 0:
            term = (m - ms[0]) * float(w)
            out = term if out is None else out + term
    return out


@torch.no_grad()
def sample_unipc(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
                 noise: Optional[torch.Tensor] = None, order: int = _UNIPC_ORDER) -> torch.Tensor:
    sig = np.asarray(sigmas, np.float32)
    n = len(sig) - 1
    cf = _unipc_coeffs(sig, order)
    ms = [model_fn(x, sig[0])]  # x0 history, newest first
    for i in range(n):
        x_t_ = x * float(cf["ratio"][i]) - ms[0] * float(cf["phi1"][i])
        pred = _unipc_sum(cf["cp"][i], ms)
        x_pred = x_t_ if pred is None else x_t_ - pred * float(cf["bh"][i])
        if i == n - 1:  # the final step: predictor only, no model call, no corrector
            return x_pred
        m_t = model_fn(x_pred, np.maximum(sig[i + 1], F(1e-8)))
        corr = (m_t - ms[0]) * float(cf["cc_new"][i])
        prev = _unipc_sum(cf["cc"][i], ms)
        x = x_t_ - (corr if prev is None else prev + corr) * float(cf["bh"][i])
        ms = [m_t] + ms[:order - 1]
    return x


# ---------------------------------------------------------------------------
# registry


@dataclasses.dataclass(frozen=True)
class SamplerInfo:
    fn: Callable
    noise_draws: int = 0          # gaussian draws per step
    uses_ensd: bool = False       # eta-noise-seed-delta reseeds the step noise
    discard_next_to_last_sigma: bool = False
    second_order: bool = False
    default_eta: float = 1.0
    brownian_noise: bool = False  # the step noise comes from a Brownian tree
    needs_uncond: bool = False    # CFG++ family: model_fn returns (x0, uncond x0)
    cfg_multiplier: float = 1.0   # CFG++ maps the scale to [0,1] (the reference's /12.5)
    uses_eta_ddim: bool = False   # timestep samplers take eta from eta_ddim
    aliases: tuple = ()


SAMPLERS: Dict[str, SamplerInfo] = {
    "Euler a": SamplerInfo(sample_euler_ancestral, 1, uses_ensd=True, aliases=("k_euler_a", "euler_ancestral")),
    "Euler": SamplerInfo(sample_euler, 0, aliases=("k_euler", "euler")),
    "LMS": SamplerInfo(sample_lms, 0, aliases=("k_lms", "lms")),
    "Heun": SamplerInfo(sample_heun, 0, second_order=True, aliases=("k_heun", "heun")),
    "DPM2": SamplerInfo(sample_dpm_2, 0, discard_next_to_last_sigma=True, second_order=True, aliases=("k_dpm_2", "dpm_2")),
    "DPM2 a": SamplerInfo(sample_dpm_2_ancestral, 1, uses_ensd=True, discard_next_to_last_sigma=True, second_order=True, aliases=("k_dpm_2_a", "dpm_2_ancestral")),
    "DPM++ 2S a": SamplerInfo(sample_dpmpp_2s_ancestral, 1, uses_ensd=True, second_order=True, aliases=("k_dpmpp_2s_a", "dpmpp_2s_ancestral")),
    "DPM++ 2M": SamplerInfo(sample_dpmpp_2m, 0, aliases=("k_dpmpp_2m", "dpmpp_2m")),
    "DPM++ SDE": SamplerInfo(sample_dpmpp_sde, 2, second_order=True, brownian_noise=True, aliases=("k_dpmpp_sde", "dpmpp_sde")),
    "DPM++ 2M SDE": SamplerInfo(sample_dpmpp_2m_sde, 1, brownian_noise=True, aliases=("k_dpmpp_2m_sde", "dpmpp_2m_sde")),
    "DPM++ 2M SDE Heun": SamplerInfo(partial(sample_dpmpp_2m_sde, solver_type="heun"), 1, brownian_noise=True, aliases=("k_dpmpp_2m_sde_heun",)),
    "DPM++ 3M SDE": SamplerInfo(sample_dpmpp_3m_sde, 1, brownian_noise=True, aliases=("k_dpmpp_3m_sde", "dpmpp_3m_sde")),
    "LCM": SamplerInfo(sample_lcm, 1, uses_ensd=True, aliases=("lcm",)),
    "DDIM": SamplerInfo(sample_ddim, 0, uses_eta_ddim=True, aliases=("ddim",)),
    "DDIM CFG++": SamplerInfo(sample_ddim_cfgpp, 0, uses_eta_ddim=True, needs_uncond=True,
                              cfg_multiplier=1 / 12.5, aliases=("ddim_cfgpp",)),
    "PLMS": SamplerInfo(sample_plms, 0, aliases=("plms",)),
    "UniPC": SamplerInfo(sample_unipc, 0, aliases=("unipc",)),
    "Heun++2": SamplerInfo(sample_heunpp2, 0, second_order=True, aliases=("heunpp2", "k_heunpp2")),
    "ipndm": SamplerInfo(sample_ipndm, 0, aliases=("k_ipndm",)),
    "ipndm_v": SamplerInfo(sample_ipndm_v, 0, aliases=("k_ipndm_v",)),
    "DEIS": SamplerInfo(sample_deis, 0, aliases=("k_deis", "deis")),
    "DPM fast": SamplerInfo(sample_dpm_fast, 0, uses_ensd=True, aliases=("k_dpm_fast", "dpm_fast")),
    "DPM adaptive": SamplerInfo(sample_dpm_adaptive, 0, uses_ensd=True, aliases=("k_dpm_ad", "dpm_adaptive")),
    "Restart": SamplerInfo(sample_restart, 1, second_order=True, aliases=("restart",)),
    "DDPM": SamplerInfo(sample_ddpm, 1, uses_ensd=True, aliases=("ddpm",)),
}


def get_sampler(name: str) -> SamplerInfo:
    if name in SAMPLERS:
        return SAMPLERS[name]
    for canonical, info in SAMPLERS.items():
        if name in info.aliases or name.lower() == canonical.lower():
            return info
    raise KeyError(f"unknown sampler {name!r}")

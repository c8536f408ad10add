"""Dynamic Thresholding (mcmonkeyprojects/sd-dynamic-thresholding; port of
forge_tpu/extensions/dynamic_thresholding.py): the CFG combine at the
request's scale, its per-channel variability clamped and rescaled to what a
lower "mimic" scale would give. A `cfg_combine_fn`; the schedule modes take
the step's fraction from σ's position in the pass's σ table, found on the
host (sampling/cfg.py `step_index`). Statistics are
the reference's: ddof-0 std, linear quantiles."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..sampling.cfg import step_index

MODES = ["Constant", "Linear Down", "Cosine Down", "Half Cosine Down",
         "Linear Up", "Cosine Up", "Half Cosine Up", "Power Up", "Power Down",
         "Linear Repeating", "Cosine Repeating", "Sawtooth"]


def _interpret_scale(scale: float, mode: str, minimum: float, frac: float,
                     sched_val: float) -> float:
    """The per-step scale schedule (dynthres_core.py:29-57), frac in [0, 1]."""
    scale = scale - minimum
    if mode == "Constant":
        pass
    elif mode == "Linear Down":
        scale = scale * (1.0 - frac)
    elif mode == "Half Cosine Down":
        scale = scale * math.cos(frac)
    elif mode == "Cosine Down":
        scale = scale * math.cos(frac * 1.5707)
    elif mode == "Linear Up":
        scale = scale * frac
    elif mode == "Half Cosine Up":
        scale = scale * (1.0 - math.cos(frac))
    elif mode == "Cosine Up":
        scale = scale * (1.0 - math.cos(frac * 1.5707))
    elif mode == "Power Up":
        scale = scale * frac ** sched_val
    elif mode == "Power Down":
        scale = scale * (1.0 - frac ** sched_val)
    elif mode == "Linear Repeating":
        portion = (frac * sched_val) % 1.0
        scale = scale * ((0.5 - portion) * 2 if portion < 0.5 else (portion - 0.5) * 2)
    elif mode == "Cosine Repeating":
        scale = scale * (math.cos(frac * 6.28318 * sched_val) * 0.5 + 0.5)
    elif mode == "Sawtooth":
        scale = scale * ((frac * sched_val) % 1.0)
    else:
        raise ValueError(f"unknown dynthresh mode {mode!r}")
    return scale + minimum


def step_fraction(sigmas_np: Optional[np.ndarray], sigma) -> float:
    """σ's step in the σ table over (steps − 1), in float32; 0 without a
    table or for a one-step pass."""
    if sigmas_np is None or len(sigmas_np) <= 2:
        return 0.0
    return float(np.float32(step_index(sigmas_np, sigma)) / np.float32(len(sigmas_np) - 2))


def build_dynthresh_cfg_fn(mimic_scale: float = 7.0, threshold_percentile: float = 1.0,
                           mimic_mode: str = "Constant", mimic_scale_min: float = 0.0,
                           cfg_mode: str = "Constant", cfg_scale_min: float = 0.0,
                           sched_val: float = 1.0, separate_feature_channels: bool = True,
                           scaling_startpoint: str = "MEAN", variability_measure: str = "AD",
                           interpolate_phi: float = 1.0,
                           sigmas_np: Optional[np.ndarray] = None) -> Callable:
    """→ cfg_combine_fn(eps_cond, eps_uncond, x, σ, cfg_scale), the math of
    dynthres_core.py:59-125 on the x0 predictions (NCHW)."""

    def combine(eps_cond, eps_uncond, x, sigma, cfg_scale):
        frac = step_fraction(sigmas_np, sigma)
        mim = _interpret_scale(float(mimic_scale), mimic_mode, mimic_scale_min, frac, sched_val)
        cfg = _interpret_scale(float(cfg_scale), cfg_mode, cfg_scale_min, frac, sched_val)
        relative = (eps_cond - eps_uncond).float()
        uncond = eps_uncond.float()
        mim_target = uncond + relative * mim
        cfg_target = uncond + relative * cfg
        b, c = mim_target.shape[:2]
        mim_flat = mim_target.reshape(b, c, -1)
        cfg_flat = cfg_target.reshape(b, c, -1)
        mim_means = mim_flat.mean(dim=2, keepdim=True)
        cfg_means = cfg_flat.mean(dim=2, keepdim=True)
        mim_centered = mim_flat - mim_means
        cfg_centered = cfg_flat - cfg_means
        if separate_feature_channels:
            if variability_measure == "STD":
                mim_ref = mim_centered.std(dim=2, keepdim=True, correction=0)
                cfg_ref = cfg_centered.std(dim=2, keepdim=True, correction=0)
            else:  # AD
                mim_ref = mim_centered.abs().amax(dim=2, keepdim=True)
                cfg_ref = torch.quantile(cfg_centered.abs(), threshold_percentile, dim=2,
                                         keepdim=True)
        elif variability_measure == "STD":
            mim_ref = mim_centered.std(correction=0)
            cfg_ref = cfg_centered.std(correction=0)
        else:
            mim_ref = mim_centered.abs().amax()
            cfg_ref = torch.quantile(cfg_centered.abs().reshape(-1), threshold_percentile)
        if scaling_startpoint == "ZERO":
            result = cfg_flat * (mim_ref / cfg_ref.clamp_min(1e-12))
        elif variability_measure == "STD":  # MEAN
            result = (cfg_centered / cfg_ref.clamp_min(1e-12)) * mim_ref + cfg_means
        else:
            max_ref = torch.maximum(mim_ref, cfg_ref)
            clamped = torch.minimum(torch.maximum(cfg_centered, -max_ref), max_ref)
            result = (clamped / max_ref.clamp_min(1e-12)) * mim_ref + cfg_means
        out = result.reshape(mim_target.shape)
        if interpolate_phi != 1.0:
            out = out * interpolate_phi + cfg_target * (1.0 - interpolate_phi)
        return out.to(eps_cond.dtype)

    return combine


@dataclasses.dataclass(frozen=True)
class DynThreshSpec:
    """A deferred `cfg_combine_hook`: the request's pass builds it against
    its own σ table (`.build(sigmas_np, predictor=)`)."""

    mimic_scale: float = 7.0
    threshold_percentile: float = 1.0
    mimic_mode: str = "Constant"
    mimic_scale_min: float = 0.0
    cfg_mode: str = "Constant"
    cfg_scale_min: float = 0.0
    sched_val: float = 1.0
    separate_feature_channels: bool = True
    scaling_startpoint: str = "MEAN"
    variability_measure: str = "AD"
    interpolate_phi: float = 1.0

    def build(self, sigmas_np, predictor=None) -> Callable:
        return build_dynthresh_cfg_fn(sigmas_np=sigmas_np, **dataclasses.asdict(self))


def attach(p, args: dict) -> None:
    """The reference's wiring (scripts/forge_dynamic_thresholding.py:45):
    the spec from `args`' known keys, and the infotext's keys."""
    known = {f.name for f in dataclasses.fields(DynThreshSpec)}
    p.cfg_combine_hook = DynThreshSpec(**{k: v for k, v in args.items() if k in known})
    p.extra_generation_params["Dynamic thresholding enabled"] = "True"
    p.extra_generation_params["Mimic scale"] = args.get("mimic_scale", 7.0)
    p.extra_generation_params["Threshold percentile"] = args.get("threshold_percentile", 1.0)

"""Latent Mega Modifier (port of forge_tpu/extensions/latent_modifier.py,
itself of sd_forge_latent_modifier's mega_modify): a `cfg_combine_fn` that
sharpens the cond's x0 (Gaussian or CAS), tonemaps or contrasts the
difference cond − uncond, rescales the CFG result (phi) and combats CFG
drift, each weighted by 1 − t (t = timestep/999 from the predictor, or the
step's place in the σ table without one).

NCHW: channels are dim 1. The statistics are the reference's: ddof-0 std,
the median as the mean of the two middle values (`torch.quantile` at 0.5),
linear quantiles. "subtract_channels" centres latent channel 0, where the
reference's raises (see `_center_0channel`). The extra noise ("gaussian" or
"uniform", "add" or "speckle") is the reference's JAX threefry draw from
fold_in(PRNGKey(seed), step), made on the host by ops/threefry.py in the
reference's NHWC shape [B, H, W, C] and then taken to NCHW; the step is the
call's `step_index` in the host σ table, so no step waits on the card. The
noise types the reference does not port (perlin, pink, green) raise
ValueError, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import threefry
from ..sampling.cfg import step_index
from .sag import gaussian_blur_2d


def _cas(img: torch.Tensor, amount: float) -> torch.Tensor:
    """Contrast-adaptive sharpening (sampler_mega_modifier.py:26-66), NCHW."""
    pad = F.pad(img, (1, 1, 1, 1), mode="replicate")
    a, b, c = pad[..., :-2, :-2], pad[..., :-2, 1:-1], pad[..., :-2, 2:]
    d, e, f = pad[..., 1:-1, :-2], pad[..., 1:-1, 1:-1], pad[..., 1:-1, 2:]
    g, h, i = pad[..., 2:, :-2], pad[..., 2:, 1:-1], pad[..., 2:, 2:]
    mn = torch.minimum(torch.minimum(torch.minimum(b, d), torch.minimum(e, f)), h)
    mx = torch.maximum(torch.maximum(torch.maximum(b, d), torch.maximum(e, f)), h)
    mn = mn + torch.minimum(torch.minimum(a, c), torch.minimum(g, i))
    mx = mx + torch.maximum(torch.maximum(a, c), torch.maximum(g, i))
    amp = torch.sqrt(torch.clamp(torch.minimum(mn, 2.0 - mx) * (1.0 / (mx + 1e-8)), 0, 1))
    w = -amp * (amount * (0.125 - 0.075) + 0.075)
    return ((b * w + d * w + f * w + h * w + e) * (1.0 / (1.0 + 4.0 * w))).to(img.dtype)


def _center_perchannel(t):
    return t - t.mean(dim=(2, 3), keepdim=True)


def _center_0channel(t):
    """Latent channel 0 centred, the others kept. The reference concatenates
    channel 0's [B, 1, 1, 1] mean with the other channels' [B, H, W, 3]
    zeros, which raises: its "subtract_channels" never runs."""
    mean0 = t[:, :1].mean(dim=(2, 3), keepdim=True)
    return t - torch.cat([mean0.expand_as(t[:, :1]), torch.zeros_like(t[:, 1:])], dim=1)


def _center_median(t):
    med = torch.quantile(t.reshape(t.shape[0], -1), 0.5, dim=1)
    return t - med[:, None, None, None]


def _channel_sharpen(t):
    return t + (t - gaussian_blur_2d(t))


_COMBAT = {"subtract": _center_perchannel, "subtract_channels": _center_0channel,
           "subtract_median": _center_median, "sharpen": _channel_sharpen}


@dataclasses.dataclass(frozen=True)
class LatentModifierSpec:
    sharpness_multiplier: float = 0.0
    sharpness_method: str = "gaussian"
    tonemap_multiplier: float = 0.0
    tonemap_method: str = "reinhard"
    tonemap_percentile: float = 100.0
    contrast_multiplier: float = 0.0
    combat_method: str = "subtract"
    combat_cfg_drift: float = 0.0
    rescale_cfg_phi: float = 0.0
    extra_noise_type: str = "gaussian"
    extra_noise_method: str = "add"
    extra_noise_multiplier: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.extra_noise_multiplier and self.extra_noise_type not in ("gaussian", "uniform"):
            raise ValueError(f"extra noise type {self.extra_noise_type!r} not ported "
                             "(perlin/pink/green need host RNG)")

    def build(self, sigmas_np, predictor=None) -> Callable:
        return build_latent_modifier_cfg_fn(self, sigmas_np, predictor)


def build_latent_modifier_cfg_fn(spec: LatentModifierSpec,
                                 sigmas_np: Optional[np.ndarray] = None,
                                 predictor=None) -> Callable:
    """→ cfg_combine_fn(x0_cond, x0_uncond, x, σ, cfg_scale)."""
    key0 = threefry.prng_key(spec.seed)

    def extra_noise(shape, sigma, device) -> torch.Tensor:
        """The step's draw, [B, C, H, W] from the reference's NHWC layout."""
        b, c, h, w = shape
        key = threefry.fold_in(key0, step_index(sigmas_np, sigma) if sigmas_np is not None else 0)
        if spec.extra_noise_type == "gaussian":
            noise = threefry.normal(key, (b, h, w, c))
        else:  # uniform
            noise = ((threefry.uniform(key, (b, h, w, c)) - np.float32(0.5)) * np.float32(2)
                     * np.float32(1.73))
        return torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))).to(device)

    def step_t(sigma) -> float:
        if predictor is not None:
            return float(np.clip(np.float32(predictor.timestep(np.float32(sigma)))
                                 / np.float32(999.0), 0.0, 1.0))
        if sigmas_np is not None:
            last = np.float32(max(len(sigmas_np) - 2, 1))
            return float(np.float32(1.0) - np.float32(step_index(sigmas_np, sigma)) / last)
        return 0.5

    def combine(x0_cond, x0_uncond, x, sigma, cfg_scale):
        cond = x0_cond.float()
        uncond = x0_uncond.float()
        alpha_t = 1.0 - step_t(sigma)  # low at high noise (sampler_mega_modifier.py:963)
        if spec.extra_noise_multiplier:
            noise = extra_noise(tuple(cond.shape), sigma, cond.device)
            a = alpha_t * 0.001 * spec.extra_noise_multiplier
            if spec.extra_noise_method == "speckle":
                cond = cond + cond * noise * a
                uncond = uncond - uncond * noise * a
            else:  # add
                cond = cond + noise * a
                uncond = uncond - noise * a
        if spec.sharpness_multiplier:
            if spec.sharpness_method == "cas":
                degraded = _cas(cond, float(np.clip(np.float32(sigma), 0.0, 1.0)))
            else:  # gaussian
                degraded = gaussian_blur_2d(cond)
            a = alpha_t * 0.001 * spec.sharpness_multiplier
            cond = degraded * a + cond * (1.0 - a)
        pred = cond - uncond
        if spec.tonemap_multiplier:
            pred = _tonemap(spec, pred, uncond, cfg_scale)
        if spec.contrast_multiplier:
            a = alpha_t * 0.001 * spec.contrast_multiplier
            std = pred.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-8
            pred = (pred / std) * a + pred * (1.0 - a)
        x_final = uncond + pred * cfg_scale
        if spec.rescale_cfg_phi:
            ro_pos = cond.std(dim=(1, 2, 3), keepdim=True, correction=0)
            ro_cfg = x_final.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-8
            x_final = (spec.rescale_cfg_phi * (x_final * ro_pos / ro_cfg)
                       + (1.0 - spec.rescale_cfg_phi) * x_final)
        if spec.combat_cfg_drift:
            a = float(np.clip(alpha_t, 0.0, 1.0)) * spec.combat_cfg_drift
            x_final = _COMBAT[spec.combat_method](x_final) * a + x_final * (1.0 - a)
        return x_final.to(x0_cond.dtype)

    return combine


def _tonemap(spec: LatentModifierSpec, pred, uncond, cfg_scale):
    m, pct = spec.tonemap_multiplier, spec.tonemap_percentile
    b, c, h, w = pred.shape
    if spec.tonemap_method == "reinhard":
        mag = torch.linalg.vector_norm(pred, dim=1, keepdim=True) + 1e-10
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True, correction=0)
        top = (std * 3 * (100 / pct) + mean) * m
        scaled = mag / top
        return (pred / mag) * (scaled / (scaled + 1.0) * top)
    if spec.tonemap_method == "reinhard_perchannel":
        flat = pred.reshape(b, c, -1)
        mag = torch.linalg.vector_norm(flat, dim=2, keepdim=True) + 1e-10
        top = (3 * (100 / pct) + mag.mean(dim=2, keepdim=True)) * m
        scaled = mag / top
        return ((flat / mag) * (scaled / (scaled + 1.0) * top)).reshape(b, c, h, w)
    if spec.tonemap_method == "arctan":
        mag = torch.linalg.vector_norm(pred, dim=1, keepdim=True) + 1e-10
        unit = pred / mag
        return (torch.arctan(unit * m) / m + unit * (100 - pct) / 100) * mag
    if spec.tonemap_method == "quantile":
        s = torch.quantile((uncond + pred * cfg_scale).abs().reshape(b, -1), pct / 100, dim=-1) * m
        s = s.clamp_min(1.0)[:, None, None, None]
        return torch.minimum(torch.maximum(pred, -s), s) / s
    if spec.tonemap_method == "cfg-mimic":
        flat = pred.reshape(b, c, -1)
        mimic = flat * m
        mimic_mean = mimic.mean(dim=2, keepdim=True)
        mimic_max = (mimic - mimic_mean).abs().amax(dim=2, keepdim=True)
        lat_q = torch.quantile((flat - flat.mean(dim=2, keepdim=True)).abs(), pct / 100, dim=2,
                               keepdim=True)
        s = torch.maximum(lat_q, mimic_max) + 1e-10
        out = torch.minimum(torch.maximum(flat, -s), s) / s * mimic_max + mimic_mean
        return out.reshape(b, c, h, w)
    if spec.tonemap_method == "spatial-norm":
        s = torch.sqrt((pred * pred).mean(dim=(1, 2, 3), keepdim=True))
        value = m / 2 / cfg_scale
        return pred * (value / s.clamp_min(value))
    raise ValueError(f"unknown tonemap method {spec.tonemap_method!r}")


def attach(p, args: dict) -> None:
    """The spec from `args`' known keys as the request's `cfg_combine_hook`,
    and the infotext's keys."""
    known = {f.name for f in dataclasses.fields(LatentModifierSpec)}
    spec = LatentModifierSpec(**{k: v for k, v in args.items() if k in known})
    p.cfg_combine_hook = spec
    if spec.tonemap_multiplier:
        p.extra_generation_params["Tonemap multiplier"] = spec.tonemap_multiplier
        p.extra_generation_params["Tonemap method"] = spec.tonemap_method
    if spec.sharpness_multiplier:
        p.extra_generation_params["Sharpness multiplier"] = spec.sharpness_multiplier

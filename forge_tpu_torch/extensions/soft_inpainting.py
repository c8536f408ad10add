"""Soft inpainting (port of forge_tpu/extensions/soft_inpainting.py):
continuous-opacity mask blending during sampling.

Instead of the hard per-step latent composite (mask 0/1), the original and
denoised latents are blended with a σ-dependent transparency
    t = mask ** (σ^power · scale)                  (get_modified_nmask)
and the blend keeps detail by interpolating the vectors' magnitudes raised to
`inpaint_detail_preservation` apart from their directions (latent_blend).

The model function is wrapped in place of the masked one (the request's
`soft_inpainting` settings, pipeline/processing.py `cfg_model_fn`); with
CFG++ it still returns (blended, uncond). Latents are NCHW: the channel norm
is over dim 1, where forge_tpu's NHWC takes the last axis. The blend runs in
float32 whatever the latent's dtype (forge_tpu's norms are f32 unless JAX's
x64 is on), then casts back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass(frozen=True)
class SoftInpaintingSettings:
    """reference soft_inpainting.py:12-37 (infotext keys :27-36)."""

    mask_blend_power: float = 1.0
    mask_blend_scale: float = 0.5
    inpaint_detail_preservation: float = 4.0
    composite_mask_influence: float = 0.0
    composite_difference_threshold: float = 0.5
    composite_difference_contrast: float = 2.0

    def add_generation_params(self, dest: Dict[str, Any]) -> None:
        dest["Soft inpainting"] = "True"
        dest["Soft inpainting schedule bias"] = self.mask_blend_power
        dest["Soft inpainting preservation strength"] = self.mask_blend_scale
        dest["Soft inpainting transition contrast boost"] = self.inpaint_detail_preservation


def get_modified_nmask(settings: SoftInpaintingSettings, nmask: torch.Tensor,
                       sigma) -> torch.Tensor:
    """σ-scheduled transparency: early (high σ) the denoiser dominates
    inside the mask; late steps converge to the original outside it."""
    return torch.pow(nmask, (sigma ** settings.mask_blend_power) * settings.mask_blend_scale)


def latent_blend(settings: SoftInpaintingSettings, a: torch.Tensor, b: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Magnitude-preserving interpolation of NCHW latents: lerp the vectors,
    then rescale so each pixel's channel norm follows a power mean of the two
    inputs' norms, with the first channel of `t` as the pixel's opacity."""
    t2 = t if t.ndim == b.ndim else t[:, None]
    t3 = t2[:, :1]
    image_interp = a * (1.0 - t2) + b * t2
    current_mag = torch.linalg.vector_norm(image_interp.float(), dim=1, keepdim=True) + 1e-5
    dp = settings.inpaint_detail_preservation
    a_mag = torch.linalg.vector_norm(a.float(), dim=1, keepdim=True) ** dp
    b_mag = torch.linalg.vector_norm(b.float(), dim=1, keepdim=True) ** dp
    desired_mag = (a_mag * (1.0 - t3) + b_mag * t3) ** (1.0 / dp)
    return image_interp * (desired_mag / current_mag).to(image_interp.dtype)


def make_soft_masked_model_fn(model_fn: Callable, nmask: torch.Tensor, init_latent: torch.Tensor,
                              settings: SoftInpaintingSettings) -> Callable:
    """The soft variant of the inpainting composite: the per-step σ-scheduled
    blend instead of the hard one. nmask: 1 = repaint, 0 = keep the original."""

    def wrapped(x: torch.Tensor, sigma):
        x0 = model_fn(x, sigma)
        pair = isinstance(x0, tuple)
        if pair:
            x0, un = x0
        t = get_modified_nmask(settings, nmask, float(sigma))
        blended = latent_blend(settings, init_latent.float(), x0.float(), t).to(x0.dtype)
        return (blended, un) if pair else blended

    return wrapped


def attach(p, args: Dict[str, Any]) -> None:
    """alwayson_scripts wiring: {"Soft inpainting": true, "Schedule bias": 1,
    "Preservation strength": 0.5, "Transition contrast boost": 4} (reference
    el() UI arg names, soft_inpainting.py:543-704) or snake_case keys."""
    def pick(*names, default):
        for n in names:
            if n in args:
                return float(args[n])
        return default

    settings = SoftInpaintingSettings(
        mask_blend_power=pick("mask_blend_power", "Schedule bias", default=1.0),
        mask_blend_scale=pick("mask_blend_scale", "Preservation strength", default=0.5),
        inpaint_detail_preservation=pick("inpaint_detail_preservation",
                                         "Transition contrast boost", default=4.0),
        composite_mask_influence=pick("composite_mask_influence", "Mask influence", default=0.0),
        composite_difference_threshold=pick("composite_difference_threshold",
                                            "Difference threshold", default=0.5),
        composite_difference_contrast=pick("composite_difference_contrast",
                                           "Difference contrast", default=2.0),
    )
    p.soft_inpainting = settings
    settings.add_generation_params(p.extra_generation_params)

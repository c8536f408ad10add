"""CFG executor: builds the `model_fn(x, σ) → denoised` the samplers integrate
(port of forge_tpu/sampling/cfg.py, single cond branch, the CFG++ pair and
the inpainting latent composite).

cond and uncond are fused into ONE model call by batch concatenation, and
the uncond branch is skipped entirely when it is None (cfg == 1). Hooks,
AND-composed branches and CFG rescale are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch


def make_apply_model(net_apply: Callable, params: Any, predictor,
                     compute_dtype: torch.dtype) -> Callable:
    """KModel equivalent: σ-space wrapper around a raw network.

    net_apply(params, x, timesteps, **cond) returns the raw prediction;
    the result is apply(x, σ, cond) → x0 in f32. σ is a host scalar. A
    net_apply marked `takes_host_timestep` also gets the timestep as a host
    float, `t_host` (the ControlNets' schedule gate reads it)."""
    host_t = getattr(net_apply, "takes_host_timestep", False)

    def apply(x: torch.Tensor, sigma, cond: Mapping[str, torch.Tensor]) -> torch.Tensor:
        sigma = float(np.float32(sigma))
        xf = x.float()
        xi = predictor.calculate_input(sigma, xf)
        t = float(predictor.timestep(np.float32(sigma)))
        ts = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        extra = {"t_host": t} if host_t else {}
        out = net_apply(params, xi.to(compute_dtype), ts, **cond, **extra)
        return predictor.calculate_denoised(sigma, out.float(), xf)

    return apply


def make_cfg_model_fn(apply_model: Callable, cond: Mapping[str, torch.Tensor],
                      uncond: Optional[Mapping[str, torch.Tensor]],
                      cfg_scale: float, return_uncond: bool = False) -> Callable:
    """model_fn(x, σ) for the samplers; uncond=None skips the uncond branch.
    With `return_uncond` (the CFG++ samplers) it returns the pair (x0, the
    uncond's x0), and (x0, x0) where the uncond is skipped."""
    if uncond is None:
        def model_fn_cond(x: torch.Tensor, sigma):
            denoised = apply_model(x, sigma, cond)
            return (denoised, denoised) if return_uncond else denoised

        return model_fn_cond
    both = {k: torch.cat([cond[k], uncond[k]], dim=0) for k in cond}

    def model_fn(x: torch.Tensor, sigma):
        out = apply_model(torch.cat([x, x], dim=0), sigma, both)
        eps_cond, eps_uncond = out.chunk(2, dim=0)
        x0 = eps_uncond + cfg_scale * (eps_cond - eps_uncond)
        return (x0, eps_uncond) if return_uncond else x0

    return model_fn


def make_masked_pair_fn(pair_fn: Callable, mask: torch.Tensor,
                        init_latent: torch.Tensor) -> Callable:
    """The inpainting composite for a pair-returning (CFG++) model_fn: the
    x0 prediction is blended, the uncond direction term passes through."""

    def wrapped(x: torch.Tensor, sigma):
        x0, un = pair_fn(x, sigma)
        return init_latent * (1.0 - mask) + x0 * mask, un

    return wrapped


def make_masked_model_fn(model_fn: Callable, mask: torch.Tensor,
                         init_latent: torch.Tensor) -> Callable:
    """Inpainting latent composite (reference sd_samplers_cfg_denoiser.py:
    178-181, 204-213): after each denoise the model's x0 is blended with the
    original latent under the latent mask, 1 → regenerate, 0 → keep."""

    def wrapped(x: torch.Tensor, sigma) -> torch.Tensor:
        x0 = model_fn(x, sigma)
        return init_latent * (1.0 - mask) + x0 * mask

    return wrapped

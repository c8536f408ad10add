"""CFG executor: builds the `model_fn(x, σ) → denoised` the samplers integrate
(port of forge_tpu/sampling/cfg.py, single cond branch).

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
    the result is apply(x, σ, cond) → x0 in f32. σ is a host scalar."""

    def apply(x: torch.Tensor, sigma, cond: Mapping[str, torch.Tensor]) -> torch.Tensor:
        sigma = float(np.float32(sigma))
        xf = x.float()
        xi = predictor.calculate_input(sigma, xf)
        t = float(predictor.timestep(np.float32(sigma)))
        ts = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        out = net_apply(params, xi.to(compute_dtype), ts, **cond)
        return predictor.calculate_denoised(sigma, out.float(), xf)

    return apply


def make_cfg_model_fn(apply_model: Callable, cond: Mapping[str, torch.Tensor],
                      uncond: Optional[Mapping[str, torch.Tensor]],
                      cfg_scale: float) -> Callable:
    """model_fn(x, σ) for the samplers; uncond=None skips the uncond branch."""
    if uncond is None:
        return lambda x, sigma: apply_model(x, sigma, cond)
    both = {k: torch.cat([cond[k], uncond[k]], dim=0) for k in cond}

    def model_fn(x: torch.Tensor, sigma) -> torch.Tensor:
        out = apply_model(torch.cat([x, x], dim=0), sigma, both)
        eps_cond, eps_uncond = out.chunk(2, dim=0)
        return eps_uncond + cfg_scale * (eps_cond - eps_uncond)

    return model_fn

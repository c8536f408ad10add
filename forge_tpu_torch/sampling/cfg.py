"""CFG executor: builds the `model_fn(x, σ) → denoised` the samplers integrate
(port of forge_tpu/sampling/cfg.py: per-step conds for prompt editing, AND
and regional branches, CFG rescale, the CFG hook layer, the CFG++ pair and
the inpainting latent composite).

cond, its branches and the uncond are fused into ONE model call by batch
concatenation, and the uncond branch is skipped entirely when it is None
(cfg == 1, the NGMS tail). The CFG hook layer, in the reference's order:
`pre_cfg_hooks` fn(eps_c, eps_u, x, σ) → (eps_c, eps_u), then
`cfg_combine_fn` fn(eps_c, eps_u, x, σ, cfg) → x0 in place of the CFG
combine, then the rescale, then `post_cfg_hooks` fn(x0, eps_c, eps_u, x, σ)
→ x0. The "eps" are the branches' x0 predictions (NCHW) and σ is a host
float. Without an uncond only the post hooks run, on (x0, eps, eps).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

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


class PerStep:
    """Step-scheduled conditioning (prompt editing `[a:b:N]`): `array` has a
    leading [n_steps] axis, stacked once on the device, and the row a call
    takes is selected by the host σ's position in the pass's σ table."""

    def __init__(self, array: torch.Tensor):
        self.array = array


def step_index(sigmas_np, sigma) -> int:
    """The step of a pass whose σ interval holds σ: searchsorted on −σ in
    float32, side "right", less 1, clipped to [0, len(σ) − 2], as the
    reference finds it on the card. σ and the table are host values: this
    waits on nothing."""
    table = -np.asarray(sigmas_np[:-1], np.float32)
    return int(np.clip(np.searchsorted(table, -np.float32(sigma), side="right") - 1,
                       0, len(sigmas_np) - 2))


def _select_cond(cond: Mapping[str, Any], sigma, sigmas_np) -> Dict[str, torch.Tensor]:
    """The cond for the call at σ: a PerStep value's row for σ's
    `step_index`, clamped to its last row as `jax.lax.dynamic_index_in_dim`
    clamps; row 0 without a σ table."""
    if sigmas_np is None or not any(isinstance(v, PerStep) for v in cond.values()):
        return {k: (v.array[0] if isinstance(v, PerStep) else v) for k, v in cond.items()}
    idx = step_index(sigmas_np, sigma)
    return {k: (v.array[min(idx, v.array.shape[0] - 1)] if isinstance(v, PerStep) else v)
            for k, v in cond.items()}


def _rescale(x0: torch.Tensor, eps_cond: torch.Tensor, cfg_rescale: float) -> torch.Tensor:
    """RescaleCFG (arXiv:2305.08891): the CFG result's per-image std matched
    to the cond branch's, mixed in by `cfg_rescale`."""
    dims = tuple(range(1, x0.ndim))
    std_cond = eps_cond.std(dim=dims, keepdim=True, correction=0)
    std_cfg = x0.std(dim=dims, keepdim=True, correction=0)
    rescaled = x0 * (std_cond / torch.clamp(std_cfg, min=1e-8))
    return cfg_rescale * rescaled + (1 - cfg_rescale) * x0


def make_cfg_model_fn(apply_model: Callable, cond: Mapping[str, Any],
                      uncond: Optional[Mapping[str, Any]], cfg_scale: float,
                      cfg_rescale: float = 0.0, sigmas_np=None,
                      cond_branches: Optional[Sequence[Mapping[str, Any]]] = None,
                      branch_weights: Optional[Sequence[float]] = None,
                      branch_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                      return_uncond: bool = False, pre_cfg_hooks: Sequence[Callable] = (),
                      post_cfg_hooks: Sequence[Callable] = (),
                      cfg_combine_fn: Optional[Callable] = None) -> Callable:
    """model_fn(x, σ) for the samplers; uncond=None skips the uncond branch.
    With `return_uncond` (the CFG++ samplers) it returns the pair (x0, the
    uncond's x0), and (x0, x0) where the uncond is skipped. Values of the
    conds may be PerStep (prompt editing), selected against `sigmas_np`.
    `cond_branches` adds AND-composed branches, all in one batched call:
    uncond + cfg·Σ wᵢ(condᵢ − uncond), or with regional `branch_masks`
    (multiplier maps [1, 1, h, w], None for a full-canvas branch) the
    branches blended by mask·weight over their sum, then CFG against the
    uncond. `cfg_rescale` > 0 rescales the CFG result (not without an uncond).
    The hooks run on the plain and the branched paths alike (see the module);
    without an uncond the pair is (x0, the unhooked x0) on the plain path and
    (x0, x0) on the branched one, as in the reference."""
    branches = [cond] + list(cond_branches or [])
    weights = list(branch_weights or [1.0] * len(branches))
    conds = branches + ([uncond] if uncond is not None else [])
    n = len(conds)
    mults = None
    if branch_masks and any(m is not None for m in branch_masks):
        # regional conds: every branch runs on the whole latent and the
        # results blend by multiplier·weight over their sum (the reference's
        # area crop and normalised accumulation, on the full grid)
        mults = [w if m is None else m.float() * w for m, w in zip(branch_masks, weights)]
        denom = torch.clamp(sum(mults), min=1e-6)
    single = len(branches) == 1 and weights[0] == 1.0 and mults is None

    def batched(sel):
        return sel[0] if n == 1 else {k: torch.cat([c[k] for c in sel], dim=0) for k in sel[0]}

    scheduled = any(isinstance(v, PerStep) for c in conds for v in c.values())
    both0 = None if scheduled else batched(conds)

    def model_fn(x: torch.Tensor, sigma):
        both = both0
        if both is None:
            both = batched([_select_cond(c, sigma, sigmas_np) for c in conds])
        out = apply_model(x if n == 1 else torch.cat([x] * n, dim=0), sigma, both)
        outs = out.chunk(n, dim=0)
        if single:
            eps_eff = outs[0]
        elif mults is not None:
            eps_eff = sum(m * e for m, e in zip(mults, outs[:len(branches)])) / denom
        elif uncond is not None:
            # AND: un + cfg·Σ wᵢ(condᵢ − un), as CFG against an effective cond
            eps_eff = sum(w * e for w, e in zip(weights, outs[:-1]))
            eps_eff = eps_eff - (sum(weights) - 1.0) * outs[-1]
        else:
            total = sum(weights)
            eps_eff = sum((w / total) * e for w, e in zip(weights, outs))
        if uncond is None:
            x0 = eps_eff
            for hook in post_cfg_hooks:
                x0 = hook(x0, eps_eff, eps_eff, x, sigma)
            return (x0, eps_eff if single else x0) if return_uncond else x0
        eps_un = outs[-1]
        for hook in pre_cfg_hooks:
            eps_eff, eps_un = hook(eps_eff, eps_un, x, sigma)
        if cfg_combine_fn is not None:
            x0 = cfg_combine_fn(eps_eff, eps_un, x, sigma, cfg_scale)
        else:
            x0 = eps_un + cfg_scale * (eps_eff - eps_un)
        if cfg_rescale > 0.0:
            x0 = _rescale(x0, eps_eff, cfg_rescale)
        for hook in post_cfg_hooks:
            x0 = hook(x0, eps_eff, eps_un, x, sigma)
        return (x0, eps_un) if return_uncond else x0

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

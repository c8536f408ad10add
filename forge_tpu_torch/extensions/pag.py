"""Perturbed-Attention Guidance (arXiv:2403.17377; port of
forge_tpu/extensions/pag.py): after CFG one more pass at the cond's batch
with every self-attention replaced by its values, and
x0 ← x0 + scale · (x0_cond − x0_perturbed), as a post-CFG hook. The pass
runs the engine's own UNet weights (not a request's LoRA-patched ones), as
the reference's does."""

from __future__ import annotations

from typing import Any, Callable, Mapping

from ..sampling.cfg import make_apply_model


def identity_attn1_hooks() -> Mapping[str, Any]:
    def attn1_identity(q, k, v, extra):
        return v  # the attention map replaced by the identity

    return {"attn1_replace_all": attn1_identity}


def build_pag_post_cfg(engine, cond: Mapping[str, Any], pag_scale: float = 3.0) -> Callable:
    """→ a post-CFG hook; `cond` is `engine.get_learned_conditioning` of the
    prompt at the request's batch (the reference's tests hold batch 1)."""
    apply_perturbed = make_apply_model(engine.unet_apply_fn(hooks=identity_attn1_hooks()),
                                       engine.loaded.unet, engine.predictor,
                                       engine.compute_dtype)

    def post_cfg(x0, eps_cond, eps_uncond, x, sigma):
        return x0 + pag_scale * (eps_cond - apply_perturbed(x, sigma, cond))

    return post_cfg

"""StyleAlign (arXiv:2312.02133; port of forge_tpu/extensions/stylealign.py):
within each CFG half of the batch ([B cond | B uncond]) the images' self-
attention sequences are joined into one, so every image attends to every
other's keys and values: one attention of batch 2 over 2·L tokens for a
batch of 2 with CFG. `strength` blends the shared attention with each
image's own."""

from __future__ import annotations

from typing import Any, Dict

from ..ops.attention import attention


def build_stylealign_hooks(batch_size: int, strength: float = 1.0) -> Dict[str, Any]:
    def attn1_shared(q, k, v, extra):
        heads = extra["n_heads"]
        b, l, c = q.shape
        groups = max(b // max(batch_size, 1), 1)

        def join(t):
            return t.reshape(groups, (b // groups) * l, c)

        shared = attention(join(q), join(k), join(v), heads=heads).reshape(b, l, c)
        if strength > 0.99:
            return shared
        original = attention(q, k, v, heads=heads)
        if strength < 0.01:
            return original
        return (1.0 - strength) * original + strength * shared

    return {"attn1_replace_all": attn1_shared}


def attach(p, args: Dict[str, Any]) -> None:
    """{"shared_attention": true, "strength": 1.0}, the reference's wiring."""
    if not args.get("shared_attention", True):
        return
    strength = float(args.get("strength", 1.0))
    p.unet_hooks = {**(p.unet_hooks or {}), **build_stylealign_hooks(p.batch_size, strength)}
    p.extra_generation_params["StyleAlign enabled"] = "True"
    p.extra_generation_params["StyleAlign strength"] = strength

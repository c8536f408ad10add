"""Stable Diffusion UNet, SD1.5, SD2, SDXL base and refiner and Playground v2.5
(port of forge_tpu/models/unet.py).

A function over the checkpoint's `model.diffusion_model.*` keys, nested by
`.`; activations NCHW. Block structure is discovered from the tree (key
presence), as in the reference: SD1.5's conv `proj_in`/`proj_out` or SD2's
and SDXL's linear ones on [B, HW, C], and SDXL's label embedding of the size
vector `y` added to the timestep embedding. ControlNet residuals come in through
`control`.

`hooks` is the reference's hook manifest (the extension ABI). Its
attention part, for `which` in attn1 (self) and attn2 (cross):
`{which}_context_patch` (fn(ctx_k, ctx_v, {"block"}) → (ctx_k, ctx_v), before
to_k/to_v), `{which}_patch` (fn(q, k, v, extra) → (q, k, v)),
`{which}_replace` (block id → fn(q, k, v, extra) → out, in place of the
attention), `{which}_replace_all` (the same for every block without its own)
and `{which}_output_patch` (fn(out, {"block"}) → out, after to_out). q, k and
v are [B, L, C]. `extra` holds `block` (("input", i), ("middle", 0) or
("output", i)), `n_heads`, `block_index` (the transformer block within its
spatial transformer) and `attn_index`, the transformer block's ordinal in
one forward (0 … 69 for SDXL), the same on every forward.

Its block part, where the reference puts each relative to the ControlNet
residuals, on NCHW tensors (the reference's hooks see NHWC): `x_concat`
(fn(x) → extra latent channels [B or 1, C, h, w], resized bilinearly as
`jax.image.resize` does and tiled to x's batch, concatenated to x before
the stem), `input_block_patch` (fn(h, id) → h, after input block i and its
residual, before the skip is saved), `input_block_patch_after_skip` (the
same after it is saved: the skip does not see it), `middle_block_patch`
(fn(h, ("middle", 0)) → h, after the middle block's residual),
`output_block_patch` (fn(h, skip, id) → (h, skip), after the skip's
residual, before the two are concatenated) and `output_block_patch_after`
(fn(h, id) → h, after output block i). A key this function does not read
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence

import torch

from ..ops import nn
from ..ops.attention import attention
from ..ops.fused_gn_conv import group_norm_silu_conv3x3
from ..ops.resize import resize


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The family's geometry. `unet_apply` reads the heads from it; the
    projections' kind and the label embedding it finds in the tree."""
    context_dim: int = 768
    num_heads: int = 8          # used when head_dim is None (SD1.5)
    head_dim: Optional[int] = None  # 64 for SD2, SDXL and Playground

    @staticmethod
    def for_family(family: str) -> "UNetConfig":
        if family == "sd15":
            return UNetConfig(context_dim=768, num_heads=8)
        if family == "sd20":
            return UNetConfig(context_dim=1024, head_dim=64)
        if family in ("sdxl", "playground"):  # Playground v2.5: SDXL's geometry under EDM
            return UNetConfig(context_dim=2048, head_dim=64)
        if family == "sdxl_refiner":
            return UNetConfig(context_dim=1280, head_dim=64)
        raise NotImplementedError(f"no ported UNet config for family {family!r}")


def resblock(p: Mapping[str, Any], x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    h = group_norm_silu_conv3x3(x, p["in_layers"]["0"], p["in_layers"]["2"])
    emb_out = nn.linear(nn.silu(emb), p["emb_layers"]["1"])
    h = h + emb_out[:, :, None, None].to(h.dtype)
    h = group_norm_silu_conv3x3(h, p["out_layers"]["0"], p["out_layers"]["3"])
    if "skip_connection" in p:
        x = nn.conv2d(x, p["skip_connection"])
    return x + h


BLOCK_HOOK_KEYS = frozenset(("x_concat", "input_block_patch", "input_block_patch_after_skip",
                             "middle_block_patch", "output_block_patch",
                             "output_block_patch_after"))
HOOK_KEYS = frozenset(f"{which}_{kind}" for which in ("attn1", "attn2")
                      for kind in ("context_patch", "patch", "replace", "replace_all",
                                   "output_patch")) | BLOCK_HOOK_KEYS
_NO_HOOKS: Mapping[str, Any] = {}


def check_hooks(hooks: Mapping[str, Any]) -> None:
    """Raise on a manifest key this port does not read."""
    unread = sorted(set(hooks) - HOOK_KEYS)
    if unread:
        raise NotImplementedError(f"UNet hooks {unread} are not ported to forge_tpu_torch yet "
                                  f"(ported: {sorted(HOOK_KEYS)})")


def _attn_block(p: Mapping[str, Any], x: torch.Tensor, context: Optional[torch.Tensor],
                which: str, hooks: Mapping[str, Any], extra: Mapping[str, Any]) -> torch.Tensor:
    block = {"block": extra["block"]}
    q = nn.linear(x, {"weight": p["to_q"]["weight"]})
    ctx_k = ctx_v = x if context is None else context
    for fn in hooks.get(f"{which}_context_patch", ()):
        ctx_k, ctx_v = fn(ctx_k, ctx_v, block)
    k = nn.linear(ctx_k, {"weight": p["to_k"]["weight"]})
    v = nn.linear(ctx_v, {"weight": p["to_v"]["weight"]})
    for fn in hooks.get(f"{which}_patch", ()):
        q, k, v = fn(q, k, v, extra)
    fn = hooks.get(f"{which}_replace", {}).get(extra["block"]) or hooks.get(f"{which}_replace_all")
    out = attention(q, k, v, heads=extra["n_heads"]) if fn is None else fn(q, k, v, extra)
    out = nn.linear(out, p["to_out"]["0"])
    for fn in hooks.get(f"{which}_output_patch", ()):
        out = fn(out, block)
    return out


def transformer_block(p: Mapping[str, Any], x: torch.Tensor, context: torch.Tensor,
                      hooks: Mapping[str, Any], extra: Mapping[str, Any]) -> torch.Tensor:
    """`extra` holds the block's `n_heads` and what the hooks read (see the module)."""
    x = x + _attn_block(p["attn1"], nn.layer_norm(x, p["norm1"]), None, "attn1", hooks, extra)
    x = x + _attn_block(p["attn2"], nn.layer_norm(x, p["norm2"]), context, "attn2", hooks, extra)
    h = nn.geglu(nn.layer_norm(x, p["norm3"]), p["ff"]["net"]["0"]["proj"])
    return x + nn.linear(h, p["ff"]["net"]["2"])


def spatial_transformer(p: Mapping[str, Any], x: torch.Tensor, context: torch.Tensor,
                        cfg: UNetConfig, block_id=None, hooks: Mapping[str, Any] = _NO_HOOKS,
                        first_index: int = 0) -> torch.Tensor:
    """Token blocks between proj_in and proj_out: 1×1 convs (SD1.5) or
    linears on [B, HW, C] (SDXL), told apart by the weight's rank.
    `first_index` is the attn_index of its first transformer block."""
    b, c, h, w = x.shape
    heads = cfg.num_heads if cfg.head_dim is None else max(c // cfg.head_dim, 1)
    x_in = x
    x = nn.group_norm(x, p["norm"])
    linear_proj = p["proj_in"]["weight"].dim() == 2
    if linear_proj:
        x = nn.linear(x.reshape(b, c, h * w).transpose(1, 2), p["proj_in"])
    else:
        x = nn.conv2d(x, p["proj_in"]).reshape(b, c, h * w).transpose(1, 2)
    blocks = p["transformer_blocks"]
    for i in range(len(blocks)):
        x = transformer_block(blocks[str(i)], x, context, hooks,
                              {"block": block_id, "n_heads": heads, "block_index": i,
                               "attn_index": first_index + i})
    if linear_proj:
        return nn.linear(x, p["proj_out"]).transpose(1, 2).reshape(b, c, h, w) + x_in
    x = x.transpose(1, 2).reshape(b, c, h, w)
    return nn.conv2d(x, p["proj_out"]) + x_in


def _apply_control(h: torch.Tensor, control, kind: str, index: int) -> torch.Tensor:
    """Add a ControlNet residual: control['input'][i] after input block i,
    control['output'][j] on the skip that output step j consumes,
    control['middle'][0] after the middle block."""
    if control is None:
        return h
    residuals = control.get(kind)
    if residuals is None or index >= len(residuals) or residuals[index] is None:
        return h
    return h + residuals[index].to(h.dtype)


def unet_apply(params: Mapping[str, Any], x: torch.Tensor, timesteps: torch.Tensor,
               context: torch.Tensor, y: Optional[torch.Tensor] = None,
               cfg: UNetConfig = UNetConfig(),
               control: Optional[Mapping[str, Sequence[torch.Tensor]]] = None,
               hooks: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """x [B,C_latent,H,W], timesteps [B], context [B,L,context_dim],
    y [B, 2816] (SDXL's size conditioning, required when the tree has a
    label embedding), control (models/controlnet.py `run_controlnets`'
    residuals), hooks (the hook manifest, see the module) → eps
    [B,C,H,W]."""
    hooks = hooks or _NO_HOOKS
    check_hooks(hooks)
    for fn in hooks.get("x_concat", ()):  # extra latent channels before the stem conv
        c = fn(x)
        if c.shape[2:] != x.shape[2:]:
            c = resize(c, tuple(x.shape[2:]), "bilinear")
        if c.shape[0] != x.shape[0]:
            c = c.repeat(x.shape[0] // c.shape[0], 1, 1, 1)
        x = torch.cat([x, c.to(x.dtype)], dim=1)
    n_attn = 0  # transformer blocks run so far in this forward: the next attn_index

    def transformer(sub, h, block_id):
        nonlocal n_attn
        first, n_attn = n_attn, n_attn + len(sub["transformer_blocks"])
        return spatial_transformer(sub, h, context, cfg, block_id, hooks, first)

    model_channels = params["time_embed"]["0"]["weight"].shape[1]
    t_emb = nn.timestep_embedding(timesteps, model_channels, dtype=x.dtype)
    emb = nn.linear(t_emb, params["time_embed"]["0"])
    emb = nn.linear(nn.silu(emb), params["time_embed"]["2"])
    if "label_emb" in params:
        if y is None:
            raise ValueError("this UNet has a label embedding: pass its conditioning y")
        le = params["label_emb"]["0"]
        v = nn.linear(y.to(emb.dtype), le["0"])
        emb = emb + nn.linear(nn.silu(v), le["2"])

    hs: List[torch.Tensor] = []
    h = x
    input_blocks = params["input_blocks"]
    for i in range(len(input_blocks)):
        block = input_blocks[str(i)]
        for j in range(len(block)):
            sub = block[str(j)]
            if "in_layers" in sub:
                h = resblock(sub, h, emb)
            elif "transformer_blocks" in sub:
                h = transformer(sub, h, ("input", i))
            elif "op" in sub:
                h = nn.conv2d(h, sub["op"], stride=2, padding=1)
            elif "weight" in sub:  # input_blocks.0.0 stem conv
                h = nn.conv2d(h, sub, padding=1)
        h = _apply_control(h, control, "input", i)
        for fn in hooks.get("input_block_patch", ()):
            h = fn(h, ("input", i))
        hs.append(h)
        for fn in hooks.get("input_block_patch_after_skip", ()):
            h = fn(h, ("input", i))

    mid = params["middle_block"]
    h = resblock(mid["0"], h, emb)
    h = transformer(mid["1"], h, ("middle", 0))
    h = resblock(mid["2"], h, emb)
    h = _apply_control(h, control, "middle", 0)
    for fn in hooks.get("middle_block_patch", ()):
        h = fn(h, ("middle", 0))

    output_blocks = params["output_blocks"]
    for i in range(len(output_blocks)):
        block = output_blocks[str(i)]
        skip = _apply_control(hs.pop(), control, "output", i)
        for fn in hooks.get("output_block_patch", ()):
            h, skip = fn(h, skip, ("output", i))
        h = torch.cat([h, skip], dim=1)
        for j in range(len(block)):
            sub = block[str(j)]
            if "in_layers" in sub:
                h = resblock(sub, h, emb)
            elif "transformer_blocks" in sub:
                h = transformer(sub, h, ("output", i))
            elif "conv" in sub:  # upsample
                h = nn.conv2d(nn.upsample_nearest_2x(h), sub["conv"], padding=1)
        for fn in hooks.get("output_block_patch_after", ()):
            h = fn(h, ("output", i))

    h = nn.group_norm(h, params["out"]["0"], act="silu")
    return nn.conv2d(h, params["out"]["2"], padding=1)

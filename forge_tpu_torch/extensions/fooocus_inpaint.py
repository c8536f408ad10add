"""Fooocus inpaint (port of forge_tpu/extensions/fooocus_inpaint.py, itself
of sd_forge_fooocus_inpaint): the inpaint head's feature added to the
UNet's hidden state after input block 0, and a weight patch of
uint8-quantized diffs.

The head is a 5→320 3×3 conv over [latent mask ‖ init latent] after a
replicate pad (plain `F.conv2d` in f32, as the reference's `nn.conv2d`).
The patch file (`inpaint_v26.fooocus.patch`, a torch pickle read by
core/state_dict.py `load_torch_object`) holds for each UNet weight a group
[uint8 diff, min, max]; the diff is w/255·(max − min) + min. The diffs go
through core/patches.py's "diff" kind onto a per-request copy of the UNet's
weights (`p._unet_param_override`), each decoded on the weights' device
only when its weight is patched, so the whole f32 diff set (2.6 G values
at SDXL's width) never exists at once. The engine's own weights are not
written.

`attach` needs the engine (the VAE encode of the init image), so it rides
`p.deferred_hooks`. A window short of 0–1 sets `p.hook_phases`, which
img2img refuses (the reference's img2img drops them, and the head with
them). NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.patches import Patch
from ..core.synth import LazyTensor
from ..ops.resize import resize


def is_fooocus_patch(sd: Mapping[str, Any]) -> bool:
    """A Fooocus patch's values are 3-element [uint8 diff, min, max] groups."""
    v = sd.get("diffusion_model.time_embed.0.weight")
    return v is not None and not hasattr(v, "ndim") and len(v) == 3


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def dequantize_fooocus(value, device=None) -> torch.Tensor:
    """[uint8 diff, min, max] → the f32 diff w/255·(max − min) + min on
    `device` (the diff's own unless given)."""
    w1, w_min, w_max = (_as_tensor(v) for v in value)
    device = w1.device if device is None else device
    w1 = w1.to(device=device, dtype=torch.float32)
    w_min = w_min.to(device=device, dtype=torch.float32)
    w_max = w_max.to(device=device, dtype=torch.float32)
    return (w1 / 255.0) * (w_max - w_min) + w_min


def load_fooocus_patches(sd: Mapping[str, Any], strength: float = 1.0,
                         device=None) -> Tuple[Dict[str, Patch], float]:
    """→ ({UNet tree key: "diff" Patch}, strength) for core/patches.py
    `apply_patches`. The file's `diffusion_model.` prefix is dropped; each
    diff is a `LazyTensor` decoded on `device` when its weight is patched.
    Values that are plain tensors (not groups) are skipped."""
    patches: Dict[str, Patch] = {}
    for key, value in sd.items():
        if hasattr(value, "ndim") or len(value) != 3:
            continue
        tree_key = key[len("diffusion_model."):] if key.startswith("diffusion_model.") else key
        diff = LazyTensor(tuple(value[0].shape),
                          lambda value=value: dequantize_fooocus(value, device))
        patches[tree_key] = Patch(kind="diff", tensors={"diff": diff})
    return patches, strength


def inpaint_head_feature(head_weight: torch.Tensor, latent_mask: torch.Tensor,
                         init_latent: torch.Tensor) -> torch.Tensor:
    """The head over [mask ‖ latent] ([1,1,h,w] and [1,4,h,w]) → [1,320,h,w]
    f32: a replicate pad, then the 3×3 conv (OIHW weight, no bias)."""
    feed = torch.cat([latent_mask.float(), init_latent.float()], dim=1)
    feed = F.pad(feed, (1, 1, 1, 1), mode="replicate")
    return F.conv2d(feed, head_weight.to(feed.device, torch.float32))


def build_inpaint_head_hooks(feature: torch.Tensor) -> Dict[str, Any]:
    """The feature added after input block 0, tiled to the CFG batch."""
    def input_block_patch(h, block_id):
        if block_id == ("input", 0):
            f = feature
            if h.shape[0] != f.shape[0]:
                f = f.repeat(h.shape[0] // f.shape[0], 1, 1, 1)
            h = h + f.to(h.dtype)
        return h

    return {"input_block_patch": (input_block_patch,)}


def attach(p, args: Dict[str, Any], patch_sd: Optional[Mapping[str, Any]] = None,
           head_weight=None) -> None:
    """args {"patch": path, "head": path, "weight": 1.0, "start_percent":
    0.0, "end_percent": 1.0}; `patch_sd` and `head_weight` (OIHW) given
    directly win. Adds the deferred hook that encodes the init image,
    makes the latent mask (nearest to latent size, rounded), the head's
    feature and hooks, and the weight override."""
    if patch_sd is None:
        from ..core.state_dict import load_torch_object

        patch_sd = load_torch_object(args["patch"])
    if head_weight is None:
        from ..core.state_dict import load_state_dict

        head_sd = load_state_dict(args["head"])
        head_weight = head_sd.get("head", next(iter(head_sd.values())))
    strength = float(args.get("weight", 1.0))
    start = float(args.get("start_percent", 0.0))
    end = float(args.get("end_percent", 1.0))

    def deferred(engine, pp, cond, uncond):
        if pp.init_images is None or pp.inpaint_mask is None:
            raise ValueError("fooocus inpaint needs init_images + inpaint_mask")
        img = np.asarray(pp.init_images[0], np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        img = np.ascontiguousarray((img * 2.0 - 1.0).transpose(2, 0, 1)[None])
        init_latent = engine.encode_first_stage(torch.from_numpy(img))
        mask = np.asarray(pp.inpaint_mask, np.float32)
        if mask.max() > 1.5:
            mask = mask / 255.0
        latent_mask = torch.round(resize(torch.from_numpy(mask)[None, None].to(engine.device),
                                         tuple(init_latent.shape[2:]), "nearest"))
        hooks = build_inpaint_head_hooks(
            inpaint_head_feature(_as_tensor(head_weight), latent_mask, init_latent))
        if start > 0 or end < 1:
            pp.hook_phases = ([(start, {})] if start > 0 else []) + [(end, hooks), (1.0, {})]
        else:
            from ..pipeline.processing import _merge_hooks

            pp.unet_hooks = _merge_hooks(pp.unet_hooks, hooks)
        patches, s = load_fooocus_patches(patch_sd, strength, device=engine.device)
        if patches:
            def override(tree):
                from ..core.patches import apply_patches

                return apply_patches(tree, [(patches, s)])

            pp._unet_param_override = override
        pp.extra_generation_params["Fooocus inpaint"] = "True"

    p.deferred_hooks = list(p.deferred_hooks or []) + [deferred]

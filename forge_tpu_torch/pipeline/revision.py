"""Revision: CLIP-vision image embeds drive SDXL's pooled conditioning (port
of forge_tpu/pipeline/revision.py, itself of Forge's
forge_preprocessor_revision).

Each unit's image is encoded by CLIP-ViT-bigG with its projection to a
1280-d image embedding; the weighted embeddings of all Revision units are
summed and written into the first channels of SDXL's `y` (the pooled-text
slot) on the cond, and the uncond's slot is zeroed. "Ignore prompt" zeroes
the cross-attention context of both as well. SDXL has no unCLIP noise
augmentor, so the reference's noise-augmentation branch never runs.

Every write makes a new tensor: the cond cache (pipeline/processing.py)
holds the encoded conds, and a write in place would reach the next request.
The sum and the flag stay on the request (`p._revision`), and each batch of
a request gets them (`revise`): the reference rewrites only the first
batch's conds, and every later batch, and every chunk of a chunked batch,
samples without Revision.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.clipvision import clip_vision_apply, preprocess
from ..sampling.cfg import PerStep

_ROADMAP_6D = "ROADMAP queue 1 item 6 (d), the image-prompt family"


@torch.no_grad()
def encode_revision_embed(clip_vision_params: Any, img_u8: np.ndarray,
                          weight: float) -> torch.Tensor:
    """A unit's image → its weighted projected image embedding [1, P], f32."""
    pw = clip_vision_params["vision_model"]["embeddings"]["patch_embedding"]["weight"]
    projected, _, _ = clip_vision_apply(clip_vision_params, preprocess(img_u8).to(pw.device))
    return projected.float() * float(weight)


def apply_revision(p, cond: Dict[str, Any], uncond: Dict[str, Any], embed: torch.Tensor,
                   ignore_prompt: bool) -> None:
    """Add this unit's embed to the request's sum (once set, "ignore prompt"
    stays set) and rewrite cond and uncond with it."""
    embeds, ignore = getattr(p, "_revision", None) or ([], False)
    p._revision = (embeds + [embed], ignore or bool(ignore_prompt))
    revise(p, cond, uncond)
    p.extra_generation_params.setdefault("Revision", "enabled")


def revise(p, cond: Dict[str, Any], uncond: Dict[str, Any]) -> None:
    """The request's Revision on one batch's conds, in new tensors: Σ wᵢ·embedᵢ
    in y[:, :P] of the cond, zeros there in the uncond, and with "ignore
    prompt" zero contexts."""
    embeds, ignore = p._revision
    total = sum(embeds)
    y = cond.get("y")
    if isinstance(y, PerStep) or isinstance(cond.get("context"), PerStep):
        raise NotImplementedError(f"Revision with prompt editing is not ported: {_ROADMAP_6D}")
    if not torch.is_tensor(y) or y.dim() != 2:
        raise ValueError("Revision needs an SDXL-family engine (y conditioning)")
    slot = int(total.shape[-1])  # the pooled-text slot: 1280 channels for the real bigG
    new_y = y.clone()
    new_y[:, :slot] = total.to(y.device, y.dtype).expand(y.shape[0], slot)
    cond["y"] = new_y
    uy = uncond.get("y")
    if torch.is_tensor(uy) and uy.dim() == 2:
        new_uy = uy.clone()
        new_uy[:, :slot] = 0.0
        uncond["y"] = new_uy
    if ignore:
        for c in (cond, uncond):
            if torch.is_tensor(c.get("context")):
                c["context"] = torch.zeros_like(c["context"])

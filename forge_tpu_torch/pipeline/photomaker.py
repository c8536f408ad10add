"""PhotoMaker stacked-ID conditioning for SDXL (port of
forge_tpu/pipeline/photomaker.py, the net behind Forge's photo_maker_v2
Space).

The id encoder turns face photos into ID embeddings that take the place of
the trigger word's token ("img") in the encoded prompt, so the identity
rides the text conditioning. forge_tpu's checkpoint layout:

    id_encoder.vision_model.*            the CLIP vision tower (HF keys,
                                         models/clipvision.py)
    id_encoder.visual_projection.weight  [context, vit width]: pooled → context
    id_encoder.qformer.*                 optional (v2): a perceiver over a
                                         precomputed 512-d face embedding
                                         (pipeline/ipadapter.py's layers)
    id_encoder.fuse_module.mlp1.{0,2}    Linear(2·context → context), Linear(context → context)
    id_encoder.fuse_module.mlp2.{0,2}    the same shapes, the second stage
    id_encoder.fuse_module.layer_norm    LayerNorm(context)

`build_cond_transform` gives `Processing.cond_transform`. Face photos are
cropped around the face box the full-frame rule gives, read as (x, y, w, h):
the reference reads that box as corners, which crops any photo that is not
square wrongly. A YuNet or Haar detector file under models/facedetection
needs OpenCV and raises here. A checkpoint's `lora_weights` (the UNet LoRA
the published PhotoMaker ships) are never applied by the reference; a file
that carries them raises.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.device import default_device, default_dtype
from ..core.loader import to_device_tree
from ..core.state_dict import load_state_dict
from ..models.clipvision import clip_vision_apply, preprocess
from ..ops import nn

TRIGGER_WORD = "img"
FACE_DETECTOR_DIR = "models/facedetection"
_ROADMAP_6D = "ROADMAP queue 1 item 6 (d), the image-prompt family"
_ROADMAP_9 = "ROADMAP queue 1 item 9, the long tail (face detection)"


def load_photomaker(path_or_sd, device=None, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Any]:
    """A PhotoMaker file or flat state dict → its nested tree on `device`
    (the card unless given) in `dtype` (bf16 on CUDA, f32 on the CPU unless
    given)."""
    sd = dict(path_or_sd) if isinstance(path_or_sd, Mapping) else load_state_dict(path_or_sd)
    if any(k.startswith("lora_weights.") for k in sd):
        raise NotImplementedError(f"PhotoMaker's lora_weights are not ported: {_ROADMAP_6D}")
    if not any(k.startswith("id_encoder.") for k in sd):
        raise ValueError("not a PhotoMaker checkpoint: no id_encoder.* keys")
    device = torch.device(device) if device is not None else default_device()
    return to_device_tree(sd, dtype or default_dtype(device), device)


def _mlp(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The fuse module's MLP: Linear → GELU → Linear (Sequential keys 0 and 2)."""
    return nn.linear(nn.gelu(nn.linear(x, p["0"])), p["2"])


@torch.no_grad()
def encode_id_images(pm_params: Mapping[str, Any], clipvision_params: Optional[Mapping[str, Any]],
                     pixels: torch.Tensor, face_embeds: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """ID images, normalized [N, 3, 224, 224] → stacked ID embeddings [N, T,
    context]: T = 1 (the projected pooled embedding), or with a qformer and
    face embeds [N, 512] its query count, the qformer's tokens around that
    projection."""
    enc = pm_params["id_encoder"]
    vision = enc.get("vision_model")
    tree = {"vision_model": vision} if vision is not None else clipvision_params
    pw = tree["vision_model"]["embeddings"]["patch_embedding"]["weight"]
    _, pooled, _ = clip_vision_apply(tree, pixels.to(pw.device))
    ctx = nn.linear(pooled, {"weight": enc["visual_projection"]["weight"]})  # [N, context]
    qf = enc.get("qformer")
    if qf is not None and face_embeds is not None:
        from .ipadapter import _perceiver_layers

        fe = nn.linear(face_embeds.to(ctx.device, ctx.dtype), qf["proj_in"])
        latents = qf["latents"]
        lat = latents.reshape((1,) + tuple(latents.shape[-2:])).expand(
            (ctx.shape[0],) + tuple(latents.shape[-2:])).to(ctx.dtype)
        return _perceiver_layers(qf, lat, fe[:, None, :]) + ctx[:, None, :]
    return ctx[:, None, :]


def fuse_id_embeds(pm_params: Mapping[str, Any], context: torch.Tensor, id_embeds: torch.Tensor,
                   trigger_pos: int) -> torch.Tensor:
    """The trigger token replaced by the fused stacked-ID embeddings: each ID
    token fused with the prompt's embedding at the trigger (concat → mlp1 +
    the trigger's embedding → mlp2 → LayerNorm), the N·T fused embeddings
    spliced in place of the one trigger embedding, cut to the context's
    length."""
    fm = pm_params["id_encoder"]["fuse_module"]
    b, length, d = context.shape
    s = id_embeds.reshape(1, -1, d).to(context.dtype).expand(b, -1, d)  # [B, N·T, D]
    anchor = context[:, trigger_pos:trigger_pos + 1].expand(s.shape)
    x = _mlp(fm["mlp1"], torch.cat([anchor, s], dim=-1)) + anchor
    fused = nn.layer_norm(_mlp(fm["mlp2"], x), fm["layer_norm"])
    out = torch.cat([context[:, :trigger_pos], fused, context[:, trigger_pos + 1:]], dim=1)
    return out[:, :length]


def find_trigger_position(engine, prompt: str) -> int:
    """The trigger word's token index in the encoded 77-token chunk (after
    BOS), by the CLIP-L tokenizer. Raises if it is absent or repeated, as the
    reference's app does."""
    eng = engine.text_engines.get("clip_l") or next(iter(engine.text_engines.values()))
    ids = list(eng.tokenizer.ids(prompt))
    trig = list(eng.tokenizer.ids(TRIGGER_WORD))
    if len(trig) != 1:
        raise ValueError("trigger word must be a single token")
    hits = [i for i, t in enumerate(ids) if t == trig[0]]
    if not hits:
        raise ValueError(f"Cannot find the trigger word {TRIGGER_WORD!r} in the prompt")
    if len(hits) > 1:
        raise ValueError(f"Cannot use multiple trigger words {TRIGGER_WORD!r} in the prompt")
    return hits[0] + 1  # BOS


# Copied from forge_tpu/postprocessing/faces.py:68-69 (detect_faces' full-frame box).
def fullframe_face_box(h: int, w: int):
    side = min(h, w)
    return ((w - side) // 2, (h - side) // 2, side, side)


def id_pixels_from_images(images: List[np.ndarray]) -> torch.Tensor:
    """uint8 face photos → the normalized [N, 3, 224, 224] CLIP-vision feed,
    each cropped to the full-frame face box (x, y, w, h) padded by 0.4 of its
    larger side. A detector file under models/facedetection raises: YuNet
    and Haar need OpenCV."""
    found = sorted(glob.glob(os.path.join(FACE_DETECTOR_DIR, "*.onnx"))
                   + glob.glob(os.path.join(FACE_DETECTOR_DIR, "*.xml")))
    if found:
        raise NotImplementedError(f"face detection with {found[0]} is not ported: {_ROADMAP_9}")
    feeds = []
    for img in images:
        ih, iw = img.shape[:2]
        x, y, bw, bh = fullframe_face_box(ih, iw)
        pad = int(0.4 * max(bw, bh))
        x0, y0 = max(0, x - pad), max(0, y - pad)
        x1, y1 = min(iw, x + bw + pad), min(ih, y + bh + pad)
        feeds.append(preprocess(img[y0:y1, x0:x1]))
    return torch.cat(feeds)


def build_cond_transform(engine, pm_params: Mapping[str, Any], prompt: str,
                         id_images: Optional[List[np.ndarray]] = None,
                         id_pixels: Optional[torch.Tensor] = None,
                         face_embeds: Optional[np.ndarray] = None,
                         start_merge_ratio: float = 0.0):
    """→ `Processing.cond_transform`: splices the stacked-ID embeddings into
    the cond's context at the prompt's trigger; a `start_merge_ratio` > 0
    blends (1 − r)·fused + r·context."""
    pos = find_trigger_position(engine, prompt)
    pixels = id_pixels if id_pixels is not None else id_pixels_from_images(id_images or [])
    fe = None
    if face_embeds is not None:
        fe = torch.as_tensor(np.atleast_2d(np.asarray(face_embeds, np.float32)))
    id_embeds = encode_id_images(pm_params, None, pixels, face_embeds=fe)

    def transform(cond: Dict[str, Any]) -> Dict[str, Any]:
        ctx = cond["context"]
        fused = fuse_id_embeds(pm_params, ctx, id_embeds.to(ctx.device), pos)
        if start_merge_ratio > 0.0:
            fused = (1 - start_merge_ratio) * fused + start_merge_ratio * ctx
        return dict(cond, context=fused.to(ctx.dtype))

    return transform

"""Checkpoint → device parameter trees (port of forge_tpu/core/loader.py: SD1.5,
SD2, SDXL base and refiner, Playground v2.5, SD3 and Flux).

Load the file (or take a flat state dict), guess the architecture, split it
into components, key-normalize CLIP into the HF `text_model.*` space (the
open_clip towers, SD2's CLIP-H as `clip_h` and SDXL's CLIP-G as `clip_g`,
through `convert_open_clip`; SD3's single-file CLIP-L and CLIP-G are in that
space already, CLIP-G with its `text_projection`), cast
floating leaves to the compute dtype and move them to the device. Conv
kernels stay OIHW: the port computes in the checkpoints' own layout. On the
card the weights of the convs that `ops/fused_gn_conv.py` fuses (UNet
resblocks' `in_layers.2` and `out_layers.3`, VAE resnets' `conv1` and
`conv2`) are stored channels_last, [O, 3, 3, C] in memory under the same
OIHW shape, the layout the kernel's tensor-core body reads: no copy beside
them, and none on each call.

Quantized weights: `unet_quant` ("nf4" | "q8_0" | "q4_0") quantizes the
diffusion model's large matmul weights as each tensor arrives, on its device,
with the reference's selection rule (2-D, ≥ QUANT_MIN_SIZE elements, no
"norm", "emb" or "bias" in the key). Prequantized leaves (GGUF files, or
forge_tpu leaf dicts) pass through as `QuantLeaf`s whatever `unet_quant` is.
Lazy weights (`core/synth.py` `LazyTensor`) are made one at a time, so a
full-width checkpoint is never resident at full precision.

`load_controlnet` takes a cldm ControlNet's state dict (or file) to its tree
on the device the same way; its ResBlocks' fused convs are stored
channels_last on the card as the UNet's are. `load_clip_vision` (HF
`vision_model.*` keys) and `load_ip_adapter` (`image_proj.*` and
`ip_adapter.{1,3,…}.to_{k,v}_ip.weight`) do the same for an IP-Adapter's
image encoder and adapter. Each takes the engine's dtype and device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops import quant as quant_mod
from . import guess as guess_mod
from .device import default_device, default_dtype
from .convert import nest, quant_leaf, to_tensor
from .state_dict import load_state_dict
from .synth import LazyTensor

FAMILIES = ("sd15", "sd20", "sdxl", "sdxl_refiner", "playground", "sd3", "flux")
TEXT_ENCODERS = ("clip_l", "clip_h", "clip_g", "t5xxl")
OPEN_CLIP_NAMES = {"open_clip_h": "clip_h", "open_clip_g": "clip_g"}
UNET_QUANT = ("nf4", "q8_0", "q4_0")
QUANT_MIN_SIZE = 1 << 16  # leave small tensors in full precision
QUANT_SKIP = ("norm", "emb", "bias")
FUSED_CONV_WEIGHTS = ("in_layers.2.weight", "out_layers.3.weight", "conv1.weight",
                      "conv2.weight")


def _rows(value, part: int, parts: int):
    """Row block `part` of `parts` of a 2-D or 1-D weight; a `LazyTensor`
    stays lazy and is cut when it is made, on its own device."""
    if isinstance(value, LazyTensor):
        n = value.shape[0] // parts
        return LazyTensor((n,) + value.shape[1:],
                          lambda: value.materialize()[part * n:(part + 1) * n].clone())
    return np.split(np.asarray(value), parts, axis=0)[part]


def _transposed(value):
    if isinstance(value, LazyTensor):
        return LazyTensor(value.shape[::-1], lambda: value.materialize().t().contiguous())
    return np.ascontiguousarray(np.asarray(value).T)


def convert_open_clip(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """open_clip text-tower keys → HF CLIPTextModel `text_model.*` keys:
    `in_proj_*` split into q/k/v, `text_projection` transposed to [out, in]."""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        if k == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = v
        elif k == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = v
        elif k.startswith("ln_final."):
            out["text_model.final_layer_norm." + k[len("ln_final."):]] = v
        elif k == "text_projection":
            out["text_projection.weight"] = _transposed(v)
        elif k.startswith("transformer.resblocks."):
            idx, sub = k[len("transformer.resblocks."):].split(".", 1)
            base = f"text_model.encoder.layers.{idx}."
            if sub.startswith("ln_1."):
                out[base + "layer_norm1." + sub[5:]] = v
            elif sub.startswith("ln_2."):
                out[base + "layer_norm2." + sub[5:]] = v
            elif sub.startswith("mlp.c_fc."):
                out[base + "mlp.fc1." + sub[9:]] = v
            elif sub.startswith("mlp.c_proj."):
                out[base + "mlp.fc2." + sub[11:]] = v
            elif sub.startswith("attn.out_proj."):
                out[base + "self_attn.out_proj." + sub[14:]] = v
            elif sub.startswith("attn.in_proj_"):
                kind = sub[len("attn.in_proj_"):]  # 'weight' or 'bias'
                for part, name in enumerate(("q_proj", "k_proj", "v_proj")):
                    out[base + f"self_attn.{name}.{kind}"] = _rows(v, part, 3)
        # attn_mask / logit_scale dropped, as the reference does
    return out


class LoadedCheckpoint:
    """Split + normalized + device-resident components of one checkpoint."""

    def __init__(self, family, prediction, context_dim, unet, vae, text_encoders):
        self.family = family
        self.prediction = prediction
        self.context_dim = context_dim
        self.unet = unet
        self.vae = vae
        self.text_encoders = text_encoders  # name -> nested params


def _quantizes(key: str, shape) -> bool:
    return (len(shape) == 2 and math.prod(shape) >= QUANT_MIN_SIZE
            and not any(t in key for t in QUANT_SKIP))


def to_device_tree(sd: Mapping[str, Any], dtype: torch.dtype, device,
                   quant: Optional[str] = None) -> Dict[str, Any]:
    """Flat {key: array} → nested {..: tensor | QuantLeaf} on `device`;
    floating leaves cast to `dtype`, integer leaves keep theirs, and with
    `quant` the weights `_quantizes` picks become `QuantLeaf`s."""
    out = {}
    for key, value in sd.items():
        if isinstance(value, (Mapping, quant_mod.QuantLeaf)):  # prequantized
            out[key] = quant_leaf(value).to(device)
            continue
        t = value.materialize() if isinstance(value, LazyTensor) else to_tensor(value)
        if quant is not None and t.is_floating_point() and _quantizes(key, t.shape):
            t = quant_mod.quantize(t.to(device), quant)
        elif t.is_floating_point():
            t = t.to(device=device, dtype=dtype)
            if t.device.type == "cuda" and t.dim() == 4 and key.endswith(FUSED_CONV_WEIGHTS):
                t = t.contiguous(memory_format=torch.channels_last)
        else:
            t = t.to(device=device)
        out[key] = t
    return nest(out)


def load_checkpoint_parts(path_or_sd, dtype: Optional[torch.dtype] = None, device=None,
                          unet_quant: Optional[str] = None,
                          vae_dtype: Optional[torch.dtype] = None) -> LoadedCheckpoint:
    """Checkpoint path (or flat state dict) → components on `device` (the
    CUDA card unless given; without one this raises) in `dtype` (bf16 on
    CUDA, f32 on the CPU unless given); the VAE in `vae_dtype` (default:
    `dtype`)."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    if unet_quant is not None and unet_quant not in UNET_QUANT:
        raise NotImplementedError(
            f"unet_quant={unet_quant!r} is not ported (ported: {', '.join(UNET_QUANT)})")
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)
    g = guess_mod.guess(sd)
    del sd
    if g.family not in FAMILIES:
        raise NotImplementedError(
            f"{g.family} checkpoints are not ported to forge_tpu_torch yet "
            f"(ported: {', '.join(FAMILIES)})")
    text_encoders: Dict[str, Any] = {}
    for name, tsd in g.text_encoders.items():
        if name in OPEN_CLIP_NAMES:
            tsd, name = convert_open_clip(tsd), OPEN_CLIP_NAMES[name]
        if name not in TEXT_ENCODERS:
            raise NotImplementedError(f"text encoder {name} is not ported yet")
        if name.startswith("clip") and not any(k.startswith("text_model.") for k in tsd):
            # bare CLIP dumps → HF text_model namespace
            tsd = {f"text_model.{k}" if not k.startswith("text_projection") else k: v
                   for k, v in tsd.items()}
        text_encoders[name] = to_device_tree(tsd, dtype, device)
    unet = to_device_tree(g.unet, dtype, device, quant=unet_quant)
    vae = to_device_tree(g.vae, vae_dtype or dtype, device)
    return LoadedCheckpoint(g.family, g.prediction, g.context_dim, unet, vae, text_encoders)


def _load_with(path_or_sd, prefixes, what: str, dtype: torch.dtype, device) -> Dict[str, Any]:
    """File or flat state dict → nested tree on `device`, if it has keys under every prefix."""
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)
    missing = [p for p in prefixes if not any(k.startswith(p) for k in sd)]
    if missing:
        raise ValueError(f"not {what}: no {', '.join(p + '*' for p in missing)} keys")
    return to_device_tree(sd, dtype, device)


def load_controlnet(path_or_sd, dtype: torch.dtype, device) -> Dict[str, Any]:
    """cldm ControlNet (file or flat state dict, optionally under a
    `control_model.` prefix) → its nested tree on `device` in `dtype`."""
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)
    if any(k.startswith("control_model.") for k in sd):
        sd = {k[len("control_model."):]: v for k, v in sd.items()
              if k.startswith("control_model.")}
    return _load_with(sd, ("input_hint_block.",), "a cldm ControlNet", dtype, device)


def load_clip_vision(path_or_sd, dtype: torch.dtype, device) -> Dict[str, Any]:
    """CLIP vision tower (HF CLIPVisionModelWithProjection keys; file or flat
    state dict) → its nested tree on `device` in `dtype`."""
    return _load_with(path_or_sd, ("vision_model.",), "a CLIP vision model", dtype, device)


def load_ip_adapter(path_or_sd, dtype: torch.dtype, device) -> Dict[str, Any]:
    """IP-Adapter (file or flat state dict with `image_proj.*` and
    `ip_adapter.*` keys) → its nested tree on `device` in `dtype`."""
    return _load_with(path_or_sd, ("image_proj.", "ip_adapter."), "an IP-Adapter", dtype,
                      device)

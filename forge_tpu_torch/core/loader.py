"""Checkpoint → device parameter trees (port of forge_tpu/core/loader.py: SD1.5,
SD2, SDXL base and refiner, Playground v2.5, SD3, Flux and Chroma).

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
"norm", "emb" or "bias" in the key). Prequantized leaves (GGUF files,
bitsandbytes NF4 files, or forge_tpu leaf dicts) pass through as
`QuantLeaf`s whatever `unet_quant` is. The fp8 storage modes ("fp8" and
"fp8_e4m3": float8_e4m3fn; "fp8_e5m2") store the diffusion model's weights
the reference picks (≥ 2 dims, conv kernels too, ≥ QUANT_MIN_SIZE
elements, no "norm", "emb" or "bias" in the key) as torch fp8 tensors on the
device, everything else in the compute dtype; the ops upcast an fp8 weight
where they use it, with no copy kept. A weight an fp8 file holds (read as
fp8 by core/state_dict.py) stays fp8 where that rule picks it, in any
component. Lazy weights (`core/synth.py` `LazyTensor`) are made one at a
time, so a full-width checkpoint is never resident at full precision.

`additional_modules` ({name: file}) merges files into the checkpoint before
the guess, as the reference does: "vae" replaces its VAE (the file's keys
under `first_stage_model.`, with or without that prefix in the file), any
other name merges the file's keys as they are (a text-encoder file in the
merged `text_encoders.*` layout). A file none of whose keys a component
takes raises, naming it. A bare Flux or SD3 file's UNet holds its own
keys alone, not the merged files' (core/guess.py).

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

FAMILIES = ("sd15", "sd20", "sdxl", "sdxl_refiner", "playground", "sd3", "flux", "chroma")
TEXT_ENCODERS = ("clip_l", "clip_h", "clip_g", "t5xxl")
OPEN_CLIP_NAMES = {"open_clip_h": "clip_h", "open_clip_g": "clip_g"}
FP8_STORAGE = {"fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn,
               "fp8_e5m2": torch.float8_e5m2}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
UNET_QUANT = ("nf4", "q8_0", "q4_0") + tuple(FP8_STORAGE)
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
    if isinstance(value, torch.Tensor):
        return value.chunk(parts, dim=0)[part].clone()
    return np.split(np.asarray(value), parts, axis=0)[part]


def _transposed(value):
    if isinstance(value, LazyTensor):
        return LazyTensor(value.shape[::-1], lambda: value.materialize().t().contiguous())
    if isinstance(value, torch.Tensor):
        return value.t().contiguous()
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


def _stores_fp8(key: str, shape) -> bool:
    """The reference's fp8 storage rule: ≥ 2 dims (conv kernels too), big, no norm/emb/bias."""
    return (len(shape) >= 2 and math.prod(shape) >= QUANT_MIN_SIZE
            and not any(t in key for t in QUANT_SKIP))


def _quantizes(key: str, shape) -> bool:
    """The block quantizers' rule: the fp8 rule's weights that are 2-D."""
    return len(shape) == 2 and _stores_fp8(key, shape)


def to_device_tree(sd: Mapping[str, Any], dtype: torch.dtype, device,
                   quant: Optional[str] = None) -> Dict[str, Any]:
    """Flat {key: array} → nested {..: tensor | QuantLeaf} on `device`;
    floating leaves cast to `dtype`, integer leaves keep theirs; with a block
    `quant` the weights `_quantizes` picks become `QuantLeaf`s, with an fp8
    `quant` the weights `_stores_fp8` picks become fp8 tensors, as do those
    that are fp8 already."""
    fp8 = FP8_STORAGE.get(quant)
    out = {}
    for key, value in sd.items():
        if isinstance(value, (Mapping, quant_mod.QuantLeaf)):  # prequantized
            out[key] = quant_leaf(value).to(device)
            continue
        t = value.materialize() if isinstance(value, LazyTensor) else to_tensor(value)
        if (fp8 is None and quant is not None and t.is_floating_point()
                and _quantizes(key, t.shape)):
            t = quant_mod.quantize(t.to(device), quant)
        elif t.is_floating_point():
            keep = fp8 or (t.dtype if t.dtype in FP8_DTYPES else None)
            store = keep if keep is not None and _stores_fp8(key, t.shape) else dtype
            if store in FP8_DTYPES and t.dtype not in FP8_DTYPES:  # rounded once, from f32
                t = t.to(device=device, dtype=torch.float32).to(store)
            else:
                t = t.to(device=device, dtype=store)
            if t.device.type == "cuda" and t.dim() == 4 and key.endswith(FUSED_CONV_WEIGHTS):
                t = t.contiguous(memory_format=torch.channels_last)
        else:
            t = t.to(device=device)
        out[key] = t
    return nest(out)


def merge_additional_modules(sd: Dict[str, Any],
                             additional_modules: Mapping[str, Any]) -> Dict[str, Any]:
    """The checkpoint's flat state dict with each {name: file (or flat state
    dict)} merged in: "vae" replaces the VAE, any other name adds its keys as
    they are (the reference's rule). A file none of whose keys a component
    takes raises ValueError naming it (a text encoder in its upstream key
    space, `encoder.block.*`, where the reference drops it without a word)."""
    sd = dict(sd)
    for name, path in additional_modules.items():
        extra = load_state_dict(path) if isinstance(path, str) else dict(path)
        if name == "vae":
            vae_prefix = guess_mod.VAE_PREFIX
            if any(k.startswith(vae_prefix) for k in extra):
                extra = {k[len(vae_prefix):]: v for k, v in extra.items()
                         if k.startswith(vae_prefix)}
            sd = {k: v for k, v in sd.items() if not k.startswith(vae_prefix)}
            sd.update({vae_prefix + k: v for k, v in extra.items()})
            continue
        if not any(guess_mod.collected(k) for k in extra):
            raise ValueError(
                f"additional module {name!r} ({path if isinstance(path, str) else 'a state dict'}): "
                f"no key of it is one a component takes (text encoders go under "
                f"{', '.join(sorted(set(guess_mod.TEXT_ENCODER_PREFIXES)))})")
        sd.update(extra)
    return sd


def load_checkpoint_parts(path_or_sd, dtype: Optional[torch.dtype] = None, device=None,
                          unet_quant: Optional[str] = None,
                          vae_dtype: Optional[torch.dtype] = None,
                          additional_modules: Optional[Mapping[str, Any]] = None
                          ) -> LoadedCheckpoint:
    """Checkpoint path (or flat state dict) → components on `device` (the
    CUDA card unless given; without one this raises) in `dtype` (bf16 on
    CUDA, f32 on the CPU unless given); the VAE in `vae_dtype` (default:
    `dtype`). `additional_modules` ({"vae" | a text encoder's name: file})
    merges separate files in (`merge_additional_modules`)."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    if unet_quant is not None and unet_quant not in UNET_QUANT:
        raise NotImplementedError(
            f"unet_quant={unet_quant!r} is not ported (ported: {', '.join(UNET_QUANT)})")
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)
    if additional_modules:
        sd = merge_additional_modules(sd, additional_modules)
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

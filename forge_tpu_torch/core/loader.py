"""Checkpoint → device parameter trees (port of forge_tpu/core/loader.py, SD1.5).

Load the file (or take a flat state dict), guess the architecture, split it
into components, key-normalize the text encoder into the HF `text_model.*`
space, cast floating leaves to the compute dtype and move them to the device.
Conv kernels stay OIHW: the port computes in the checkpoints' own layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from . import guess as guess_mod
from .convert import nest, to_tensor
from .state_dict import load_state_dict


class LoadedCheckpoint:
    """Split + normalized + device-resident components of one checkpoint."""

    def __init__(self, family, prediction, context_dim, unet, vae, text_encoders):
        self.family = family
        self.prediction = prediction
        self.context_dim = context_dim
        self.unet = unet
        self.vae = vae
        self.text_encoders = text_encoders  # name -> nested params


def to_device_tree(sd: Mapping[str, Any], dtype: torch.dtype,
                   device) -> Dict[str, Any]:
    """Flat {key: array} → nested {..: tensor} on `device`; floating leaves
    cast to `dtype`, integer leaves keep theirs."""
    out = {}
    for key, value in sd.items():
        t = to_tensor(value)
        if t.is_floating_point():
            t = t.to(device=device, dtype=dtype)
        else:
            t = t.to(device=device)
        out[key] = t
    return nest(out)


def load_checkpoint_parts(path_or_sd, dtype: torch.dtype = torch.float32,
                          device="cpu") -> LoadedCheckpoint:
    """Checkpoint path (or flat state dict) → components on `device`."""
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)
    g = guess_mod.guess(sd)
    if g.family != "sd15":
        raise NotImplementedError(
            f"{g.family} checkpoints are not ported to forge_tpu_torch yet (SD1.5 only)")
    text_encoders: Dict[str, Any] = {}
    for name, tsd in g.text_encoders.items():
        if name != "clip_l":
            raise NotImplementedError(f"text encoder {name} is not ported yet")
        if not any(k.startswith("text_model.") for k in tsd):
            # bare CLIP dumps → HF text_model namespace
            tsd = {f"text_model.{k}" if not k.startswith("text_projection") else k: v
                   for k, v in tsd.items()}
        text_encoders[name] = to_device_tree(tsd, dtype, device)
    unet = to_device_tree(g.unet, dtype, device)
    vae = to_device_tree(g.vae, dtype, device)
    return LoadedCheckpoint(g.family, g.prediction, g.context_dim, unet, vae, text_encoders)

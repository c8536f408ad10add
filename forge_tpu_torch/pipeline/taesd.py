# Copied from forge_tpu/pipeline/taesd.py (TAESD decoder and encoder, VAEApprox, the family table, the loaders and preview_decode); NCHW, OIHW kernels.
"""TAESD (the tiny autoencoder) and VAEApprox, the preview decoders.

TAESD's decoder and encoder (modules/sd_vae_taesd.py:26-55, madebyollin/
taesd): 3×3 conv stacks of residual blocks fused through ReLU, nearest 2×
upsamples (decoder) or stride-2 convs (encoder), the input clamped by
tanh(x/3)·3. Weights are addressed by the `.pth` files' `nn.Sequential`
indices (`decoder.<i>.…`, `encoder.<i>.…`), so the official taesd, taesdxl,
taesd3 and taef1 files load as they are. VAEApprox (sd_vae_approx.py:10-31):
eight shrinking convs over a 2×-upsampled latent padded by 11.

These are small plain convolutions, which the reference runs through its
`ops/nn.py` conv2d and not a Pallas kernel: here `torch.nn.functional.conv2d`,
in f32. `register_taesd` primes the cache with weights held in memory (a
synthetic state dict); `load_taesd` reads `models/VAE-taesd` otherwise.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.convert import nest, to_tensor
from ..ops import nn

latent_magnitude = 3.0
latent_shift = 0.5


def _block(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Residual block: conv-relu-conv-relu-conv plus the skip (identity for
    64 → 64), through a ReLU."""
    h = F.relu(nn.conv2d(x, p["conv"]["0"], padding=1))
    h = F.relu(nn.conv2d(h, p["conv"]["2"], padding=1))
    h = nn.conv2d(h, p["conv"]["4"], padding=1)
    if isinstance(p.get("skip"), dict) and "weight" in p["skip"]:
        x = nn.conv2d(x, p["skip"])
    return F.relu(h + x)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def taesd_decode(params: Mapping[str, Any], latent: torch.Tensor) -> torch.Tensor:
    """latent [B,C,h,w] (raw VAE latent space, not regulated) → RGB
    [B,3,8h,8w] in [0, 1]."""
    d = params["decoder"]
    x = torch.tanh(latent / latent_magnitude) * latent_magnitude  # Clamp
    x = F.relu(nn.conv2d(x, d["1"], padding=1))
    for i in (3, 4, 5):
        x = _block(d[str(i)], x)
    x = nn.conv2d(_upsample2x(x), d["7"], padding=1)
    for i in (8, 9, 10):
        x = _block(d[str(i)], x)
    x = nn.conv2d(_upsample2x(x), d["12"], padding=1)
    for i in (13, 14, 15):
        x = _block(d[str(i)], x)
    x = nn.conv2d(_upsample2x(x), d["17"], padding=1)
    x = _block(d["18"], x)
    x = nn.conv2d(x, d["19"], padding=1)
    return torch.clamp(x, 0.0, 1.0)


def taesd_encode(params: Mapping[str, Any], image: torch.Tensor) -> torch.Tensor:
    """image [B,3,H,W] in [0, 1] → latent [B,C,H/8,W/8] (raw latent space)."""
    e = params["encoder"]
    x = nn.conv2d(image, e["0"], padding=1)
    x = _block(e["1"], x)
    for down, blocks in ((2, (3, 4, 5)), (6, (7, 8, 9)), (10, (11, 12, 13))):
        x = nn.conv2d(x, e[str(down)], stride=2, padding=1)
        for i in blocks:
            x = _block(e[str(i)], x)
    return nn.conv2d(x, e["14"], padding=1)


def vae_approx_decode(params: Mapping[str, Any], latent: torch.Tensor) -> torch.Tensor:
    """VAEApprox: latent [B,C,h,w] → RGB [B,3,2h,2w] roughly in [0, 1] (the
    net was trained on half-resolution images)."""
    x = F.pad(_upsample2x(latent), (11, 11, 11, 11))
    for i in range(1, 9):
        x = F.leaky_relu(nn.conv2d(x, params[f"conv{i}"]), 0.1)
    return x


# -- weights -------------------------------------------------------------------

_TAESD_BY_FAMILY = {
    "sd15": "taesd", "sd20": "taesd",
    "sdxl": "taesdxl", "sdxl_refiner": "taesdxl",
    "sd3": "taesd3", "flux": "taef1", "chroma": "taef1",
}

_cache: Dict[Any, Any] = {}


def _params(sd: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """A flat state dict (numpy arrays, tensors or core/synth.py `LazyTensor`s;
    OIHW) → nested f32 tensors on `device`."""
    def tensor(v):
        return v.materialize() if hasattr(v, "materialize") else to_tensor(v)

    return nest({k: tensor(v).to(device=device, dtype=torch.float32) for k, v in sd.items()})


def register_taesd(kind: str, part: str, state_dict: Mapping[str, Any]) -> None:
    """Hold `state_dict` (keys `<part>.<i>.…` or `<i>.…`) as `kind`'s `part`, in
    place of the file `load_taesd` would read."""
    if not any(k.startswith(part) for k in state_dict):
        state_dict = {f"{part}.{k}": v for k, v in state_dict.items()}
    for key in [k for k in _cache if k[:2] == (kind, part)]:  # the device copies too
        del _cache[key]
    _cache[(kind, part)] = _params(state_dict)


def load_taesd(kind: str, part: str, model_dir: str = "models/VAE-taesd",
               device=None) -> Optional[Dict[str, Any]]:
    """kind taesd | taesdxl | taesd3 | taef1, part decoder | encoder → nested
    params on `device`, or None where neither `register_taesd` nor a file
    `<kind>_<part>.pth` / `.safetensors` in `model_dir` holds them."""
    if (kind, part) not in _cache:
        from ..core.state_dict import load_state_dict

        for name in (f"{kind}_{part}.pth", f"{kind}_{part}.safetensors"):
            path = os.path.join(model_dir, name)
            if os.path.exists(path):
                register_taesd(kind, part, load_state_dict(path))
                break
        else:
            return None
    key = (kind, part, str(torch.device(device)) if device is not None else None)
    if key not in _cache:
        _cache[key] = _to(_cache[(kind, part)], device)
    return _cache[key]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree if device is None else tree.to(device)


def taesd_decoder(engine, params):
    """The engine's `decode_dispatch` decode through the TAESD decoder params
    `params`: regulated latent [B,C,h,w] → RGB [B,3,8h,8w] in [-1, 1]."""
    def decode(latent: torch.Tensor) -> torch.Tensor:
        return taesd_decode(params, engine.latent_format.process_out(latent.float())) * 2 - 1

    return decode


def taesd_for_family(family: str, part: str = "decoder", model_dir: str = "models/VAE-taesd",
                     device=None) -> Optional[Dict[str, Any]]:
    kind = _TAESD_BY_FAMILY.get(family)
    return load_taesd(kind, part, model_dir, device) if kind else None


def load_vae_approx(model_dir: str = "models/VAE-approx",
                    name: str = "model.pt") -> Optional[Dict[str, Any]]:
    """VAEApprox's weights from `model_dir/name` (the "Approx NN" preview's), or None."""
    path = os.path.join(model_dir, name)
    if not os.path.exists(path):
        return None
    from ..core.state_dict import load_state_dict

    _cache["vae_approx"] = _params(load_state_dict(path))
    return _cache["vae_approx"]


@torch.no_grad()
def taesd_rgb(engine, latent: torch.Tensor, params) -> np.ndarray:
    """Regulated latent [B,C,h,w] → f32 RGB [B,8h,8w,3] in [0, 1] on the host,
    through TAESD."""
    raw = engine.latent_format.process_out(latent.float())
    rgb = taesd_decode(_to(params, raw.device), raw)
    return rgb.permute(0, 2, 3, 1).cpu().numpy()


@torch.no_grad()
def preview_decode(engine, latent: torch.Tensor, mode: str = "Approx cheap") -> np.ndarray:
    """The live preview's decoder by the `show_progress_type` option: "TAESD"
    (where the family's weights are found), "Approx NN" (where VAEApprox's
    are), "Full" (the engine's VAE), else "Approx cheap" → uint8 [B,H,W,3]."""
    from .preview import latent_to_rgb_cheap

    if mode == "TAESD":
        params = taesd_for_family(engine.family, device=latent.device)
        if params is not None:
            return (taesd_rgb(engine, latent, params) * 255).astype(np.uint8)
    if mode == "Approx NN":
        params = _cache.get("vae_approx")
        if params is not None:
            rgb = vae_approx_decode(_to(params, latent.device), latent.float())
            return (torch.clamp(rgb, 0, 1).permute(0, 2, 3, 1).cpu().numpy() * 255).astype(np.uint8)
    if mode == "Full":
        return engine.decode_finish(engine.decode_dispatch(latent))
    return latent_to_rgb_cheap(latent, engine.family)

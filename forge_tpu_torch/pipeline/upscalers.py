# Copied from forge_tpu/pipeline/upscalers.py (the simple resizers, RRDBNet, the key conversion, the tiled upscale and the registry with its architecture sniffing and tile options), in PyTorch and numpy.
"""Upscalers: the resize-mode algorithms and tiled GAN upscaling.

`upscale_pil` is the reference's Pillow resize (Lanczos or Nearest) in numpy
(pipeline/images.py: the card's machine has no Pillow). `rrdbnet_apply` is
ESRGAN's RRDBNet on NCHW tensors, its convs plain `F.conv2d` as the
reference's are plain convs; `convert_esrgan_keys` maps the old `model.N`
serialization to RRDBNet's names; `tiled_upscale` runs a model tile by tile
with feathered seams (reference upscaler_utils.py:91-164). The registry
holds "None", "Lanczos" and "Nearest" and discovers model files
(`.safetensors`, `.pth`) in its directories; a `params_ema` or `params` wrap
is unwrapped, and the network is sniffed from the keys as the reference
does (`sniff_architecture`): HAT, SwinIR, DAT, SCUNet (scale 1) or RRDBNet
(models/hat.py, swinir.py, dat.py, scunet.py). A network runs on the
registry's device (the CUDA card unless one is given; without one this
raises) in its dtype (bf16 on CUDA, f32 on the CPU). The tiles follow the
options of the file's directory kind, as the reference's: `SWIN_tile` for
"SwinIR", `DAT_tile` for "DAT", `ESRGAN_tile` for any other (a HAT file in
models/HAT too), each with its overlap; a tile of 0 becomes 192.

Two faults of the reference are not kept: its `convert_esrgan_keys` indexes
past the end of `model.1.sub.{nb}.weight` (the conv_body of every old-layout
checkpoint) and raises IndexError, and its `.pth` reader drops nested
dicts, so a `params_ema`-wrapped file (RealESRGAN's own) loads empty.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.convert import nest, tree_to
from ..core.state_dict import load_state_dict
from ..ops import nn
from .images import lanczos_resize, nearest_resize

ESRGAN_TILE, ESRGAN_TILE_OVERLAP = 192, 8  # the reference's tile options' defaults


def upscale_pil(img: np.ndarray, scale: float, mode: str = "Lanczos") -> np.ndarray:
    """uint8 [H,W,3] → [int(H·scale), int(W·scale), 3], as Pillow resizes it."""
    arr = np.asarray(img, np.uint8)
    h, w = arr.shape[:2]
    size = (int(w * scale), int(h * scale))
    return lanczos_resize(arr, *size) if mode == "Lanczos" else nearest_resize(arr, *size)


# -- RRDBNet (ESRGAN): conv_first, body.N.rdb{1,2,3}.conv{1..5}, conv_body, conv_up1/2,
# conv_hr, conv_last


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def _rdb(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    c1 = _lrelu(nn.conv2d(x, p["conv1"], padding=1))
    c2 = _lrelu(nn.conv2d(torch.cat([x, c1], 1), p["conv2"], padding=1))
    c3 = _lrelu(nn.conv2d(torch.cat([x, c1, c2], 1), p["conv3"], padding=1))
    c4 = _lrelu(nn.conv2d(torch.cat([x, c1, c2, c3], 1), p["conv4"], padding=1))
    c5 = nn.conv2d(torch.cat([x, c1, c2, c3, c4], 1), p["conv5"], padding=1)
    return x + 0.2 * c5


def _rrdb(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    out = _rdb(p["rdb1"], x)
    out = _rdb(p["rdb2"], out)
    out = _rdb(p["rdb3"], out)
    return x + 0.2 * out


def rrdbnet_apply(params: Mapping[str, Any], x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """x [B,3,H,W] in [0, 1] → upscaled [B,3,sH,sW]."""
    feat = nn.conv2d(x, params["conv_first"], padding=1)
    body = feat
    blocks = params["body"]
    for i in range(len(blocks)):
        body = _rrdb(blocks[str(i)], body)
    feat = feat + nn.conv2d(body, params["conv_body"], padding=1)
    if scale >= 2:
        feat = _lrelu(nn.conv2d(nn.upsample_nearest_2x(feat), params["conv_up1"], padding=1))
    if scale >= 4:
        feat = _lrelu(nn.conv2d(nn.upsample_nearest_2x(feat), params["conv_up2"], padding=1))
    feat = _lrelu(nn.conv2d(feat, params["conv_hr"], padding=1))
    return nn.conv2d(feat, params["conv_last"], padding=1)


_OLD_CONVS = {0: "conv_first", 3: "conv_up1", 6: "conv_up2", 8: "conv_hr", 10: "conv_last"}


def convert_esrgan_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Old-ESRGAN `model.N` serialization → RRDBNet names: model.0 conv_first,
    model.1.sub.N.RDBk.convj.0 body.N.rdbk.convj, model.1.sub.{nb} conv_body,
    model.3/6/8/10 conv_up1/conv_up2/conv_hr/conv_last."""
    if "conv_first.weight" in sd:
        return dict(sd)
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        if not k.startswith("model."):
            continue
        parts = k.split(".")
        idx, leaf = int(parts[1]), parts[-1]
        if idx == 1 and parts[2] == "sub":
            if len(parts) == 5:  # model.1.sub.{nb}.{weight,bias}
                out["conv_body." + leaf] = v
            else:  # model.1.sub.N.RDBk.convj.0.{weight,bias}
                out[f"body.{parts[3]}.{parts[4].lower()}.{parts[5].lower()}.{leaf}"] = v
        elif idx in _OLD_CONVS:
            out[f"{_OLD_CONVS[idx]}.{leaf}"] = v
    return out


def tiled_upscale(img: np.ndarray, fn: Callable[[torch.Tensor], torch.Tensor], scale: int,
                  tile_size: int = ESRGAN_TILE, overlap: int = ESRGAN_TILE_OVERLAP) -> np.ndarray:
    """img [H,W,3] float in [0, 1] → [sH,sW,3] float32. `fn` maps a
    [1,3,t,t] f32 CPU tensor to [1,3,st,st]; tiles overlap by `overlap`
    pixels and blend under a linear feather."""
    def run(tile: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(tile.transpose(2, 0, 1)[None], np.float32))
        return fn(x)[0].float().permute(1, 2, 0).cpu().numpy()

    h, w, _ = img.shape
    if h <= tile_size and w <= tile_size:
        return run(img)

    stride = tile_size - overlap
    out = np.zeros((h * scale, w * scale, 3), np.float32)
    weight = np.zeros((h * scale, w * scale, 1), np.float32)
    ramp = np.minimum(np.arange(1, tile_size * scale + 1), overlap * scale) / (overlap * scale)
    feather2d = np.minimum.outer(np.minimum(ramp, ramp[::-1]),
                                 np.minimum(ramp, ramp[::-1]))[..., None].astype(np.float32)
    for top in range(0, max(h - overlap, 1), stride):
        for left in range(0, max(w - overlap, 1), stride):
            bottom, right = min(top + tile_size, h), min(left + tile_size, w)
            t0, l0 = bottom - min(tile_size, h), right - min(tile_size, w)
            up = run(img[t0:bottom, l0:right])
            fh, fw = up.shape[0], up.shape[1]
            fmask = feather2d[:fh, :fw]
            out[t0 * scale:t0 * scale + fh, l0 * scale:l0 * scale + fw] += up * fmask
            weight[t0 * scale:t0 * scale + fh, l0 * scale:l0 * scale + fw] += fmask
    return out / np.maximum(weight, 1e-6)


# -- registry

class Upscaler:
    def __init__(self, name: str, fn: Callable[[np.ndarray, float], np.ndarray], scale: int = 4):
        self.name = name
        self.fn = fn
        self.scale = scale

    def upscale(self, img: np.ndarray, scale: float) -> np.ndarray:
        return self.fn(img, scale)


def _identity(img, scale):
    return img


def sniff_architecture(keys) -> str:
    """The network a checkpoint holds, by its keys (the reference's order):
    HAT (`overlap_attn`), SwinIR (`residual_group`), DAT
    (`spatial_interaction` and `before_RG`), SCUNet (`trans_block.msa`),
    else ESRGAN's RRDBNet."""
    keys = list(keys)
    if any("overlap_attn" in k for k in keys):
        return "HAT"
    if any("residual_group" in k for k in keys):
        return "SwinIR"
    if (any("spatial_interaction" in k for k in keys)
            and any(k.startswith("before_RG") for k in keys)):
        return "DAT"
    if any("trans_block.msa" in k for k in keys):
        return "SCUNet"
    return "ESRGAN"


def build_network(raw: Mapping[str, Any], device, dtype):
    """An unwrapped checkpoint → (apply_fn [B,3,t,t] → [B,3,st,st] on
    `device` in `dtype`, model scale)."""
    arch = sniff_architecture(raw)
    if arch == "HAT":
        from ..models.hat import hat_apply, infer_hat_meta, load_hat

        params = tree_to(load_hat(raw), device, dtype)
        meta = infer_hat_meta(params)
        return lambda t: hat_apply(params, t, **meta), meta["scale"]
    if arch == "SwinIR":
        from ..models.swinir import infer_swinir_meta, load_swinir, swinir_apply

        params = tree_to(load_swinir(raw), device, dtype)
        meta = infer_swinir_meta(params)
        return lambda t: swinir_apply(params, t, **meta), meta["scale"]
    if arch == "DAT":
        from ..models.dat import dat_apply, infer_dat_meta, load_dat

        params = tree_to(load_dat(raw), device, dtype)
        meta = infer_dat_meta(params)
        return lambda t: dat_apply(params, t, **meta), meta["scale"]
    if arch == "SCUNet":
        from ..models.scunet import infer_scunet_meta, load_scunet, scunet_apply

        params = tree_to(load_scunet(raw), device, dtype)
        meta = infer_scunet_meta(params)
        return lambda t: scunet_apply(params, t, **meta), 1  # a denoiser: scale 1
    params = tree_to(nest(convert_esrgan_keys(raw)), device, dtype)
    return lambda t: rrdbnet_apply(params, t, 4), 4


# a model directory's kind → the options its tiles read (the reference's: any other kind,
# HAT's included, reads ESRGAN's)
TILE_OPTIONS = {"SwinIR": "SWIN", "DAT": "DAT"}


def tile_options(kind: str):
    """(tile, overlap) from the options of `kind`'s directory: a tile of 0
    becomes 192 and an overlap below 1 becomes 1, as in the reference."""
    from ..runtime.options import opts

    key = TILE_OPTIONS.get(kind, "ESRGAN")
    return int(opts.get(f"{key}_tile")) or ESRGAN_TILE, max(int(opts.get(f"{key}_tile_overlap")), 1)


class UpscalerRegistry:
    """Upscalers by name. A network runs on `device` (the card unless given)
    in `dtype` (the device's compute dtype unless given)."""

    def __init__(self, model_dirs: Optional[Dict[str, str]] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        self.model_dirs = model_dirs or {}
        self.device = device
        self.dtype = dtype
        self._gan_cache: Dict[str, Any] = {}
        self.upscalers: Dict[str, Upscaler] = {
            "None": Upscaler("None", _identity, 1),
            "Lanczos": Upscaler("Lanczos", lambda i, s: upscale_pil(i, s, "Lanczos"), 1),
            "Nearest": Upscaler("Nearest", lambda i, s: upscale_pil(i, s, "Nearest"), 1),
        }
        self.discover()

    def discover(self):
        """Each directory's `.safetensors` then `.pth` files, by name; the
        listing says 4 for every file, as the reference's does."""
        for kind, d in self.model_dirs.items():
            for path in sorted(glob.glob(os.path.join(d, "*.safetensors"))
                               + glob.glob(os.path.join(d, "*.pth"))):
                name = os.path.splitext(os.path.basename(path))[0]
                self.upscalers[name] = Upscaler(name, self._make_gan_fn(path, kind), 4)

    def _load_model(self, path: str):
        """→ (apply_fn [1,3,t,t] → [1,3,st,st], scale), loaded once a path."""
        cached = self._gan_cache.get(path)
        if cached is not None:
            return cached
        from .engine import default_device, default_dtype

        raw = load_state_dict(path)
        for wrap in ("params_ema", "params"):
            if isinstance(raw.get(wrap), dict):
                raw = raw[wrap]
                break
        device = torch.device(self.device) if self.device is not None else default_device()
        dtype = self.dtype or default_dtype(device)
        net, model_scale = build_network(raw, device, dtype)

        def apply_fn(t: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return net(t.to(device, dtype))

        self._gan_cache[path] = (apply_fn, model_scale)
        return self._gan_cache[path]

    def _make_gan_fn(self, path: str, kind: str = "ESRGAN"):
        def fn(img: np.ndarray, scale: float) -> np.ndarray:
            apply_fn, model_scale = self._load_model(path)
            x = np.asarray(img, np.float32)
            if x.max() > 1.5:
                x = x / 255.0
            tile, overlap = tile_options(kind)
            out = np.clip(tiled_upscale(x, apply_fn, model_scale, tile_size=tile,
                                        overlap=overlap), 0, 1)
            if abs(scale - model_scale) > 1e-6:
                out = upscale_pil((out * 255).astype(np.uint8), scale / model_scale) / 255.0
            return (out * 255).astype(np.uint8)

        return fn

    def get(self, name: str) -> Upscaler:
        if name in self.upscalers:
            return self.upscalers[name]
        low = (name or "").lower()
        for key, u in self.upscalers.items():
            if key.lower() == low:
                return u
        raise KeyError(f"unknown upscaler {name!r} — available: "
                       + ", ".join(sorted(self.upscalers)))


_DEFAULT_REGISTRY = None


def get_default_registry(device=None) -> UpscalerRegistry:
    """One registry over the standard models/ directories, shared by the
    callers that do not bring their own (the hires fix, the API's extras),
    made once a process on `device` (the card unless given)."""
    global _DEFAULT_REGISTRY
    if _DEFAULT_REGISTRY is None:
        _DEFAULT_REGISTRY = UpscalerRegistry(model_dirs={
            "ESRGAN": "models/ESRGAN", "RealESRGAN": "models/RealESRGAN",
            "SwinIR": "models/SwinIR", "DAT": "models/DAT", "HAT": "models/HAT",
        }, device=device)
    return _DEFAULT_REGISTRY

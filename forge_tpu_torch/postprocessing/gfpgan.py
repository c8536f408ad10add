# Copied from forge_tpu/postprocessing/gfpgan.py (gfpgan_apply, GFPGAN's load and restore, get_gfpgan), in PyTorch.
"""GFPGAN v1 (Clean) face restoration (TencentARC/GFPGAN
gfpganv1_clean_arch.py and stylegan2_clean_arch.py).

A U-Net strips the degradations and gives a W+ style code (from its 4×4
bottleneck) and per-resolution SFT scale and shift conditions; a StyleGAN2
(clean) decoder with modulated convs synthesizes the face, the conditions
acting on the second half of its channels. The stored `noises` buffers are
used (no random draw), as the reference uses them. Parameters are the
released GFPGANv1.4 keys (`conv_body_first`, `conv_body_down.N`,
`final_conv`, `final_linear`, `conv_body_up.N`, `condition_scale/shift.N`,
`stylegan_decoder.*`) in their own layout: modulated conv weights
[1, O, I, k, k], noise [1, 1, H, W], the constant input [1, C, 4, 4]. NCHW;
resamples are the reference's `jax.image.resize` bilinear (antialiased
when halving; ops/resize.py), modulated convs one grouped conv a batch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _interp2x(x: torch.Tensor, up: bool = True) -> torch.Tensor:
    h, w = x.shape[2:]
    return resize(x, (h * 2, w * 2) if up else (h // 2, w // 2), "bilinear")


def _resblock(p: Mapping[str, Any], x: torch.Tensor, up: bool) -> torch.Tensor:
    """conv → lrelu → resample → conv → lrelu, plus a resampled 1×1 skip."""
    h = _interp2x(_lrelu(nn.conv2d(x, p["conv1"], padding=1)), up)
    h = _lrelu(nn.conv2d(h, p["conv2"], padding=1))
    return h + nn.conv2d(_interp2x(x, up), p["skip"])


def _modulated_conv(p: Mapping[str, Any], x: torch.Tensor, style: torch.Tensor,
                    demodulate: bool, upsample: bool = False) -> torch.Tensor:
    """stylegan2_clean_arch ModulatedConv2d: the weight [1,O,I,k,k] scaled by
    the style per sample (and demodulated), one grouped conv over the batch."""
    w = p["weight"][0].to(x.dtype)  # [O, I, k, k]
    o, i, k, _ = w.shape
    s = nn.linear(style, p["modulation"])  # [B, I]
    wmod = w[None] * s[:, None, :, None, None]
    if demodulate:
        wmod = wmod * torch.rsqrt(wmod.square().sum(dim=(2, 3, 4)) + 1e-8)[:, :, None, None, None]
    if upsample:
        x = _interp2x(x, True)
    b, _, hh, ww = x.shape
    out = F.conv2d(x.reshape(1, b * i, hh, ww), wmod.reshape(b * o, i, k, k), padding=k // 2,
                   groups=b)
    return out.reshape(b, o, hh, ww)


def _bias(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype).reshape(1, -1, 1, 1)


def _style_conv(p: Mapping[str, Any], x, style, noise, up: bool = False) -> torch.Tensor:
    out = _modulated_conv(p["modulated_conv"], x, style, True, up) * (2 ** 0.5)
    out = out + p["weight"].to(x.dtype).reshape(()) * noise.to(x.dtype)
    return _lrelu(out + _bias(p["bias"], x.dtype))


def _to_rgb(p: Mapping[str, Any], x, style, skip=None) -> torch.Tensor:
    out = _modulated_conv(p["modulated_conv"], x, style, False) + _bias(p["bias"], x.dtype)
    return out if skip is None else out + _interp2x(skip, True)


def gfpgan_apply(params: Mapping[str, Any], img: torch.Tensor, sft_half: bool = True) -> torch.Tensor:
    """img [B,3,512,512] in [−1, 1] → restored [B,3,512,512] in [−1, 1]."""
    dec = params["stylegan_decoder"]
    n_levels = len(params["conv_body_down"])  # log2(size) − 2
    feat = _lrelu(nn.conv2d(img, params["conv_body_first"]))
    skips: List[torch.Tensor] = []
    for i in range(n_levels):
        feat = _resblock(params["conv_body_down"][str(i)], feat, up=False)
        skips.insert(0, feat)
    feat = _lrelu(nn.conv2d(feat, params["final_conv"], padding=1))
    b = feat.shape[0]
    style = nn.linear(feat.reshape(b, -1), params["final_linear"])
    num_style_feat = dec["style_conv1"]["modulated_conv"]["modulation"]["weight"].shape[1]
    latent = style.reshape(b, -1, num_style_feat)  # W+

    conditions: List[torch.Tensor] = []
    for i in range(n_levels):
        feat = _resblock(params["conv_body_up"][str(i)], feat + skips[i], up=True)
        for which in ("condition_scale", "condition_shift"):
            q = params[which][str(i)]
            conditions.append(nn.conv2d(_lrelu(nn.conv2d(feat, q["0"], padding=1)), q["2"],
                                        padding=1))

    noises = dec["noises"]
    const = dec["constant_input"]["weight"].to(img.dtype)
    out = const.expand(b, *const.shape[1:])
    out = _style_conv(dec["style_conv1"], out, latent[:, 0], noises["noise0"])
    skip = _to_rgb(dec["to_rgb1"], out, latent[:, 1])
    li = 1
    for level in range(n_levels):
        out = _style_conv(dec["style_convs"][str(2 * level)], out, latent[:, li],
                          noises[f"noise{2 * level + 1}"], up=True)
        sc, sh = conditions[2 * level], conditions[2 * level + 1]
        if sft_half:  # SFT on the second channel half
            half = out.shape[1] // 2
            out = torch.cat([out[:, :half], out[:, half:] * sc + sh], dim=1)
        else:
            out = out * sc + sh
        out = _style_conv(dec["style_convs"][str(2 * level + 1)], out, latent[:, li + 1],
                          noises[f"noise{2 * level + 2}"])
        skip = _to_rgb(dec["to_rgbs"][str(level)], out, latent[:, li + 2], skip)
        li += 2
    return skip.clamp(-1.0, 1.0)


class GFPGAN:
    """The GFPGAN restorer (reference gfpgan_model.py): the first `.pth`,
    `.pt` or `.safetensors` file of `model_dir`, its `params_ema`, `params`
    or `g_ema` wrapper unwrapped, on `device` (the card unless given) in
    `dtype` (the device's compute dtype unless given). `restore` crops each face, restores it at 512² and pastes it
    back (faces.restore_faces_in_image); `w` is taken and not read, as the
    reference's."""

    name = "GFPGAN"

    def __init__(self, model_dir: str = "models/GFPGAN", device=None, params=None,
                 dtype: Optional[torch.dtype] = None):
        self.model_dir = model_dir
        self.device = device
        self.dtype = dtype
        self.params: Optional[Dict[str, Any]] = params

    def _paths(self) -> List[str]:
        if not os.path.isdir(self.model_dir):
            return []
        return [os.path.join(self.model_dir, f) for f in sorted(os.listdir(self.model_dir))
                if f.endswith((".pth", ".pt", ".safetensors"))]

    @property
    def available(self) -> bool:
        return self.params is not None or bool(self._paths())

    def load(self) -> Dict[str, Any]:
        if self.params is None:
            from ..core.convert import nest, tree_to
            from ..core.state_dict import load_state_dict
            from ..pipeline.engine import default_device, default_dtype
            from .faces import RestorerMissing

            paths = self._paths()
            if not paths:
                raise RestorerMissing(f"no GFPGAN checkpoint under {self.model_dir}")
            sd = load_state_dict(paths[0])
            for wrap in ("params_ema", "params", "g_ema"):
                if isinstance(sd.get(wrap), dict):
                    sd = sd[wrap]
                    break
            device = torch.device(self.device) if self.device is not None else default_device()
            dtype = self.dtype or default_dtype(device)
            self.params = tree_to(nest(dict(sd)), device, dtype)
        return self.params

    def restore_crop(self, crop: np.ndarray) -> np.ndarray:
        """A uint8 face crop → the restored crop, float32 in [0, 255], at the
        crop's size (512² in and out, through OpenCV's linear resize)."""
        from ..pipeline.images import cv2_linear_resize

        params = self.load()
        leaf = params["conv_body_first"]["weight"]
        face = cv2_linear_resize(crop.astype(np.uint8), 512, 512)
        x = torch.from_numpy(face.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None]
        with torch.no_grad():
            y = gfpgan_apply(params, x.to(leaf.device, leaf.dtype))
        out = ((y[0].float().permute(1, 2, 0).cpu().numpy() + 1.0) * 127.5).clip(0, 255)
        return cv2_linear_resize(out.astype(np.float32), crop.shape[1], crop.shape[0])

    def restore(self, image: np.ndarray, w: Optional[float] = None) -> np.ndarray:
        from .faces import restore_faces_in_image

        self.load()
        return restore_faces_in_image(image, self.restore_crop)


_MODEL: Optional[GFPGAN] = None


def get_gfpgan(device=None) -> GFPGAN:
    global _MODEL
    if _MODEL is None:
        _MODEL = GFPGAN(device=device)
    return _MODEL


"""LaMa inpainting, big-lama's FFC ResNet generator, for inpaint_only+lama
(port of forge_tpu/preprocessors/lama.py).

The network the reference's forge_preprocessor_inpaint runs
(annotator/lama/saicinpainting/training/modules/ffc.py FFCResNetGenerator,
scripts/lama_config.yaml: input_nc 4, ngf 64, three downsamples, 18 FFC
resnet blocks at ratio 0.75, a sigmoid output, no LFU). A Fast Fourier
Convolution splits the channels into a local path (reflect-padded 3×3
convs) and a global one whose SpectralTransform takes `torch.fft.rfft2`,
a 1×1 conv over the interleaved (real, imaginary) channel pairs and
`irfft2`, in f32 (arXiv:2109.07161). The structure comes from the
checkpoint's shapes: the kernel size tells the 7×7 stem and head from the
3×3 stages, and the bare 3×3 transpose convs between BatchNorms are the
upsamplers.

The flow is the reference's `lama_apply` and `inpaint`
(preprocessor_inpaint.py:118-158): the short side to 256 in multiples of 8
(OpenCV's INTER_AREA, the mask INTER_LINEAR and binarized), the masked
colour and the mask as a 4-channel feed, the prediction pasted under the
mask, back to the image's size (INTER_CUBIC), and blended with the image
under the soft mask. Checkpoint: the first .pth/.pt/.safetensors/.ckpt under
models/lama (ControlNetLama.pth; `generator.` dropped, the `model.*` keys
kept).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, inference, to_numpy


def _bn(x: torch.Tensor, p: Mapping[str, Any], eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over the channels, f32 statistics."""
    shape = (1, -1, 1, 1)
    y = (x.float() - p["running_mean"].float().reshape(shape)) \
        * torch.rsqrt(p["running_var"].float().reshape(shape) + eps)
    if p.get("weight") is not None:
        y = y * p["weight"].float().reshape(shape)
    if p.get("bias") is not None:
        y = y + p["bias"].float().reshape(shape)
    return y.to(x.dtype)


def _reflect_conv(x: torch.Tensor, p: Mapping[str, Any], stride: int = 1) -> torch.Tensor:
    """Conv2d with padding_mode='reflect'."""
    pad = p["weight"].shape[-1] // 2
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return nn.conv2d(x, p, stride=stride)


def _fourier_unit(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """rfft2 → 1×1 conv on interleaved (re, im) channel pairs → irfft2
    (ffc.py:76-114), the transforms in f32."""
    b, c, h, w = x.shape
    f = torch.fft.rfft2(x.float(), norm="ortho")
    fr = torch.stack([f.real, f.imag], dim=2).reshape(b, 2 * c, h, f.shape[-1])
    y = F.relu(_bn(nn.conv2d(fr.to(x.dtype), p["conv_layer"]), p["bn"]))
    yc = y.float().reshape(b, y.shape[1] // 2, 2, h, f.shape[-1])
    out = torch.fft.irfft2(torch.complex(yc[:, :, 0], yc[:, :, 1]), s=(h, w), norm="ortho")
    return out.to(x.dtype)


def _spectral_transform(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    y = F.relu(_bn(nn.conv2d(x, p["conv1"]["0"]), p["conv1"]["1"]))
    return nn.conv2d(y + _fourier_unit(p["fu"], y), p["conv2"])  # no LFU


def _ffc(p: Mapping[str, Any], xl, xg, stride: int = 1):
    """The four-way local/global mix (ffc.py:257-277); an absent submodule
    is torch's Identity placeholder, which holds no keys."""
    out_l = out_g = None

    def acc(a, b):
        return b if a is None else a + b

    if "convl2l" in p and xl is not None:
        out_l = acc(out_l, _reflect_conv(xl, p["convl2l"], stride))
    if "convg2l" in p and xg is not None:
        out_l = acc(out_l, _reflect_conv(xg, p["convg2l"], stride))
    if "convl2g" in p and xl is not None:
        out_g = acc(out_g, _reflect_conv(xl, p["convl2g"], stride))
    if "convg2g" in p and xg is not None:
        out_g = acc(out_g, _spectral_transform(p["convg2g"], xg))
    return out_l, out_g


def _ffc_bn_act(p: Mapping[str, Any], xl, xg, stride: int = 1):
    yl, yg = _ffc(p["ffc"], xl, xg, stride)
    if yl is not None and "bn_l" in p:
        yl = F.relu(_bn(yl, p["bn_l"]))
    if yg is not None and "bn_g" in p:
        yg = F.relu(_bn(yg, p["bn_g"]))
    return yl, yg


def _resblock(p: Mapping[str, Any], xl, xg):
    il, ig = xl, xg
    xl, xg = _ffc_bn_act(p["conv2"], *_ffc_bn_act(p["conv1"], xl, xg))
    return (il + xl if il is not None else xl), (ig + xg if ig is not None else xg)


def lama_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,4,H,W] (masked colour ⊕ mask) → [B,3,H,W] in [0,1], f32. H and
    W are multiples of 8 (three stride-2 stages)."""
    m = params["model"]
    xl, xg = x, None
    for i in sorted(int(k) for k in m):
        sub = m[str(i)]
        if "ffc" in sub:
            k = next(sub["ffc"][c]["weight"].shape[-1] for c in ("convl2l", "convg2l")
                     if c in sub["ffc"])
            xl, xg = _ffc_bn_act(sub, xl, xg, stride=2 if k == 3 else 1)
        elif "conv1" in sub:
            xl, xg = _resblock(sub, xl, xg)
        elif "running_mean" in sub:
            xl = F.relu(_bn(xl, sub))
        elif "weight" in sub and sub["weight"].dim() == 4:
            if xg is not None:  # the ConcatTupleLayer before the first upsample
                xl, xg = torch.cat([xl, xg], dim=1), None
            if sub["weight"].shape[-1] == 3:  # an upsampling ConvTranspose2d
                xl = nn.conv2d_transpose(xl, sub, stride=2, padding=1, output_padding=1)
            else:  # the 7×7 output head, reflect pad 3
                xl = _reflect_conv(xl, sub)
    return torch.sigmoid(xl.float())


def _convert(sd):
    sd = {k[len("generator."):] if k.startswith("generator.") else k: v for k, v in sd.items()}
    return {k: v for k, v in sd.items() if k.startswith("model.")}


class LamaDetector(Detector):
    DTYPE = torch.bfloat16  # PERF.md §4

    def __init__(self, model_dir: str = "models/lama", **kw):
        super().__init__(model_dir, suffixes=(".pth", ".pt", ".safetensors", ".ckpt"),
                         convert=_convert, missing="no LaMa checkpoint", **kw)

    def inpaint(self, img_u8: np.ndarray, mask_f: np.ndarray) -> np.ndarray:
        """uint8 [H,W,3] and a float [H,W] mask → the inpainted uint8 [H,W,3]."""
        params = self.load()
        H, W = img_u8.shape[:2]
        scale = 256.0 / min(H, W)
        nh = max(int(round(H * scale / 8)) * 8, 8)
        nw = max(int(round(W * scale / 8)) * 8, 8)
        color = cv2_np.resize(img_u8, (nw, nh), cv2_np.INTER_AREA).astype(np.float32) / 255.0
        mask = cv2_np.resize(np.asarray(mask_f, np.float32), (nw, nh), cv2_np.INTER_LINEAR)
        mask = (mask > 0.5).astype(np.float32)[..., None]
        color = color * (1.0 - mask)
        with inference():
            pred = lama_apply(params, self.image_tensor(np.concatenate([color, mask], -1)))
        pred = to_numpy(pred[0]).transpose(1, 2, 0)
        pred = pred * mask + color * (1.0 - mask)
        pred = cv2_np.resize((pred * 255.0).clip(0, 255).astype(np.uint8), (W, H),
                             cv2_np.INTER_CUBIC)
        alpha = np.clip(mask_f, 0.0, 1.0)[..., None]
        out = pred.astype(np.float32) * alpha + img_u8.astype(np.float32) * (1 - alpha)
        return out.clip(0, 255).astype(np.uint8)


_DETECTOR: Optional[LamaDetector] = None


def get_lama(device=None) -> LamaDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = LamaDetector(device=device)
    return _DETECTOR


def _available_lama() -> LamaDetector:
    det = get_lama()
    if not det.available:
        raise RuntimeError("inpaint_only+lama needs the LaMa generator checkpoint "
                           "(ControlNetLama.pth) under models/lama")
    return det


def lama_prefill(img_u8: np.ndarray, mask_f: np.ndarray) -> np.ndarray:
    return _available_lama().inpaint(img_u8, mask_f)


def inpaint_only_lama(img, res, a, b):
    """The registry's entry: the image itself (the pre-fill runs on the unit's
    path), once the checkpoint is known to be there, as the reference's."""
    from .cv import resize_image

    _available_lama()
    return np.asarray(resize_image(img, res), np.float32) / 255.0

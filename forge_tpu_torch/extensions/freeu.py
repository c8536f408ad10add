"""FreeU (arXiv:2309.11497; port of forge_tpu/extensions/freeu.py): on the
two widest decoder stages the backbone's first half of channels is scaled by
b1/b2 (the channel mean kept) and the skip's lowest frequencies by s1/s2.
One `output_block_patch` hook, on NCHW tensors: the channels are dim 1 and
the spectrum is over dims 2 and 3, in float32."""

from __future__ import annotations

from typing import Dict

import torch


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred 2·threshold box of x's shifted 2-D spectrum (NCHW)."""
    dtype = x.dtype
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(2, 3)), dim=(2, 3))
    h, w = x.shape[2:]
    ch, cw = h // 2, w // 2
    mask = torch.ones((1, 1, h, w), dtype=torch.float32, device=x.device)
    mask[..., ch - threshold:ch + threshold, cw - threshold:cw + threshold] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(2, 3))
    return torch.fft.ifftn(xf, dim=(2, 3)).real.to(dtype)


def build_freeu_hooks(model_channels: int = 320, b1: float = 1.01, b2: float = 1.02,
                      s1: float = 0.99, s2: float = 0.95) -> Dict[str, object]:
    """→ {"output_block_patch": (hook,)} acting where h has model_channels·4
    (b1, s1) or ·2 (b2, s2) channels."""
    scale_map = {model_channels * 4: (b1, s1), model_channels * 2: (b2, s2)}

    def output_block_patch(h, skip, block_id):
        c = h.shape[1]
        if c in scale_map:
            b, s = scale_map[c]
            half = c // 2
            hmean = h.mean(dim=1, keepdim=True)
            h = torch.cat([h[:, :half] * b, h[:, half:]], dim=1)
            h = h - (h.mean(dim=1, keepdim=True) - hmean)
            skip = fourier_filter(skip, threshold=1, scale=s)
        return h, skip

    return {"output_block_patch": (output_block_patch,)}

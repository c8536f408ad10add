# Copied from forge_tpu/pipeline/preview.py (the factor tables and latent_to_rgb_cheap); NCHW in.
"""The live preview's cheapest decoder: one 4×3 matmul from latent to RGB
(the reference's "Approx cheap", sd_samplers_common.py:39-76), on the host."""

from __future__ import annotations

import numpy as np

# 4-channel latent → RGB linear approximations (public constants used across
# SD tooling for live previews)
_SD15_FACTORS = np.asarray(
    [
        [0.298, 0.207, 0.208],
        [0.187, 0.286, 0.173],
        [-0.158, 0.189, 0.264],
        [-0.184, -0.271, -0.473],
    ],
    np.float32,
)
_SDXL_FACTORS = np.asarray(
    [
        [0.3651, 0.4232, 0.4341],
        [-0.2533, -0.0042, 0.1068],
        [0.1076, 0.1111, -0.0362],
        [-0.3165, -0.2492, -0.2188],
    ],
    np.float32,
)


def latent_to_rgb_cheap(latent, family: str = "sd15") -> np.ndarray:
    """latent [B,C,h,w] (regulated space; numpy or a tensor) → uint8 [B,h,w,3]
    preview, with SDXL's factors for the SDXL base and refiner and SD1.5's
    for every other family."""
    factors = _SDXL_FACTORS if family in ("sdxl", "sdxl_refiner") else _SD15_FACTORS
    if not isinstance(latent, np.ndarray):
        latent = latent.detach().float().cpu().numpy()
    lat = np.asarray(latent, np.float32).transpose(0, 2, 3, 1)
    c = min(lat.shape[-1], factors.shape[0])
    rgb = lat[..., :c] @ factors[:c]
    rgb = (rgb + 1.0) / 2.0
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

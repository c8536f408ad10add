# Copied from forge_tpu/core/latent_formats.py; stdlib only, so the port imports no JAX.
# `ChannelLatentFormat` takes NCHW tensors (the port's layout) and broadcasts over their channel axis.
"""Latent regulation (scale/shift) per model family — the reference's
`process_in/out` latent "regulation" on the VAE patcher (backend/nn/vae.py,
patcher/vae.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LatentFormat:
    scale_factor: float = 0.18215
    shift_factor: float = 0.0
    latent_channels: int = 4

    def process_in(self, latent):
        return (latent - self.shift_factor) * self.scale_factor

    def process_out(self, latent):
        return latent / self.scale_factor + self.shift_factor


@dataclasses.dataclass(frozen=True)
class ChannelLatentFormat(LatentFormat):
    """Per-channel mean/std regulation (Playground v2.5 vae config
    latents_mean/latents_std with scaling_factor 0.5)."""

    mean: tuple = (0.0, 0.0, 0.0, 0.0)
    std: tuple = (1.0, 1.0, 1.0, 1.0)

    def _stats(self, latent):
        """mean and std as [1, C, 1, …] tensors in latent's dtype, on its device."""
        shape = (1, -1) + (1,) * (latent.dim() - 2)
        return latent.new_tensor(self.mean).reshape(shape), latent.new_tensor(self.std).reshape(shape)

    def process_in(self, latent):
        m, s = self._stats(latent)
        return (latent - m) * (self.scale_factor / s)

    def process_out(self, latent):
        m, s = self._stats(latent)
        return latent * (s / self.scale_factor) + m


SD15 = LatentFormat(scale_factor=0.18215)
SDXL = LatentFormat(scale_factor=0.13025)
SD3 = LatentFormat(scale_factor=1.5305, shift_factor=0.0609, latent_channels=16)
FLUX = LatentFormat(scale_factor=0.3611, shift_factor=0.1159, latent_channels=16)
PLAYGROUND = ChannelLatentFormat(
    scale_factor=0.5,
    mean=(-1.6574, 1.886, -1.383, 2.5155),
    std=(8.4927, 5.9022, 6.5498, 5.2299),
)

BY_FAMILY = {
    "sd15": SD15,
    "sd20": SD15,
    "sdxl": SDXL,
    "sdxl_refiner": SDXL,
    "playground": PLAYGROUND,
    "kolors": SDXL,
    "sd3": SD3,
    "flux": FLUX,
    "chroma": FLUX,
}

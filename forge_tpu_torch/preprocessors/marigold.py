"""Marigold diffusion depth (depth_marigold) (port of
forge_tpu/preprocessors/marigold.py).

The reference's marigold extension (forge_preprocessor_marigold/marigold/
model/marigold_pipeline.py): the SD2 VAE encodes the RGB image, a
fine-tuned SD2 UNet whose conv_in takes 8 channels denoises a depth latent
beside the RGB latent (the RGB latent first: marigold_pipeline.py:254-256)
under the empty prompt's embedding, and the channel mean of the VAE's
decode is the depth (stacked_depth_AE.py:49-53). The UNet is the port's
models/unet.py at SD2's geometry (heads of 64), so its ResBlocks run the
fused GroupNorm+SiLU+conv3x3 kernel and its self-attention at 4096 and
1024 tokens the flash kernel on the card, as the VAE's do; the reference
runs its UNet at its default 8 heads of any width (shown from both sides
in tests/test_torch_marigold.py). The empty prompt is the 2-token
[BOS, EOS] sequence ("do_not_pad", marigold_pipeline.py:303-313) through
the bundled OpenCLIP-H text encoder (models/clip.py), once.

DDIM follows the SD2 scheduler config the reference loads: scaled-linear
betas, "leading" spacing with steps_offset 1, alphas_cumprod[0] as the
final alpha (set_alpha_to_one false); eps or v prediction. The start noise
is `np.random.default_rng(seed)`'s standard normal in the reference's
NHWC order, so both packages start from the same latent. The image goes to
multiples of 64 by OpenCV's INTER_AREA and the map back by INTER_LINEAR
(preprocessors/cv2_np.py).

Checkpoint: the first .safetensors/.sft/.pt under models/marigold, one
file with `unet.` (the ldm keys, or diffusers' converted by
`diffusers_unet_to_ldm`), `vae.` and `text_encoder.` prefixes;
`prediction_type` from the safetensors metadata, epsilon without it (the
reference's reader drops the metadata and always takes epsilon).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..core.state_dict import diffusers_unet_to_ldm, filter_prefix
from . import cv2_np
from .annotator import Detector, inference, to_numpy
from .cv import resize_image

LATENT_SCALE = 0.18215
_BOS, _EOS = 49406, 49407


def safetensors_metadata(path: str) -> Dict[str, str]:
    """A .safetensors file's `__metadata__` ({} where it has none)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        return dict(json.loads(f.read(n)).get("__metadata__") or {})


class MarigoldPipeline:
    """The three networks' weights (core/loader.py `to_device_tree`: the fused
    convs' weights channels_last on the card) and the DDIM loop."""

    def __init__(self, unet, vae, text=None, prediction_type: str = "epsilon"):
        self.unet, self.vae = unet, vae
        self.prediction_type = prediction_type
        self.empty_embed = None if text is None else self._empty_text_embed(text)

    @staticmethod
    @torch.no_grad()
    def _empty_text_embed(text) -> torch.Tensor:
        from ..models.clip import clip_text_apply

        device = text["text_model"]["embeddings"]["token_embedding"]["weight"].device
        final, _, _ = clip_text_apply(text, torch.tensor([[_BOS, _EOS]], device=device))
        return final  # [1, 2, width]

    @classmethod
    def from_file(cls, path: str, device, dtype: torch.dtype) -> "MarigoldPipeline":
        from ..core.loader import to_device_tree
        from ..core.state_dict import load_state_dict

        sd = load_state_dict(path)
        meta = safetensors_metadata(path) if path.endswith((".safetensors", ".sft")) else {}
        unet_sd = filter_prefix(sd, "unet.")
        if any(k.startswith("down_blocks.") for k in unet_sd):
            unet_sd = diffusers_unet_to_ldm(unet_sd)
        text_sd = filter_prefix(sd, "text_encoder.")
        return cls(to_device_tree(unet_sd, dtype, device),
                   to_device_tree(filter_prefix(sd, "vae."), dtype, device),
                   to_device_tree(text_sd, dtype, device) if text_sd else None,
                   prediction_type=str(meta.get("prediction_type", "epsilon")))

    @torch.no_grad()
    def infer(self, rgb: torch.Tensor, noise: torch.Tensor, steps: int) -> torch.Tensor:
        """rgb [1,3,H,W] in [-1,1], noise [1,4,h,w] f32 → depth [H,W] in [-1,1], f32."""
        from ..models.unet import UNetConfig, unet_apply
        from ..models.vae import vae_decode, vae_encode
        from ..sampling.prediction import make_beta_schedule

        cfg = UNetConfig(context_dim=self.empty_embed.shape[-1], head_dim=64)  # SD2's geometry
        dtype = self.empty_embed.dtype
        rgb_latent = vae_encode(self.vae, rgb.to(dtype)).float() * LATENT_SCALE
        alphas = torch.from_numpy(np.cumprod(1.0 - make_beta_schedule(1000), axis=0)
                                  .astype(np.float32)).to(rgb.device)
        ratio = 1000 // steps  # "leading" spacing, steps_offset 1
        ts = (np.arange(steps) * ratio)[::-1] + 1
        latent = noise.float()
        for t in ts.tolist():
            t_prev = t - ratio
            a_t = alphas[t]
            a_prev = alphas[t_prev] if t_prev >= 0 else alphas[0]  # set_alpha_to_one false
            x_in = torch.cat([rgb_latent, latent], dim=1).to(dtype)
            timesteps = torch.full((1,), float(t), device=rgb.device)
            pred = unet_apply(self.unet, x_in, timesteps, self.empty_embed, cfg=cfg).float()
            if self.prediction_type == "v_prediction":
                x0 = a_t.sqrt() * latent - (1.0 - a_t).sqrt() * pred
                eps = a_t.sqrt() * pred + (1.0 - a_t).sqrt() * latent
            else:
                x0 = (latent - (1.0 - a_t).sqrt() * pred) / a_t.sqrt()
                eps = pred
            latent = a_prev.sqrt() * x0 + (1.0 - a_prev).sqrt() * eps
        decoded = vae_decode(self.vae, (latent / LATENT_SCALE).to(dtype)).float()
        return decoded[0].mean(dim=0).clamp(-1.0, 1.0)

    def run(self, img: np.ndarray, steps: int = 20, seed: int = 0) -> np.ndarray:
        """uint8 [H,W,3] (H, W % 64 == 0) → the depth map uint8 [H,W,3]
        (preprocessor_marigold.py:59-64: depth = 0.5 − pred·0.5)."""
        if self.empty_embed is None:
            raise RuntimeError("marigold checkpoint has no text_encoder.*")
        h, w = img.shape[:2]
        device = self.empty_embed.device
        rgb = torch.from_numpy(np.ascontiguousarray(
            img.astype(np.float32).transpose(2, 0, 1)[None]) / 127.5 - 1.0).to(device)
        noise = np.random.default_rng(seed).standard_normal((1, h // 8, w // 8, 4))
        noise = torch.from_numpy(noise.astype(np.float32).transpose(0, 3, 1, 2).copy())
        with inference():
            depth = to_numpy(self.infer(rgb, noise.to(device), int(steps)))
        out = ((0.5 - depth * 0.5) * 255.0).clip(0, 255).astype(np.uint8)
        return np.repeat(out[..., None], 3, axis=2)


class MarigoldDetector(Detector):
    DTYPE = torch.bfloat16  # PERF.md §4

    def __init__(self, model_dir: str = "models/marigold", **kw):
        super().__init__(model_dir, suffixes=(".safetensors", ".sft", ".pt"),
                         missing="no Marigold checkpoint", **kw)

    def load(self) -> MarigoldPipeline:
        if self.params is None:
            path = self.path()
            if path is None:
                raise RuntimeError(f"{self.missing} under {self.model_dir}")
            self.params = MarigoldPipeline.from_file(path, *self.placement())
        return self.params

    def detect(self, img: np.ndarray, steps: int = 20, seed: int = 0) -> np.ndarray:
        pipe = self.load()
        h, w = img.shape[:2]
        # a latent-friendly size (multiples of 64), as the reference's resize_image_with_pad
        nh, nw = max(64, int(round(h / 64)) * 64), max(64, int(round(w / 64)) * 64)
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_AREA) if (nh, nw) != (h, w) else img
        out = pipe.run(feed, steps=steps, seed=seed)
        if (nh, nw) != (h, w):
            out = cv2_np.resize(out, (w, h), cv2_np.INTER_LINEAR)
        return out


_DETECTOR: Optional[MarigoldDetector] = None


def get_marigold(device=None) -> MarigoldDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = MarigoldDetector(device=device)
    return _DETECTOR


def depth_marigold(img, res, a, b):
    return np.asarray(get_marigold().detect(resize_image(img, res)), np.float32) / 255.0

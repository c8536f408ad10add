"""Diffusion engine: one loaded checkpoint bound into runnable functions
(port of forge_tpu/pipeline/engine.py: SD1.5, SDXL base and refiner, and
Flux; the VAE encode for img2img; ControlNets beside the UNet).

SDXL: CLIP-L's and CLIP-G's penultimate hidden states, concatenated, are the
context; `y` is CLIP-G's projected pooled output and the sinusoidal
embeddings of the original size, crop and target size. The SDXL refiner:
CLIP-G's penultimate hidden states alone are the context; `y` is its pooled
output and the embeddings of the original size, crop and the aesthetic
score (6.0, or 2.5 for a negative prompt; 2560 wide). Flux: T5-XXL features
are the context, CLIP-L's pooled output the `y` vector, and the distilled-CFG
guidance scale is added to the conditioning at sampling time
(pipeline/processing.py). `upscalers` (pipeline/upscalers.py), when set, is
the registry the hires fix's pixel mode takes its upscaler from.
`lora_registry` (pipeline/extra_networks.py), when
set, resolves the prompt's `<lora:name:weight>` tags. The decode is split in
two, `decode_dispatch` (enqueue, no wait) and `decode_finish` (wait, NaN
checks), so the serving pipeline can overlap one request's copy to the host
with the next request's denoise.

Compute dtype is bf16 on CUDA and f32 on the CPU, as the reference picks
bf16 on the TPU and f32 elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import latent_formats
from ..core.loader import FAMILIES, LoadedCheckpoint, load_checkpoint_parts
from ..models import flux as flux_mod
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from ..models.controlnet import run_controlnets
from ..ops import nn
from ..sampling.prediction import DiscretePrediction, PredictionFlux
from ..text.engine import ClassicTextEngine, TextEncoderOptions
from ..text.t5_engine import T5TextEngine
from ..text.tokenizer import default_tokenizer

_NAN_MESSAGES = {
    "unet": ("A tensor with NaNs was produced in the UNet. This could be caused by a "
             "model trained in a different precision, a broken LoRA, or bad "
             "conditioning. Try float32 compute dtype."),
    "vae": ("A tensor with NaNs was produced in the VAE. Use a fixed fp16-safe VAE "
            "or float32 VAE dtype."),
}


class NansException(RuntimeError):
    pass


def raise_nans(where: str):
    raise NansException(_NAN_MESSAGES[where])


@dataclasses.dataclass
class DecodeHandle:
    """A decode in flight: uint8 images and [latent finite, image finite]
    flags (host tensors on CUDA, filled once `done` has passed)."""
    images: torch.Tensor
    flags: torch.Tensor
    done: Optional["torch.cuda.Event"]


def default_device() -> torch.device:
    """The device an engine runs on unless the caller names one: the CUDA
    card. Where there is none this raises; the CPU is taken only on request."""
    if not torch.cuda.is_available():
        raise RuntimeError("forge_tpu_torch: no CUDA device found; pass device=\"cpu\" "
                           "to run on the CPU")
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


class DiffusionEngine:
    def __init__(self, loaded: LoadedCheckpoint, device, compute_dtype: torch.dtype):
        if loaded.family not in FAMILIES:
            raise NotImplementedError(f"{loaded.family} is not ported yet (ported: {FAMILIES})")
        self.family = loaded.family
        self.loaded = loaded
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.latent_format = latent_formats.BY_FAMILY[loaded.family]
        self.unet_cfg = None
        self.flux_cfg = None
        self.lora_registry = None
        self.upscalers = None
        tes = loaded.text_encoders
        self.text_engines = {}
        tokenizer = default_tokenizer()
        if loaded.family == "sdxl":  # each tower's heads and activation follow its width
            for name, pooled in (("clip_l", False), ("clip_g", True)):
                self.text_engines[name] = ClassicTextEngine(
                    tes[name], tokenizer,
                    TextEncoderOptions(layer="hidden", pooled_projection=pooled))
        elif loaded.family == "sdxl_refiner":
            self.text_engines["clip_g"] = ClassicTextEngine(
                tes["clip_g"], tokenizer, TextEncoderOptions(layer="hidden", pooled_projection=True))
        elif "clip_l" in tes:
            self.text_engines["clip_l"] = ClassicTextEngine(tes["clip_l"], tokenizer)
        if loaded.family == "flux":
            hidden = loaded.unet["img_in"]["weight"].shape[0]
            self.flux_cfg = flux_mod.FluxConfig(num_heads=max(hidden // 128, 1),
                                                guidance_embed="guidance_in" in loaded.unet)
            self.predictor = PredictionFlux()
            if "t5xxl" in tes:
                self.text_engines["t5xxl"] = T5TextEngine(tes["t5xxl"])
        else:
            self.unet_cfg = unet_mod.UNetConfig.for_family(loaded.family)
            self.predictor = DiscretePrediction(prediction_type=loaded.prediction)

    def set_clip_skip(self, clip_skip: int):
        """Clip-skip moves only the engines that read the last layer; SDXL's
        read a fixed hidden layer."""
        for eng in self.text_engines.values():
            if isinstance(eng, ClassicTextEngine) and eng.opts.layer == "last":
                eng.opts.clip_skip = clip_skip

    def get_learned_conditioning(self, prompts: List[str], width: int = 512, height: int = 512,
                                 max_chunks: Optional[int] = None,
                                 crop: Tuple[int, int] = (0, 0),
                                 original_size: Optional[Tuple[int, int]] = None,
                                 target_size: Optional[Tuple[int, int]] = None,
                                 is_negative: bool = False) -> Dict[str, torch.Tensor]:
        """prompts → conditioning dict for the net: {context} (SD1.5),
        {context: CLIP-L ‖ CLIP-G hidden states, y: pooled CLIP-G ‖ size
        embeddings} (SDXL), {context: CLIP-G hidden states, y: pooled CLIP-G
        ‖ size and aesthetic-score embeddings} (the SDXL refiner; the score
        is 2.5 where `is_negative`) or {context: T5 features, y: CLIP-L
        pooled} (Flux). The sizes are (height, width) pairs; both default to
        the image's."""
        if self.family in ("sdxl", "sdxl_refiner"):
            refiner = self.family == "sdxl_refiner"
            zg, pooled_g = self.text_engines["clip_g"](prompts, max_chunks=max_chunks)
            osize = original_size or (height, width)
            tsize = target_size or (height, width)
            sizes = [osize[0], osize[1], crop[0], crop[1]]
            # the refiner's aesthetic score: the reference's fixed 6.0, 2.5 for a negative prompt
            sizes += [2.5 if is_negative else 6.0] if refiner else list(tsize)
            embs = [nn.timestep_embedding(torch.full((len(prompts),), float(s), device=self.device),
                                          256) for s in sizes]
            y = torch.cat([pooled_g.float()] + embs, dim=-1)
            if not refiner:
                zl, _ = self.text_engines["clip_l"](prompts, max_chunks=max_chunks)
                zg = torch.cat([zl, zg], dim=-1)
            return {"context": zg.to(self.compute_dtype), "y": y.to(self.compute_dtype)}
        if self.family == "flux":
            z = self.text_engines["t5xxl"](prompts)
            if "clip_l" in self.text_engines:
                _, pooled = self.text_engines["clip_l"](prompts, max_chunks=1)
            else:
                pooled = torch.zeros((len(prompts), 768), device=self.device)
            return {"context": z.to(self.compute_dtype), "y": pooled.to(self.compute_dtype)}
        z, _ = self.text_engines["clip_l"](prompts, max_chunks=max_chunks)
        return {"context": z.to(self.compute_dtype)}

    def unet_apply_fn(self, hooks=None, controlnets=None):
        """The raw network `apply(params, x, t, **cond)` (the reference's
        `build_apply`). `hooks` is the UNet's attention hook manifest
        (models/unet.py). With `controlnets` (models/controlnet.py
        `ControlNetState`s) the UNet's apply also takes `t_host`, the
        timestep as a host float that `sampling/cfg.py` already holds: the
        ControlNets' schedule gate 1 − t/999 is computed from it, so no step
        waits on the card to read t. Hooks and ControlNets compose."""
        if self.family == "flux":
            if controlnets or hooks:
                raise NotImplementedError("ControlNets and UNet hooks for Flux are not ported yet")
            fcfg = self.flux_cfg

            def apply_flux(params, x, t, context, y=None, guidance=None):
                return flux_mod.flux_apply(params, x, t, context, y, guidance=guidance, cfg=fcfg)

            return apply_flux
        cfg = self.unet_cfg
        if hooks:
            unet_mod.check_hooks(hooks)
        if not controlnets:
            def apply(params, x, t, context, y=None):
                return unet_mod.unet_apply(params, x, t, context, y=y, cfg=cfg, hooks=hooks)

            return apply

        def apply_controlled(params, x, t, context, y=None, t_host=None):
            t0 = float(t[0]) if t_host is None else t_host
            frac = np.float32(1.0) - np.float32(t0) / np.float32(999.0)
            ctrl = run_controlnets(controlnets, x, t, frac, context, y=y)
            return unet_mod.unet_apply(params, x, t, context, y=y, cfg=cfg, control=ctrl,
                                       hooks=hooks)

        apply_controlled.takes_host_timestep = True
        return apply_controlled

    @torch.no_grad()
    def decode_dispatch(self, latent: torch.Tensor) -> "DecodeHandle":
        """Enqueue the decode of latent [B,C,h,w] (regulated space) and the
        two finiteness checks, with no wait on the card: the checks stay
        device tensors, and on CUDA the uint8 images [B,8h,8w,3] and the
        flags start a non-blocking copy into pinned host memory behind a
        recorded event. `decode_finish` waits for it."""
        z = latent.float()
        lat_ok = torch.isfinite(z).all()
        z = self.latent_format.process_out(z)
        imgf = vae_mod.vae_decode(self.loaded.vae, z.to(self.compute_dtype)).float()
        flags = torch.stack([lat_ok, torch.isfinite(imgf).all()])
        img = torch.clamp((imgf + 1.0) * 127.5 + 0.5, 0, 255).to(torch.uint8)
        img = img.permute(0, 2, 3, 1).contiguous()
        if img.device.type != "cuda":
            return DecodeHandle(img, flags, None)
        host_img = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        host_flags = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        host_img.copy_(img, non_blocking=True)
        host_flags.copy_(flags, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return DecodeHandle(host_img, host_flags, done)

    @staticmethod
    def decode_finish(handle: "DecodeHandle") -> np.ndarray:
        """Wait for `decode_dispatch`'s copy → uint8 images [B,H,W,3]; raise
        NansException where the latent or the decoded image is not finite."""
        if handle.done is not None:
            handle.done.synchronize()
        lat_ok, img_ok = handle.flags.tolist()
        if not lat_ok:
            raise_nans("unet")
        if not img_ok:
            raise_nans("vae")
        return handle.images.numpy().copy()  # the pinned buffer goes back to its pool

    @torch.no_grad()
    def encode_first_stage(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,3,H,W] in [-1, 1] → the posterior mean as a regulated f32
        latent [B,C,H/8,W/8], encoded in the compute dtype."""
        z = vae_mod.vae_encode(self.loaded.vae, images.to(self.device, self.compute_dtype))
        return self.latent_format.process_in(z.float())


def load_engine(path_or_sd, device=None, dtype: Optional[torch.dtype] = None,
                unet_quant: Optional[str] = None) -> DiffusionEngine:
    """Checkpoint path (.safetensors or .gguf) or flat state dict → engine on
    `device` (the CUDA card unless given; without one this raises). `dtype` is the weights' and activations'
    dtype: bf16 on CUDA and f32 on the CPU unless given. `unet_quant`
    ("nf4" | "q8_0" | "q4_0") quantizes the diffusion model's large matmul
    weights at load (core/loader.py)."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    return DiffusionEngine(load_checkpoint_parts(path_or_sd, dtype=dtype, device=device,
                                                 unet_quant=unet_quant),
                           device, dtype)

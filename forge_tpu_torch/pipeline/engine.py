"""Diffusion engine: one loaded checkpoint bound into runnable functions
(port of forge_tpu/pipeline/engine.py: SD1.5, SD2, SDXL base and refiner,
Playground v2.5, SD3, Flux and Chroma; the VAE encode for img2img;
ControlNets beside the UNet).

SD1.5 and SD2: the last layer of CLIP-L or of OpenCLIP ViT-H (`clip_h`)
is the context (the reference's choice for SD2, whose own inference config
takes the penultimate layer). SDXL and Playground v2.5: CLIP-L's and
CLIP-G's penultimate hidden states, concatenated, are the context; `y` is
CLIP-G's projected pooled output and the sinusoidal
embeddings of the original size, crop and target size. The SDXL refiner:
CLIP-G's penultimate hidden states alone are the context; `y` is its pooled
output and the embeddings of the original size, crop and the aesthetic
score (6.0, or 2.5 for a negative prompt; 2560 wide). SD3: CLIP-L's and
CLIP-G's penultimate hidden states, concatenated and zero-padded to the
checkpoint's context width (4096), then T5-XXL's 77 tokens after them, are
the context; `y` is CLIP-L's pooled output ‖ CLIP-G's projected one. Flux:
T5-XXL features are the context, CLIP-L's pooled output the `y` vector, and
the distilled-CFG
guidance scale is added to the conditioning at sampling time
(pipeline/processing.py). Chroma: Flux's conditioning (T5-XXL, and CLIP-L's
pooled output where the checkpoint has CLIP-L, else zeros), which its
network does not read past the context (models/chroma.py). `embedding_db` (text/textual_inversion.py) holds
the textual-inversion embeddings every CLIP tower splices, CLIP-G from an
embedding's `clip_g` vectors. `upscalers` (pipeline/upscalers.py), when set, is
the registry the hires fix's pixel mode takes its upscaler from.
`lora_registry` (pipeline/extra_networks.py), when
set, resolves the prompt's `<lora:name:weight>` tags. The decode is split in
two, `decode_dispatch` (enqueue, no wait) and `decode_finish` (wait, NaN
checks), so the serving pipeline can overlap one request's copy to the host
with the next request's denoise. `decode_first_stage_tiled` and
`encode_first_stage_tiled` run the VAE over overlapping tiles blended by a
feathered weight (the reference's defaults: 64-latent-pixel decode tiles at
overlap 8, 512-pixel encode tiles at overlap 64; the last tile of a row or
column clamped to the edge); the tiles stay on the device and the blend
accumulates there in f32. `decode_dispatch` runs the decode its caller
picks (whole, tiled or TAESD's) under one uint8 conversion and the same
NaN checks.

Compute dtype is bf16 on CUDA and f32 on the CPU, as the reference picks
bf16 on the TPU and f32 elsewhere. The VAE runs in the `vae_dtype` option's
dtype ("auto": the compute dtype); its weights are cast to it once, when the
engine is built (`load_engine` loads them in it from the checkpoint). Under
the `disable_nan_check` option `decode_finish` lets non-finite values
through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import latent_formats
from ..core.device import default_device, default_dtype
from ..core.loader import FAMILIES, FP8_DTYPES, LoadedCheckpoint, load_checkpoint_parts
from ..models import chroma as chroma_mod
from ..models import flux as flux_mod
from ..models import mmdit as mmdit_mod
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from ..models.controlnet import run_controlnets
from ..ops import nn
from ..runtime.options import opts
from ..sampling.prediction import (DiscretePrediction, PredictionEDM, PredictionFlow,
                                   PredictionFlux)
from ..text.engine import ClassicTextEngine, TextEncoderOptions
from ..text.t5_engine import T5TextEngine
from ..text.textual_inversion import EmbeddingDatabase
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


def vae_dtype_for(compute_dtype: torch.dtype) -> torch.dtype:
    """The VAE's dtype under the `vae_dtype` option ("auto": the compute dtype)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(opts.get("vae_dtype"),
                                                                     compute_dtype)


def _cast_tree(tree, dtype: torch.dtype):
    """Every floating tensor of a nested tree in `dtype` (memory format kept),
    bar fp8 weights, which stay fp8 (core/loader.py)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() and tree.dtype not in FP8_DTYPES else tree


class DiffusionEngine:
    def __init__(self, loaded: LoadedCheckpoint, device, compute_dtype: torch.dtype,
                 embeddings_dir: Optional[str] = None):
        if loaded.family not in FAMILIES:
            raise NotImplementedError(f"{loaded.family} is not ported yet (ported: {FAMILIES})")
        self.family = loaded.family
        self.loaded = loaded
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.vae_dtype = vae_dtype_for(compute_dtype)
        if loaded.vae is not None:
            loaded.vae = _cast_tree(loaded.vae, self.vae_dtype)
        self.latent_format = latent_formats.BY_FAMILY[loaded.family]
        self.unet_cfg = None
        self.flux_cfg = None
        self.mmdit_cfg = None
        self.lora_registry = None
        self.upscalers = None
        tes = loaded.text_encoders
        self.text_engines = {}
        tokenizer = default_tokenizer()
        self.embedding_db = EmbeddingDatabase(tokenizer)
        if embeddings_dir:
            self.embedding_db.load_dir(embeddings_dir)
        db = self.embedding_db
        family = loaded.family
        # each tower's heads and activation follow its width
        if family in ("sdxl", "playground", "sd3"):  # the penultimate layer, no final LayerNorm
            for name, pooled, which in (("clip_l", False, "l"), ("clip_g", True, "g")):
                if name in tes:
                    self.text_engines[name] = ClassicTextEngine(
                        tes[name], tokenizer,
                        TextEncoderOptions(layer="hidden", pooled_projection=pooled,
                                           which_embedding=which), embedding_db=db)
        elif family == "sdxl_refiner":
            self.text_engines["clip_g"] = ClassicTextEngine(
                tes["clip_g"], tokenizer,
                TextEncoderOptions(layer="hidden", pooled_projection=True, which_embedding="g"),
                embedding_db=db)
        elif family == "sd20":
            self.text_engines["clip_h"] = ClassicTextEngine(tes["clip_h"], tokenizer,
                                                            embedding_db=db)
        elif "clip_l" in tes:
            self.text_engines["clip_l"] = ClassicTextEngine(tes["clip_l"], tokenizer,
                                                            embedding_db=db)
        if family in ("sd3", "flux", "chroma") and "t5xxl" in tes:
            self.text_engines["t5xxl"] = T5TextEngine(tes["t5xxl"],
                                                      max_length=77 if family == "sd3" else 512)
        if family in ("flux", "chroma"):
            hidden = loaded.unet["img_in"]["weight"].shape[0]
            self.flux_cfg = flux_mod.FluxConfig(num_heads=max(hidden // 128, 1),
                                                guidance_embed="guidance_in" in loaded.unet)
            self.predictor = PredictionFlux()
        elif family == "sd3":
            hidden = loaded.unet["x_embedder"]["proj"]["bias"].shape[0]
            pos = loaded.unet.get("pos_embed")
            self.mmdit_cfg = mmdit_mod.MMDiTConfig(
                num_heads=max(hidden // 64, 1),
                pos_embed_max_size=int(np.sqrt(pos.shape[1])) if pos is not None else 192)
            self.predictor = PredictionFlow(shift=3.0)
        else:
            self.unet_cfg = unet_mod.UNetConfig.for_family(family)
            # Playground v2.5: the EDM objective at σ_data 0.5 (its scheduler config)
            self.predictor = (PredictionEDM(sigma_data=0.5) if family == "playground"
                              else DiscretePrediction(prediction_type=loaded.prediction))
        self.predictor.family = family  # the Align-Your-Steps schedules pick their table by it

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
        """prompts → conditioning dict for the net: {context} (SD1.5, SD2),
        {context: CLIP-L ‖ CLIP-G hidden states, y: pooled CLIP-G ‖ size
        embeddings} (SDXL, Playground), {context: CLIP-G hidden states, y:
        pooled CLIP-G ‖ size and aesthetic-score embeddings} (the SDXL
        refiner; the score is 2.5 where `is_negative`), {context: CLIP-L ‖
        CLIP-G hidden states zero-padded to the context width, then T5
        features, y: pooled CLIP-L ‖ CLIP-G} (SD3; one CLIP chunk, as the
        reference encodes it) or {context: T5 features, y: CLIP-L pooled}
        (Flux, Chroma). The sizes are (height, width) pairs; both default to
        the image's."""
        if self.family in ("sdxl", "sdxl_refiner", "playground"):
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
        if self.family in ("flux", "chroma"):
            z = self.text_engines["t5xxl"](prompts)
            if "clip_l" in self.text_engines:
                _, pooled = self.text_engines["clip_l"](prompts, max_chunks=1)
            else:
                pooled = torch.zeros((len(prompts), 768), device=self.device)
            return {"context": z.to(self.compute_dtype), "y": pooled.to(self.compute_dtype)}
        if self.family == "sd3":
            return self._sd3_conditioning(prompts)
        z, _ = self.text_engines["clip_h" if self.family == "sd20" else "clip_l"](
            prompts, max_chunks=max_chunks)
        return {"context": z.to(self.compute_dtype)}

    def _sd3_conditioning(self, prompts: List[str]) -> Dict[str, torch.Tensor]:
        parts, pooled = [], []
        for name in ("clip_l", "clip_g"):
            if name in self.text_engines:
                z, p = self.text_engines[name](prompts, max_chunks=1)
                parts.append(z.to(self.compute_dtype))
                pooled.append(p.to(self.compute_dtype))
        pieces = []
        if parts:
            lg = torch.cat(parts, dim=-1)
            pieces.append(torch.nn.functional.pad(lg, (0, self.loaded.context_dim - lg.shape[-1])))
        if "t5xxl" in self.text_engines:
            pieces.append(self.text_engines["t5xxl"](prompts).to(self.compute_dtype))
        y = (torch.cat(pooled, dim=-1) if pooled
             else torch.zeros((len(prompts), 2048), dtype=self.compute_dtype, device=self.device))
        return {"context": torch.cat(pieces, dim=1), "y": y}

    def unet_apply_fn(self, hooks=None, controlnets=None):
        """The raw network `apply(params, x, t, **cond)` (the reference's
        `build_apply`). `hooks` is the UNet's hook manifest, its attention
        and block slots (models/unet.py). With `controlnets` (models/controlnet.py
        `ControlNetState`s) the UNet's apply also takes `t_host`, the
        timestep as a host float that `sampling/cfg.py` already holds: the
        ControlNets' schedule gate 1 − t/999 is computed from it, so no step
        waits on the card to read t. Hooks and ControlNets compose. On Flux,
        Chroma and SD3 they raise: the reference's Flux and Chroma apply take
        them and drop them without a word."""
        if self.family in ("flux", "chroma", "sd3"):
            if controlnets or hooks:
                raise NotImplementedError(
                    f"ControlNets and UNet hooks on {self.family} are refused: the reference "
                    "takes them there and drops them without a word")
        if self.family == "sd3":
            mcfg = self.mmdit_cfg

            def apply_sd3(params, x, t, context, y=None):
                return mmdit_mod.mmdit_apply(params, x, t, context, y, cfg=mcfg)

            return apply_sd3
        if self.family == "chroma":
            ccfg = self.flux_cfg

            def apply_chroma(params, x, t, context, y=None, guidance=None):
                return chroma_mod.chroma_apply(params, x, t, context, y=y, guidance=guidance,
                                               cfg=ccfg)

            return apply_chroma
        if self.family == "flux":
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
    def decode_first_stage(self, latent: torch.Tensor) -> torch.Tensor:
        """latent [B,C,h,w] (regulated space) → f32 images [B,3,8h,8w] in
        [-1, 1], decoded in the VAE's dtype."""
        z = self.latent_format.process_out(latent.float())
        return vae_mod.vae_decode(self.loaded.vae, z.to(self.vae_dtype)).float()

    @staticmethod
    def _feather(tile: int, overlap: int, device) -> torch.Tensor:
        """[tile, tile] f32 blend weight: a linear ramp 1/overlap … 1 over the
        `overlap` pixels at each edge, the minimum of the two axes'."""
        ramp = np.minimum(np.arange(1, tile + 1), overlap) / overlap
        ramp = np.minimum(ramp, ramp[::-1])
        return torch.from_numpy(np.minimum.outer(ramp, ramp).astype(np.float32)).to(device)

    @staticmethod
    def _tiles(h: int, w: int, tile: int, overlap: int):
        """(top, left, bottom, right) of each tile in the reference's order,
        rows then columns at stride tile − overlap, the last clamped to the edge."""
        stride = tile - overlap
        for top in range(0, max(h - overlap, 1), stride):
            for left in range(0, max(w - overlap, 1), stride):
                bottom, right = min(top + tile, h), min(left + tile, w)
                yield bottom - min(tile, h), right - min(tile, w), bottom, right

    def _blend_tiles(self, fn, x: torch.Tensor, tile: int, overlap: int, channels: int,
                     scale: float) -> torch.Tensor:
        """fn over x's overlapping tiles of `tile` pixels, each output tile
        (`scale` times the input's size) weighted by the feather at output
        size, the sum divided by the weights' → f32 [B, channels, ...]."""
        b, _, h, w = x.shape
        out = torch.zeros((b, channels, int(h * scale), int(w * scale)), dtype=torch.float32,
                          device=x.device)
        weight = torch.zeros((1, 1) + out.shape[2:], dtype=torch.float32, device=x.device)
        feather = self._feather(int(tile * scale), int(overlap * scale), x.device)
        for t0, l0, bottom, right in self._tiles(h, w, tile, overlap):
            piece = fn(x[:, :, t0:bottom, l0:right])
            fh, fw = piece.shape[2:]
            fm = feather[:fh, :fw]
            top, left = int(t0 * scale), int(l0 * scale)
            out[:, :, top:top + fh, left:left + fw] += piece * fm
            weight[:, :, top:top + fh, left:left + fw] += fm
        return out / torch.clamp_min(weight, 1e-6)

    @torch.no_grad()
    def decode_first_stage_tiled(self, latent: torch.Tensor, tile: int = 64,
                                 overlap: int = 8) -> torch.Tensor:
        """`decode_first_stage` over overlapping latent tiles of `tile` pixels,
        blended by the feather → f32 images [B,3,8h,8w] in [-1, 1]; a latent
        no larger than one tile decodes whole."""
        if latent.shape[2] <= tile and latent.shape[3] <= tile:
            return self.decode_first_stage(latent)
        return self._blend_tiles(self.decode_first_stage, latent, tile, overlap, 3, 8)

    @torch.no_grad()
    def encode_first_stage_tiled(self, images: torch.Tensor, tile: int = 512,
                                 overlap: int = 64) -> torch.Tensor:
        """`encode_first_stage` over overlapping image tiles of `tile` pixels,
        blended by the feather at latent size → regulated f32 latent
        [B,C,H/8,W/8]; an image no larger than one tile encodes whole."""
        if images.shape[2] <= tile and images.shape[3] <= tile:
            return self.encode_first_stage(images)
        return self._blend_tiles(self.encode_first_stage, images.to(self.device), tile, overlap,
                                 self.latent_format.latent_channels, 1 / 8)

    @torch.no_grad()
    def decode_dispatch(self, latent: torch.Tensor, decode=None) -> "DecodeHandle":
        """Enqueue `decode` (regulated latent [B,C,h,w] → image [B,3,8h,8w] in
        [-1, 1]; `decode_first_stage` unless given: the tiled decode or TAESD's,
        pipeline/taesd.py `taesd_decoder`) and the two finiteness checks, with
        no wait on the card: the checks stay device tensors, and on CUDA the
        uint8 images [B,8h,8w,3] and the flags start a non-blocking copy into
        pinned host memory behind a recorded event. `decode_finish` waits for
        it."""
        imgf = (decode or self.decode_first_stage)(latent)
        flags = torch.stack([torch.isfinite(latent.float()).all(), torch.isfinite(imgf).all()])
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
        NansException where the latent or the decoded image is not finite,
        unless the `disable_nan_check` option is set."""
        if handle.done is not None:
            handle.done.synchronize()
        lat_ok, img_ok = handle.flags.tolist()
        if not opts.get("disable_nan_check"):
            if not lat_ok:
                raise_nans("unet")
            if not img_ok:
                raise_nans("vae")
        return handle.images.numpy().copy()  # the pinned buffer goes back to its pool

    @torch.no_grad()
    def encode_first_stage(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,3,H,W] in [-1, 1] → the posterior mean as a regulated f32
        latent [B,C,H/8,W/8], encoded in the VAE's dtype."""
        z = vae_mod.vae_encode(self.loaded.vae, images.to(self.device, self.vae_dtype))
        return self.latent_format.process_in(z.float())


def load_engine(path_or_sd, device=None, dtype: Optional[torch.dtype] = None,
                unet_quant: Optional[str] = None,
                embeddings_dir: Optional[str] = None,
                additional_modules: Optional[Dict[str, str]] = None) -> DiffusionEngine:
    """Checkpoint path (.safetensors or .gguf) or flat state dict → engine on
    `device` (the CUDA card unless given; without one this raises). `dtype` is the weights' and activations'
    dtype: bf16 on CUDA and f32 on the CPU unless given. `unet_quant`
    ("nf4" | "q8_0" | "q4_0") quantizes the diffusion model's large matmul
    weights at load, "fp8" | "fp8_e4m3" | "fp8_e5m2" stores them as fp8
    (core/loader.py). `embeddings_dir` holds the textual-inversion embeddings
    the prompts' trigger words take. `additional_modules` ({"vae" | a text
    encoder's name: file}) merges separate VAE and text-encoder files in."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    return DiffusionEngine(load_checkpoint_parts(path_or_sd, dtype=dtype, device=device,
                                                 unet_quant=unet_quant,
                                                 vae_dtype=vae_dtype_for(dtype),
                                                 additional_modules=additional_modules),
                           device, dtype, embeddings_dir=embeddings_dir)

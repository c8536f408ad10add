# Copied from forge_tpu/core/guess.py; numpy/stdlib only, so the port imports no JAX. One change: a refiner's OpenCLIP-bigG under `conditioner.embedders.0.model.` is collected.
"""Checkpoint architecture detection from state-dict keys and shapes.

Re-implements the *behavior* of the reference's loader dispatch
(backend/loader.py:221-271 model-type tests + the external huggingface_guess
repo it pins): given one merged state dict, decide the model family and split
it into component state dicts (unet / vae / text encoders). Detection relies
only on key presence and tensor shapes, never on filenames.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."


@dataclasses.dataclass
class GuessResult:
    family: str  # sd15 | sd20 | sdxl | sdxl_refiner | sd3 | flux | chroma
    prediction: str  # eps | v | flow
    unet: Dict[str, np.ndarray]
    vae: Dict[str, np.ndarray]
    text_encoders: Dict[str, Dict[str, np.ndarray]]  # name -> sd
    context_dim: int = 768
    extra: Optional[dict] = None


def _shape(sd: Mapping[str, np.ndarray], key: str):
    v = sd.get(key)
    return tuple(v.shape) if v is not None else None


def guess(sd: Mapping[str, np.ndarray]) -> GuessResult:
    keys = sd.keys()

    unet_sd = {k[len(UNET_PREFIX):]: v for k, v in sd.items() if k.startswith(UNET_PREFIX)}
    vae_sd = {k[len(VAE_PREFIX):]: v for k, v in sd.items() if k.startswith(VAE_PREFIX)}

    # Bare diffusion-model dumps (common for Flux/SD3 single-component files).
    if not unet_sd and any(k.startswith("double_blocks.") for k in keys):
        unet_sd = dict(sd)
    if not unet_sd and any(k.startswith("joint_blocks.") for k in keys):
        unet_sd = dict(sd)

    # Recognized-but-unsupported families: fail loudly instead of falling
    # through to the sd15 default. The reference bundles HF configs for these
    # (backend/huggingface/Tencent-Hunyuan, stabilityai/stable-cascade) but
    # ships NO engine either — possible_models (backend/loader.py:29) is
    # exactly the seven families this framework implements plus the
    # SDXL-engine riders (Kolors, Playground).
    if any("style_embedder" in k or "text_embedding_padding" in k for k in keys):
        raise ValueError(
            "HunyuanDiT checkpoint recognized but not supported (no engine; "
            "the reference webui-forge cannot run it either — its "
            "possible_models list has no HunyuanDiT entry)")
    if any("clip_txt_pooled_mapper" in k or "effnet_mapper" in k for k in keys):
        raise ValueError(
            "Stable Cascade checkpoint recognized but not supported (no "
            "engine; the reference webui-forge cannot run it either — its "
            "possible_models list has no Cascade entry)")

    if any(k.startswith("double_blocks.") for k in unet_sd):
        family = "chroma" if any("distilled_guidance_layer" in k for k in unet_sd) else "flux"
        return GuessResult(
            family=family,
            prediction="flow",
            unet=unet_sd,
            vae=vae_sd,
            text_encoders=_collect_text_encoders(sd),
            context_dim=4096,
        )

    if any(k.startswith("joint_blocks.") for k in unet_sd):
        return GuessResult(
            family="sd3",
            prediction="flow",
            unet=unet_sd,
            vae=vae_sd,
            text_encoders=_collect_text_encoders(sd),
            context_dim=4096,
        )

    # UNet families: discriminate by cross-attention context width and the
    # SDXL-only class-label embedding (label_emb) / refiner layout.
    ctx = _shape(unet_sd, "input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight")
    has_label_emb = "label_emb.0.0.weight" in unet_sd

    if has_label_emb:
        adm = _shape(unet_sd, "label_emb.0.0.weight")[1]
        if "encoder_hid_proj.weight" in unet_sd:
            # Kolors: SDXL UNet + 4096→2048 ChatGLM projection, adm 5632
            # (reference config backend/huggingface/Kwai-Kolors/Kolors/unet)
            return GuessResult(
                family="kolors",
                prediction="eps",
                unet=unet_sd,
                vae=vae_sd,
                text_encoders=_collect_text_encoders(sd),
                context_dim=int(unet_sd["encoder_hid_proj.weight"].shape[1]),
            )
        if adm == 2560:
            family, context_dim = "sdxl_refiner", 1280
        else:  # 2816 for SDXL base
            family, context_dim = "sdxl", 2048
        # Playground v2.5: SDXL geometry trained under the EDM objective —
        # indistinguishable by shapes; detected by the EDM marker keys its
        # single-file exports carry (edm_mean/edm_std or edm_vpred.sigma_*),
        # matching the reference's scheduler-config-driven dispatch
        # (backend/loader.py:543, playgroundai config folder).
        prediction = "eps"
        if any(k.startswith(("edm_mean", "edm_std", "edm_vpred.")) for k in keys):
            family, prediction = "playground", "edm"
        return GuessResult(
            family=family,
            prediction=prediction,
            unet=unet_sd,
            vae=vae_sd,
            text_encoders=_collect_text_encoders(sd, refiner=family == "sdxl_refiner"),
            context_dim=context_dim,
        )

    is_sd2 = (ctx is not None and ctx[1] == 1024) or any(
        k.startswith("cond_stage_model.model.") for k in keys
    )
    if is_sd2:
        # SD2.x. v-prediction cannot be sniffed from shapes; 768-v checkpoints
        # are detected by their global ztsnr marker or overridden by the user.
        pred = "v" if "ztsnr" in keys or "v_pred" in keys else "eps"
        return GuessResult(
            family="sd20",
            prediction=pred,
            unet=unet_sd,
            vae=vae_sd,
            text_encoders=_collect_text_encoders(sd),
            context_dim=1024,
        )

    return GuessResult(
        family="sd15",
        prediction="v" if "v_pred" in keys else "eps",
        unet=unet_sd,
        vae=vae_sd,
        text_encoders=_collect_text_encoders(sd),
        context_dim=768,
    )


def _collect_text_encoders(sd: Mapping[str, np.ndarray],
                           refiner: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
    """Pull every text-encoder weight family present in a merged checkpoint,
    normalized to HF transformer key space per encoder. The SDXL refiner's
    only tower, OpenCLIP-bigG, sits at `conditioner.embedders.0.model.`
    (the reference reads OpenCLIP-G only under `embedders.1` and drops it)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}

    def grab(prefix: str, name: str):
        got = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if got:
            out[name] = got

    # SD1.5 CLIP-L (HF layout already)
    grab("cond_stage_model.transformer.", "clip_l")
    # SD2 open_clip layout
    grab("cond_stage_model.model.", "open_clip_h")
    # SDXL dual encoders
    grab("conditioner.embedders.0.transformer.", "clip_l")
    grab("conditioner.embedders.1.model.", "open_clip_g")
    if refiner:
        grab("conditioner.embedders.0.model.", "open_clip_g")
    # SD3 / Flux merged-file layouts
    grab("text_encoders.clip_l.transformer.", "clip_l")
    grab("text_encoders.clip_g.transformer.", "clip_g")
    grab("text_encoders.t5xxl.transformer.", "t5xxl")
    # Kolors ChatGLM3 (merged single-file exports prefix it text_encoders.chatglm.)
    grab("text_encoders.chatglm.", "chatglm")
    return out

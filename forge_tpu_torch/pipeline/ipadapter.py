"""IP-Adapter: image-prompt conditioning by cross-attention injection (port
of forge_tpu/pipeline/ipadapter.py: the simple and "plus" projections and
the attn2 hooks).

CLIP-vision embeds project to a few context tokens (a linear projection and
a LayerNorm, or the perceiver Resampler of "plus" adapters); every
cross-attention then adds `weight · attention(q, k_ip, v_ip)`, with the
layer's own to_k_ip/to_v_ip applied to the tokens. The hook manifest's
`attn2_replace_all` closure picks a layer's pair by the attention's
`attn_index` (its ordinal within one UNet forward, models/unet.py), so every
forward — each step, each MultiDiffusion tile — finds the same layers. The
reference counts calls in a closure instead, which is right only while one
JAX trace holds exactly one forward.

FaceID projects a precomputed 512-d insightface id embedding through an MLP
to a few tokens (FaceID-Plus refines them with a face perceiver over the
CLIP-vision hidden states of the face, v2 adding them back as a shortcut);
its checkpoints number the cross-attention layers 0, 1, 2, …. InstantID
takes the id embedding as a one-token sequence through a Resampler to 16
tokens, which go to the UNet as IP tokens and, through `build_instantid`'s
`controlnet_state`, to its keypoint ControlNet in place of the text context.
`attach` is the API's always-on script: it reads a unit dict and adds the
hooks to the request.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core import loader
from ..core.device import default_device, default_dtype
from ..models.clipvision import clip_vision_apply, preprocess
from ..ops import nn
from ..ops.attention import attention


def load_ip_adapter(path_or_sd, device=None, dtype: Optional[torch.dtype] = None):
    """An IP-Adapter, FaceID or InstantID file (or flat state dict) → its
    nested tree on `device` (the card unless given) in `dtype` (bf16 on
    CUDA, f32 on the CPU unless given)."""
    device = torch.device(device) if device is not None else default_device()
    return loader.load_ip_adapter(path_or_sd, dtype or default_dtype(device), device)


def project_image_embeds(params: Mapping[str, Any], clip_embed: torch.Tensor) -> torch.Tensor:
    """image_proj: clip embed → IP context tokens [B, n_tokens, ctx_dim]."""
    proj = params["image_proj"]
    if "proj" in proj:  # simple (non-plus): Linear → n tokens → LayerNorm
        out = nn.linear(clip_embed, proj["proj"])
        n_tokens = out.shape[-1] // proj["norm"]["weight"].shape[0]
        return nn.layer_norm(out.reshape(out.shape[0], n_tokens, -1), proj["norm"])
    if "latents" in proj:  # Resampler (plus models)
        return _resampler(proj, clip_embed)
    raise ValueError("unknown image_proj layout")


def _perceiver_layers(p: Mapping[str, Any], lat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The perceiver loop: `lat` queries cross-attend cat(x, lat)."""
    layers = p["layers"]
    heads = max(lat.shape[-1] // 64, 1)
    for i in range(len(layers)):
        attn_p, ff_p = layers[str(i)]["0"], layers[str(i)]["1"]
        ln_l = nn.layer_norm(lat, attn_p["norm2"])
        kv_in = torch.cat([nn.layer_norm(x, attn_p["norm1"]), ln_l], dim=1)
        q = nn.linear(ln_l, {"weight": attn_p["to_q"]["weight"]})
        k, v = nn.linear(kv_in, {"weight": attn_p["to_kv"]["weight"]}).chunk(2, dim=-1)
        lat = lat + nn.linear(attention(q, k, v, heads=heads),
                              {"weight": attn_p["to_out"]["weight"]})
        h = nn.gelu(nn.linear(nn.layer_norm(lat, ff_p["0"]), ff_p["1"]))
        lat = lat + nn.linear(h, ff_p["3"])
    return nn.layer_norm(nn.linear(lat, p["proj_out"]), p["norm_out"])


def _resampler(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Perceiver resampler (IPAdapterPlus resampler.py): learned latents
    cross-attend the penultimate CLIP-vision tokens."""
    latents = p["latents"]
    lat = latents.reshape((1,) + tuple(latents.shape[-2:])).expand(
        (x.shape[0],) + tuple(latents.shape[-2:])).to(x.dtype)
    return _perceiver_layers(p, lat, nn.linear(x, p["proj_in"]))


@dataclasses.dataclass
class IPAdapterState:
    params: Any
    ip_tokens: torch.Tensor  # [B, n, ctx] (cond)
    weight: float = 1.0
    # uncond tokens (the zeroed image's projection): applied to the uncond
    # half of the CFG batch; None repeats the cond tokens over every row
    uncond_tokens: Optional[torch.Tensor] = None

    def build_hooks(self) -> Dict[str, Any]:
        """→ the UNet hook manifest. Regular checkpoints number the
        cross-attention layers 1, 3, 5, … (odd indices), FaceID checkpoints
        0, 1, 2, …"""
        ip_layers = self.params["ip_adapter"]
        sequential = "0" in ip_layers
        tokens, uncond, weight = self.ip_tokens, self.uncond_tokens, self.weight

        def attn2_replace(q, k, v, extra):
            heads = extra["n_heads"]
            idx = extra["attn_index"]
            key = str(idx if sequential else idx * 2 + 1)
            base = attention(q, k, v, heads=heads)
            if key not in ip_layers:
                return base
            lp = ip_layers[key]
            if lp["to_k_ip"]["weight"].shape[0] != q.shape[-1]:
                raise ValueError(
                    f"IP-Adapter layer {key}: to_k_ip out-dim {lp['to_k_ip']['weight'].shape[0]} "
                    f"!= attention width {q.shape[-1]} — the adapter was trained for another "
                    f"model family (e.g. an SD1.5 adapter on SDXL)")

            def kv(toks):
                toks = toks.to(q.device, q.dtype)
                return (nn.linear(toks, {"weight": lp["to_k_ip"]["weight"]}),
                        nn.linear(toks, {"weight": lp["to_v_ip"]["weight"]}))

            k_ip, v_ip = kv(tokens)
            if uncond is not None and q.shape[0] == 2 * tokens.shape[0]:
                # the CFG batch is [cond…, uncond…] (sampling/cfg.py)
                k_un, v_un = kv(uncond)
                k_ip, v_ip = torch.cat([k_ip, k_un]), torch.cat([v_ip, v_un])
            elif k_ip.shape[0] != q.shape[0]:
                reps = q.shape[0] // k_ip.shape[0]
                k_ip, v_ip = k_ip.repeat(reps, 1, 1), v_ip.repeat(reps, 1, 1)
            return base + weight * attention(q, k_ip, v_ip, heads=heads)

        return {"attn2_replace_all": attn2_replace}


@torch.no_grad()
def encode_image(adapter_params: Any, clip_vision_params: Any, image: np.ndarray,
                 plus: Optional[bool] = None):
    """Reference image [H,W,3] → (IP tokens, the zeroed image's tokens), each
    [1, n, ctx], on the encoder's device: CLIP vision (its projected embed,
    or its penultimate hidden states for "plus" adapters), then the
    adapter's image_proj."""
    pw = clip_vision_params["vision_model"]["embeddings"]["patch_embedding"]["weight"]
    pixels = preprocess(image).to(pw.device)
    projected, _, penultimate = clip_vision_apply(clip_vision_params, pixels)
    use_plus = plus if plus is not None else "latents" in adapter_params.get("image_proj", {})
    embed = penultimate if use_plus else projected
    return (project_image_embeds(adapter_params, embed),
            project_image_embeds(adapter_params, torch.zeros_like(embed)))


def build_ip_adapter_hooks(adapter_params: Any, clip_vision_params: Any, image: np.ndarray,
                           weight: float = 1.0, batch_size: int = 1,
                           plus: Optional[bool] = None) -> Dict[str, Any]:
    """One-call setup: encode the reference image, project it to IP tokens,
    → the hook manifest for `Processing.unet_hooks`."""
    tokens, un = encode_image(adapter_params, clip_vision_params, image, plus=plus)
    tokens = tokens.expand((batch_size,) + tuple(tokens.shape[1:]))
    un = un.expand((batch_size,) + tuple(un.shape[1:]))
    return IPAdapterState(adapter_params, tokens, weight, uncond_tokens=un).build_hooks()


def _proj_leaf(params: Mapping[str, Any]) -> torch.Tensor:
    """A tensor of the adapter's image_proj: its device and dtype are the adapter's."""
    w = params["image_proj"]
    while isinstance(w, Mapping):
        w = next(iter(w.values()))
    return w


def _weights_like(params: Mapping[str, Any], value) -> torch.Tensor:
    """A host array or tensor on the device and in the dtype of the adapter's projection."""
    w = _proj_leaf(params)
    return torch.as_tensor(np.asarray(value, np.float32) if not torch.is_tensor(value)
                           else value).to(w.device, w.dtype)


def project_faceid_embeds(params: Mapping[str, Any], face_embed: torch.Tensor,
                          clip_embed: Optional[torch.Tensor] = None, scale: float = 1.0,
                          shortcut: bool = False) -> torch.Tensor:
    """FaceID's projection: id embed [B, 512] → MLP (Linear, GELU, Linear) →
    n tokens [B, n, ctx] → LayerNorm; with a face perceiver (FaceID-Plus) and
    the CLIP-vision hidden states [B, L, D] of the face, the tokens query the
    projected states, and v2's `shortcut` returns tokens + scale · that."""
    proj = params["image_proj"]
    h = nn.linear(nn.gelu(nn.linear(face_embed, proj["proj"]["0"])), proj["proj"]["2"])
    ctx = proj["norm"]["weight"].shape[0]
    x = nn.layer_norm(h.reshape(h.shape[0], -1, ctx), proj["norm"])
    if "perceiver_resampler" in proj and clip_embed is not None:
        pr = proj["perceiver_resampler"]
        out = _perceiver_layers(pr, x, nn.linear(clip_embed, pr["proj_in"]))
        return x + scale * out if shortcut else out
    return x


def is_faceid_adapter(params: Mapping[str, Any]) -> bool:
    """A FaceID checkpoint: its image_proj is the Sequential MLP (keys proj.0, proj.2)."""
    proj = params.get("image_proj", {})
    return "proj" in proj and isinstance(proj["proj"], Mapping) and "0" in proj["proj"]


@torch.no_grad()
def build_faceid_hooks(adapter_params: Any, face_embed: np.ndarray,
                       clip_vision_params: Any = None, image: Optional[np.ndarray] = None,
                       weight: float = 1.0, batch_size: int = 1, faceid_v2: bool = False,
                       weight_v2: float = 1.0) -> Dict[str, Any]:
    """FaceID and FaceID-Plus → the hook manifest. The id embedding [512] or
    [B, 512] comes precomputed (the API's `face_embeds`); FaceID-Plus also
    needs CLIP vision and the face image, whose penultimate hidden states its
    perceiver reads. The uncond tokens are the zeroed inputs' projection."""
    fe = _weights_like(adapter_params, face_embed)
    if fe.dim() == 1:
        fe = fe[None]
    clip_embed = None
    if "perceiver_resampler" in adapter_params["image_proj"]:
        if clip_vision_params is None or image is None:
            raise ValueError("FaceID-Plus needs clip_vision weights + face image")
        pw = clip_vision_params["vision_model"]["embeddings"]["patch_embedding"]["weight"]
        _, _, clip_embed = clip_vision_apply(clip_vision_params, preprocess(image).to(pw.device))
        clip_embed = clip_embed.to(fe.dtype)
    tokens = project_faceid_embeds(adapter_params, fe, clip_embed, scale=weight_v2,
                                   shortcut=faceid_v2)
    un = project_faceid_embeds(adapter_params, torch.zeros_like(fe),
                               None if clip_embed is None else torch.zeros_like(clip_embed),
                               scale=weight_v2, shortcut=faceid_v2)
    tokens = tokens.expand((batch_size,) + tuple(tokens.shape[1:]))
    un = un.expand((batch_size,) + tuple(un.shape[1:]))
    return IPAdapterState(adapter_params, tokens, weight, uncond_tokens=un).build_hooks()


@torch.no_grad()
def build_instantid(adapter_params: Any, face_embed: np.ndarray, controlnet_state=None,
                    weight: float = 1.0, batch_size: int = 1):
    """InstantID → (the hook manifest, the ControlNet state or None): the id
    embedding as a one-token sequence [B, 1, 512] through the Resampler to
    its tokens (16), the IP tokens of the UNet; given the keypoint
    ControlNet's state, a copy of it whose `context_override` is the
    [cond‖uncond] tokens, which that ControlNet reads in place of the text."""
    fe = _weights_like(adapter_params, face_embed)
    if fe.dim() == 1:
        fe = fe[None]
    fe = fe[:, None, :]
    cond = _resampler(adapter_params["image_proj"], fe)
    uncond = _resampler(adapter_params["image_proj"], torch.zeros_like(fe))
    cond = cond.expand((batch_size,) + tuple(cond.shape[1:]))
    uncond = uncond.expand((batch_size,) + tuple(uncond.shape[1:]))
    hooks = IPAdapterState(adapter_params, cond, weight, uncond_tokens=uncond).build_hooks()
    if controlnet_state is not None:
        controlnet_state = dataclasses.replace(controlnet_state,
                                               context_override=torch.cat([cond, uncond]))
    return hooks, controlnet_state


def _decode_unit_image(img):
    """A base64 PNG (a data URL too) → uint8 RGB [H,W,3] through the port's
    codec; arrays and None pass through."""
    if isinstance(img, str):
        from .images import decode_png, to_rgb

        return to_rgb(decode_png(base64.b64decode(img.split(",", 1)[-1]))[0])
    return img


def attach(p, unit: Mapping[str, Any], device=None, dtype: Optional[torch.dtype] = None) -> None:
    """The API's always-on script: a unit dict → the request's `unet_hooks`.
    Fields: adapter_path, weight and one of image (with clip_vision_path: a
    simple or "plus" adapter), face_embeds (FaceID: a precomputed id
    embedding; with image and clip_vision_path for FaceID-Plus; faceid_v2,
    weight_v2) or instant_id: true with face_embeds (its ControlNet coupling
    is `build_instantid`'s `controlnet_state`, which this entry leaves
    alone, as the reference's does). Weights load to `device` (the card
    unless given) in `dtype`."""
    params = load_ip_adapter(unit["adapter_path"], device, dtype)
    weight = float(unit.get("weight", 1.0))
    batch = getattr(p, "batch_size", 1)
    face = unit.get("face_embeds")

    def clip_vision():
        w = _proj_leaf(params)
        return loader.load_clip_vision(unit["clip_vision_path"], w.dtype, w.device)

    if unit.get("instant_id") and face is not None:
        hooks, _ = build_instantid(params, np.asarray(face, np.float32), weight=weight,
                                   batch_size=batch)
    elif face is not None or is_faceid_adapter(params):
        if face is None:
            raise ValueError("FaceID adapter needs precomputed face_embeds")
        cv = clip_vision() if unit.get("clip_vision_path") else None
        hooks = build_faceid_hooks(params, np.asarray(face, np.float32), clip_vision_params=cv,
                                   image=_decode_unit_image(unit.get("image")), weight=weight,
                                   batch_size=batch, faceid_v2=bool(unit.get("faceid_v2")),
                                   weight_v2=float(unit.get("weight_v2", 1.0)))
    else:
        hooks = build_ip_adapter_hooks(params, clip_vision(),
                                       _decode_unit_image(unit.get("image")), weight=weight,
                                       batch_size=batch)
    p.unet_hooks = {**(p.unet_hooks or {}), **hooks}

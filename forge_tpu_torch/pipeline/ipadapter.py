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

FaceID, InstantID and the API's `attach` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.clipvision import clip_vision_apply, preprocess
from ..ops import nn
from ..ops.attention import attention


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

"""CLIP text encoder over HF `text_model.*` keys (port of forge_tpu/models/clip.py).

Causal transformer with quick-gelu (CLIP-L) or gelu (open_clip bigG, SDXL's
CLIP-G, converted to this key space at load) MLPs; returns the final hidden
states, every layer's hidden states (for clip-skip and SDXL's penultimate
layer) and the pooled output at the EOT token; `clip_pooled_projection`
applies CLIP-G's text projection to it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.attention import attention


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    num_heads: int = 12
    act: str = "quick_gelu"  # clip-l/h: quick_gelu; open_clip bigG: gelu

    @staticmethod
    def for_width(width: int) -> "ClipConfig":
        if width == 768:  # CLIP-L
            return ClipConfig(num_heads=12, act="quick_gelu")
        if width == 1024:  # CLIP-H (SD2)
            return ClipConfig(num_heads=16, act="gelu")
        if width == 1280:  # CLIP-bigG (SDXL)
            return ClipConfig(num_heads=20, act="gelu")
        # non-standard width (tiny test models): assume 64-dim heads
        return ClipConfig(num_heads=max(width // 64, 1), act="quick_gelu")


def _mlp(p: Mapping[str, Any], x: torch.Tensor, act: str) -> torch.Tensor:
    h = nn.linear(x, p["fc1"])
    h = nn.quick_gelu(h) if act == "quick_gelu" else nn.gelu(h)
    return nn.linear(h, p["fc2"])


def _self_attn(p: Mapping[str, Any], x: torch.Tensor, heads: int,
               mask: torch.Tensor) -> torch.Tensor:
    q = nn.linear(x, p["q_proj"])
    k = nn.linear(x, p["k_proj"])
    v = nn.linear(x, p["v_proj"])
    return nn.linear(attention(q, k, v, heads=heads, mask=mask), p["out_proj"])


def clip_text_apply(
    params: Mapping[str, Any],
    tokens: torch.Tensor,
    cfg: Optional[ClipConfig] = None,
    input_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """tokens [B, L] int → (final_hidden [B,L,D], hidden states [num_layers+1],
    pooled [B,D]). hidden_states[i] is the input to layer i; clip-skip k
    selects hidden_states[-k]. `input_embeds` [B, L, D], when given, stands
    for the token embeddings (textual-inversion vectors spliced in); the
    pooled output is still taken at the EOT of `tokens`."""
    tm = params["text_model"]
    emb = tm["embeddings"]
    table = emb["token_embedding"]["weight"]
    cfg = cfg or ClipConfig.for_width(table.shape[1])

    seq = tokens.shape[1]
    if input_embeds is None:
        input_embeds = F.embedding(tokens, table)
    x = input_embeds + emb["position_embedding"]["weight"][:seq]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()[None, None]
    layers = tm["encoder"]["layers"]

    hiddens = [x]
    for i in range(len(layers)):
        lp = layers[str(i)]
        x = x + _self_attn(lp["self_attn"], nn.layer_norm(x, lp["layer_norm1"]),
                           cfg.num_heads, causal)
        x = x + _mlp(lp["mlp"], nn.layer_norm(x, lp["layer_norm2"]), cfg.act)
        hiddens.append(x)

    final = nn.layer_norm(x, tm["final_layer_norm"])
    # EOT = highest token id in the CLIP vocab; argmax of ids finds it
    eot = tokens.argmax(dim=-1)
    pooled = final[torch.arange(final.shape[0], device=final.device), eot]
    return final, hiddens, pooled


def clip_pooled_projection(params: Mapping[str, Any], pooled: torch.Tensor) -> torch.Tensor:
    """Apply text_projection (CLIP-G pooled path); a tree without one raises."""
    if "text_projection" not in params:
        raise KeyError("this CLIP tower has no text_projection to apply")
    return nn.linear(pooled, {"weight": params["text_projection"]["weight"]})

"""ControlNet (cldm) as a function over its state dict (port of forge_tpu/models/controlnet.py).

A copy of the UNet encoder whose per-block outputs pass through zero convs to
become residuals, plus the input-hint conv ladder. The residuals go to
`unet_apply`'s `control` argument ({'output': [...], 'middle': [...]}). The
blocks are the UNet's own `resblock` and `spatial_transformer`, so the fused
GroupNorm+SiLU+conv3x3 and flash attention kernels run here as in the UNet.
Activations and the hint are NCHW. Keys mirror the checkpoint's
('input_blocks.*', 'zero_convs.*', 'input_hint_block.*', 'middle_block_out.*'),
nested by '.'.

The hint is cast to the activations' dtype, so the whole net runs in the
compute dtype (bf16 on the card) and its convs take the tensor-core body.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..ops import nn
from ..ops.resize import resize
from .t2i_adapter import T2IAdapterState
from .unet import UNetConfig, resblock, spatial_transformer


def controlnet_apply(params: Mapping[str, Any], x: torch.Tensor, hint: torch.Tensor,
                     timesteps: torch.Tensor, context: torch.Tensor,
                     y: Optional[torch.Tensor] = None,
                     cfg: UNetConfig = UNetConfig()) -> Dict[str, List[torch.Tensor]]:
    """x [B,4,h,w] latent, hint [B or 1,3,H,W] control image in [0, 1] →
    {'output': [residual per input block, deepest first], 'middle': [residual]}."""
    model_channels = params["time_embed"]["0"]["weight"].shape[1]
    t_emb = nn.timestep_embedding(timesteps, model_channels, dtype=x.dtype)
    emb = nn.linear(t_emb, params["time_embed"]["0"])
    emb = nn.linear(nn.silu(emb), params["time_embed"]["2"])
    if y is not None and "label_emb" in params:
        le = params["label_emb"]["0"]
        v = nn.linear(y.to(emb.dtype), le["0"])
        emb = emb + nn.linear(nn.silu(v), le["2"])

    # grayscale hints become 3 channels (the reference's HWC3); a hint made
    # for another size is resized to this latent's (img2img, hires passes)
    if hint.dim() == 3:
        hint = hint[:, None]
    if hint.shape[1] == 1:
        hint = hint.expand(-1, 3, -1, -1)
    want = (x.shape[2] * 8, x.shape[3] * 8)
    if tuple(hint.shape[2:]) != want:
        hint = resize(hint.float(), want)
    guided = _hint_stack(params["input_hint_block"], hint.to(x.device, x.dtype))

    outs: List[torch.Tensor] = []
    h = x
    input_blocks = params["input_blocks"]
    zero_convs = params["zero_convs"]
    for i in range(len(input_blocks)):
        block = input_blocks[str(i)]
        for j in range(len(block)):
            sub = block[str(j)]
            if "in_layers" in sub:
                h = resblock(sub, h, emb)
            elif "transformer_blocks" in sub:
                h = spatial_transformer(sub, h, context, cfg)
            elif "op" in sub:
                h = nn.conv2d(h, sub["op"], stride=2, padding=1)
            elif "weight" in sub:
                h = nn.conv2d(h, sub, padding=1)
        if i == 0:
            h = h + guided
        outs.append(nn.conv2d(h, zero_convs[str(i)]["0"]))

    mid = params["middle_block"]
    h = resblock(mid["0"], h, emb)
    h = spatial_transformer(mid["1"], h, context, cfg)
    h = resblock(mid["2"], h, emb)
    middle = nn.conv2d(h, params["middle_block_out"]["0"])
    # the UNet consumes control['output'][j] at output step j, deepest first
    return {"output": outs[::-1], "middle": [middle]}


def _hint_stack(hb: Mapping[str, Any], hint: torch.Tensor) -> torch.Tensor:
    """The cldm input_hint_block: 8 convs with SiLU between, stride 2 at the
    3rd, 5th and 7th (8× down to the latent's size)."""
    idx = sorted(int(k) for k in hb.keys())
    h = hint
    for pos, i in enumerate(idx):
        stride = 2 if (pos in (2, 4, 6) and len(idx) == 8) else 1
        h = nn.conv2d(h, hb[str(i)], stride=stride, padding=1)
        if pos != len(idx) - 1:
            h = nn.silu(h)
    return h


@dataclasses.dataclass
class ControlNetState:
    """One attached ControlNet: its parameter tree, the hint [B or 1,3,H,W] in
    [0, 1], its strength, the fraction of the schedule it acts in,
    per-residual weights (weight i scales residual i of each kind; a shorter
    list pads with 1.0) and, for InstantID, the context it reads in place of
    the text's."""

    params: Any
    hint: torch.Tensor
    strength: float = 1.0
    start_percent: float = 0.0
    end_percent: float = 1.0
    cfg: UNetConfig = UNetConfig()
    block_weights: Optional[Sequence[float]] = None
    # InstantID's coupling: [cond‖uncond] image-prompt tokens [2B, n, ctx] fed to this
    # ControlNet in place of the text context (pipeline/ipadapter.py `build_instantid`)
    context_override: Optional[torch.Tensor] = None


def run_controlnets(states: Sequence[Any], x: torch.Tensor,
                    timesteps: torch.Tensor, sigma_frac: float, context: torch.Tensor,
                    y: Optional[torch.Tensor] = None) -> Optional[Dict[str, List[torch.Tensor]]]:
    """Run the attached ControlNets (and T2I-Adapters: their features,
    computed once a state, models/t2i_adapter.py) and sum their gated,
    weighted residuals, each broadcast to the CFG batch. `sigma_frac` is
    the host float 1 − t/999, the fraction of the schedule gone. A net
    outside [start_percent, end_percent] adds nothing, so it is not run (the
    reference runs it and multiplies its residuals by 0)."""
    if not states:
        return None
    merged: Dict[str, List[Optional[torch.Tensor]]] = {}
    frac = np.float32(sigma_frac)
    for st in states:
        if not (frac >= np.float32(st.start_percent) and frac <= np.float32(st.end_percent)):
            continue
        if isinstance(st, T2IAdapterState):
            out = st.features(x.dtype)
        else:
            ctx = context
            if st.context_override is not None:
                ctx = st.context_override.to(context.device, context.dtype)
                if ctx.shape[0] != x.shape[0]:  # skip-uncond (CFG 1): the cond rows only
                    ctx = ctx[:x.shape[0]]
            out = controlnet_apply(st.params, x, st.hint, timesteps, ctx, y=y, cfg=st.cfg)
        bw = st.block_weights
        for kind, residuals in out.items():
            tgt = merged.setdefault(kind, [None] * len(residuals))
            if len(tgt) < len(residuals):
                tgt.extend([None] * (len(residuals) - len(tgt)))
            for i, r in enumerate(residuals):
                if r is None:  # a T2I-Adapter's empty slot
                    continue
                w = np.float32(st.strength)
                if bw is not None:
                    w = w * np.float32(bw[i] if i < len(bw) else 1.0)
                if r.shape[0] != x.shape[0]:  # a hint's batch broadcast to the CFG batch
                    r = r.expand((x.shape[0],) + tuple(r.shape[1:]))
                r = r.to(x.dtype) * float(w)
                tgt[i] = r if tgt[i] is None else tgt[i] + r
    return merged or None

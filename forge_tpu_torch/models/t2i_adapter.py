"""T2I-Adapter as a function over its state dict (port of
forge_tpu/models/t2i_adapter.py).

A small conv trunk over the pixel-unshuffled hint gives one feature per
channel stage, aligned onto the UNet's input-block control slots (a cldm
ControlNet feeds the output skips instead). The features depend on the hint
alone, so `T2IAdapterState` computes them once, at the first model call,
and every later call reuses them. Keys are the checkpoint's (conv_in.*,
body.N.{in_conv, block1, block2, skep, down_opt.op}.*), nested by '.';
activations NCHW, weights OIHW. Its convs are plain `F.conv2d`, as the
reference's are `nn.conv2d` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops import nn


def _pad_of(conv_p) -> int:
    return conv_p["weight"].shape[2] // 2  # OIHW: kh


def _resblock(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    if "down_opt" in p:
        x = nn.conv2d(x, p["down_opt"]["op"], stride=2, padding=1)
    if "in_conv" in p:
        x = nn.conv2d(x, p["in_conv"], padding=_pad_of(p["in_conv"]))
    h = torch.relu(nn.conv2d(x, p["block1"], padding=1))
    h = nn.conv2d(h, p["block2"], padding=_pad_of(p["block2"]))
    # skep reads the x block1 saw (after in_conv rebound it)
    if "skep" in p:
        return h + nn.conv2d(x, p["skep"], padding=_pad_of(p["skep"]))
    return h + x


@dataclasses.dataclass
class AdapterConfig:
    channels: tuple = (320, 640, 1280, 1280)
    nums_rb: int = 3
    xl: bool = False

    @property
    def unshuffle(self) -> int:
        return 16 if self.xl else 8


def detect_adapter_config(params: Mapping[str, Any]) -> AdapterConfig:
    """XL when conv_in takes 3·16² channels; resblocks a stage from the
    canonical four stages where the body divides by 4, else one a stage."""
    w = params["conv_in"]["weight"]
    xl = w.shape[1] >= 3 * 16 * 16
    n_blocks = len(params["body"])
    nums_rb = max(n_blocks // 4, 1) if n_blocks % 4 == 0 else 1
    channels = []
    for i in range(n_blocks // nums_rb):
        blk = params["body"][str(i * nums_rb)]
        channels.append(blk["in_conv" if "in_conv" in blk else "block1"]["weight"].shape[0])
    return AdapterConfig(tuple(channels) or (w.shape[0],), nums_rb, xl)


def adapter_apply(params: Mapping[str, Any], hint: torch.Tensor,
                  cfg: Optional[AdapterConfig] = None
                  ) -> Dict[str, List[Optional[torch.Tensor]]]:
    """hint [B,3,H,W] in [0, 1] (H, W multiples of the unshuffle) →
    {'input': [None …, features], 'middle': [...]}: SD puts stage i's
    feature on input slot 3i + 2; XL puts stages 0, 1 and 2 on slots 3, 5
    and 8 (after its first downsample and at the end of each later stage)
    and the last stage on the middle block."""
    cfg = cfg or detect_adapter_config(params)
    # channel c·r² + i·r + j is input channel c at row offset i, column offset j: the
    # reference's NHWC unshuffle transposed (tests/test_torch_t2i_adapter.py)
    x = nn.conv2d(F.pixel_unshuffle(hint, cfg.unshuffle), params["conv_in"], padding=1)
    features: List[Optional[torch.Tensor]] = []
    for i in range(len(cfg.channels)):
        for j in range(cfg.nums_rb):
            x = _resblock(params["body"][str(i * cfg.nums_rb + j)], x)
        if cfg.xl:
            features.append(None)
            if i == 0:
                features.extend([None, None])
            if i == 2:
                features.append(None)
        else:
            features.extend([None, None])
        features.append(x)
    if cfg.xl:
        return {"input": features[:-1], "middle": [features[-1]]}
    return {"input": features, "middle": []}


@dataclasses.dataclass
class T2IAdapterState:
    """One attached T2I-Adapter: its tree, the hint [B or 1,3,H,W] in [0, 1],
    strength, the fraction of the schedule it acts in and per-slot weights,
    as `ControlNetState` (models/controlnet.py `run_controlnets` gates and
    weights both). The features are computed once a state."""

    params: Any
    hint: torch.Tensor
    strength: float = 1.0
    start_percent: float = 0.0
    end_percent: float = 1.0
    cfg: Optional[AdapterConfig] = None
    block_weights: Optional[Sequence[float]] = None
    _features: Any = None

    def features(self, dtype: torch.dtype) -> Dict[str, List[Optional[torch.Tensor]]]:
        """The features, computed in `dtype` at the first call."""
        if self._features is None:
            with torch.no_grad():
                device = self.params["conv_in"]["weight"].device
                self._features = adapter_apply(self.params, self.hint.to(device, dtype),
                                               self.cfg)
        return self._features

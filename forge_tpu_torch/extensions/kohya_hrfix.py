"""Kohya HRFix / Deep Shrink (port of forge_tpu/extensions/kohya_hrfix.py,
itself of sd_forge_kohya_hrfix's PatchModelAddDownscale).

For the first part of the schedule the UNet's hidden state is shrunk after
input block `block_number` and grown back where an output block meets a
skip of another size, so the model lays the image out at its trained size
and refines it at the full one. The reference gates the shrink per call on
σ; here, as in forge_tpu, `attach` sets a hook schedule
(`Processing.hook_phases`): the step loop runs in segments with the shrink
hooks on, then off. The resizes are ops/resize.py's (`jax.image.resize`'s
weights, its antialiased downscale included); "bislerp" and "area" resize
bilinearly, as the reference maps them. NCHW.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.resize import resize

_METHODS = {"bicubic": "bicubic", "bilinear": "bilinear", "bislerp": "bilinear",
            "nearest-exact": "nearest", "area": "bilinear", "nearest": "nearest"}


def _resize(h: torch.Tensor, new_h: int, new_w: int, method: str) -> torch.Tensor:
    return resize(h, (new_h, new_w), _METHODS.get(method, "bilinear")).to(h.dtype)


def build_kohya_hooks(block_number: int = 3, downscale_factor: float = 2.0,
                      downscale_after_skip: bool = True, downscale_method: str = "bicubic",
                      upscale_method: str = "bicubic") -> Dict[str, Any]:
    """The shrink after input block `block_number` (after its skip is saved
    unless `downscale_after_skip` is off) and the growth back at every
    output block whose h and skip differ in size."""
    slot = "input_block_patch_after_skip" if downscale_after_skip else "input_block_patch"

    def input_patch(h, block_id):
        if block_id == ("input", block_number):
            h = _resize(h, max(round(h.shape[2] / downscale_factor), 1),
                        max(round(h.shape[3] / downscale_factor), 1), downscale_method)
        return h

    def output_patch(h, skip, block_id):
        if h.shape[2:] != skip.shape[2:]:
            h = _resize(h, skip.shape[2], skip.shape[3], upscale_method)
        return h, skip

    return {slot: (input_patch,), "output_block_patch": (output_patch,)}


def attach(p, args: Dict[str, Any]) -> None:
    """The API's wiring: the hook phases [until start: off] [until end: the
    shrink] [the rest: off], and the infotext's key."""
    hooks = build_kohya_hooks(
        block_number=int(args.get("block_number", 3)),
        downscale_factor=float(args.get("downscale_factor", 2.0)),
        downscale_after_skip=bool(args.get("downscale_after_skip", True)),
        downscale_method=args.get("downscale_method", "bicubic"),
        upscale_method=args.get("upscale_method", "bicubic"))
    start = float(args.get("start_percent", 0.0))
    end = float(args.get("end_percent", 0.35))
    p.hook_phases = ([(start, {})] if start > 0 else []) + [(end, hooks), (1.0, {})]
    p.extra_generation_params["Kohya HRFix"] = (
        f"block {args.get('block_number', 3)} x{args.get('downscale_factor', 2.0)} until {end}")

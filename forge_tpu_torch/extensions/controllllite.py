"""ControlLLLite (port of forge_tpu/extensions/controllllite.py, itself of
sd_forge_controlllite's lib_controllllite.py): one small module a projection,
`lllite_unet_<block path>_attn{1,2}_to_{q,k,v}`, embeds the control image
through strided convs (`conditioning1`) to the block's token grid, and adds
up(relu(mid(cat(cond_emb, relu(down(t)))))) · multiplier to the projected
q, k or v (t), through the attn1_patch and attn2_patch slots.

Weights in the file's torch layout (conv OIHW, linear [out, in]). The cond
embedding is NCHW, made on the card on a module's first call and kept. A
module's embedding must have the token count of the block it patches
(depth 1: /8 of the image, 2: /16, 3: /32)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn


def split_lllite_modules(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Flat keys grouped by module name, the rest nested (lib_controllllite.py:33-43)."""
    modules: Dict[str, Dict[str, Any]] = {}
    for key, value in sd.items():
        module_name, _, weight_name = key.partition(".")
        node = modules.setdefault(module_name, {})
        parts = weight_name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return modules


def _module_meta(weights: Dict[str, Any]) -> Dict[str, Any]:
    """Depth, conv or linear, and widths from the shapes (lib_controllllite.py:48-56)."""
    cond1 = weights["conditioning1"]
    down0 = weights["down"]["0"]["weight"]
    if "4" in cond1:
        depth = 3
    elif cond1["2"]["weight"].shape[2] == 4:  # OIHW: a 4-high kernel
        depth = 2
    else:
        depth = 1
    return {"depth": depth, "is_conv2d": down0.dim() == 4, "in_dim": down0.shape[1],
            "mlp_dim": down0.shape[0]}


def _cond_embed(weights: Dict[str, Any], cond_image: torch.Tensor, depth: int) -> torch.Tensor:
    """The conditioning1 stack (lib_controllllite.py:137-152) on an NCHW
    image in [-1, 1] → [1, cond_emb_dim, h, w]."""
    c1 = weights["conditioning1"]
    x = F.relu(nn.conv2d(cond_image, c1["0"], stride=4))
    if depth == 1:
        return nn.conv2d(x, c1["2"], stride=2)
    if depth == 2:
        return nn.conv2d(x, c1["2"], stride=4)
    x = F.relu(nn.conv2d(x, c1["2"], stride=4))
    return nn.conv2d(x, c1["4"], stride=2)


def _apply_module(weights: Dict[str, Any], meta: Dict[str, Any], cond_emb: torch.Tensor,
                  x: torch.Tensor, multiplier: float) -> torch.Tensor:
    """x [B, L, C] → its offset (lib_controllllite.py:195-237 forward); the
    embedding is tiled to x's batch."""
    ce = cond_emb
    if not meta["is_conv2d"]:
        b, c, h, w = ce.shape
        ce = ce.reshape(b, c, h * w).transpose(1, 2)
    if x.shape[0] != ce.shape[0]:
        ce = ce.repeat((x.shape[0] // ce.shape[0],) + (1,) * (ce.dim() - 1))
    down = F.relu(nn.linear(x, weights["down"]["0"]))
    mid = F.relu(nn.linear(torch.cat([ce.to(x.dtype), down], dim=-1), weights["mid"]["0"]))
    return nn.linear(mid, weights["up"]["0"]) * multiplier


def _module_prefix(extra: Mapping[str, Any]) -> str:
    block = extra["block"]
    idx = extra.get("block_index", 0)
    if block[0] == "input":
        return f"lllite_unet_input_blocks_{block[1]}_1_transformer_blocks_{idx}"
    if block[0] == "middle":
        return f"lllite_unet_middle_block_1_transformer_blocks_{idx}"
    return f"lllite_unet_output_blocks_{block[1]}_1_transformer_blocks_{idx}"


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32) if isinstance(tree, np.ndarray)
                           else tree).to(device)


def build_lllite_hooks(sd: Mapping[str, Any], cond_image: np.ndarray, multiplier: float = 1.0,
                       device=None) -> Dict[str, Any]:
    """→ {"attn1_patch": (…,), "attn2_patch": (…,)}. `sd` holds the
    modules' flat keys (numpy arrays or tensors), `cond_image` the hint
    [H, W, 3] at the request's size, uint8 or float in [0, 1], taken to
    [-1, 1] as the reference takes it (:78-79)."""
    img = np.asarray(cond_image, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    cond = torch.from_numpy(np.ascontiguousarray((img * 2.0 - 1.0).transpose(2, 0, 1)[None]))
    cond = cond.to(device)
    modules = {name: _to_tensors(w, device) for name, w in split_lllite_modules(sd).items()}
    metas = {name: _module_meta(w) for name, w in modules.items()}
    emb_cache: Dict[str, torch.Tensor] = {}

    def offsets(q, k, v, extra, which):
        pfx = f"{_module_prefix(extra)}_{which}"
        out = {"to_q": q, "to_k": k, "to_v": v}
        for proj, t in (("to_q", q), ("to_k", k), ("to_v", v)):
            name = f"{pfx}_{proj}"
            if name in modules:
                if name not in emb_cache:
                    emb_cache[name] = _cond_embed(modules[name], cond.to(t.device),
                                                  metas[name]["depth"])
                out[proj] = t + _apply_module(modules[name], metas[name], emb_cache[name], t,
                                              multiplier)
        return out["to_q"], out["to_k"], out["to_v"]

    def attn1_patch(q, k, v, extra):
        return offsets(q, k, v, extra, "attn1")

    def attn2_patch(q, k, v, extra):
        return offsets(q, k, v, extra, "attn2")

    return {"attn1_patch": (attn1_patch,), "attn2_patch": (attn2_patch,)}


def attach(p, args: Dict[str, Any], sd: Optional[Mapping[str, Any]] = None,
           cond_image: Optional[np.ndarray] = None, device=None) -> None:
    """{"model": a file's path, "image": the hint, "weight": 1.0}, the
    reference's wiring; `sd` and `cond_image` given directly win."""
    if sd is None:
        from ..core.state_dict import load_state_dict

        sd = load_state_dict(args["model"])
    if cond_image is None:
        cond_image = np.asarray(args["image"])
    hooks = build_lllite_hooks(sd, cond_image, multiplier=float(args.get("weight", 1.0)),
                               device=device)
    from ..pipeline.processing import _merge_hooks

    p.unet_hooks = _merge_hooks(p.unet_hooks, hooks)
    p.extra_generation_params["ControlLLLite"] = args.get("model", "attached")

"""LoRA / LyCORIS weight patches as functional tree transforms (port of forge_tpu/core/patches.py).

A LoRA file parses into {model dotted key: Patch}; applying a patch set is a
function params → params' that copies on write: untouched leaves are the
engine's own tensors, patched leaves are merged anew in f32 on the weights'
device (TF32 off, as the reference merges at `Precision.HIGHEST`) and cast
back, keeping the weight's memory layout (the fused convs' channels_last).
Quantized leaves get ONLINE patches instead: low-rank factors (or one dense
delta) set on the `QuantLeaf` and added after its matmul
(ops/quant.py `lora_epilogue`); the packed codes are never touched.

Key mapping: kohya/webui names are the model's own dotted keys with '.'
replaced by '_' and a lora_unet_ / lora_te_ / lora_te1_ / lora_te2_ prefix,
resolved against the key set of the loaded trees (core/convert.py
`flatten` gives it). Weights here are as the checkpoints hold them: linear [out, in],
conv OIHW, so a delta [O, I·kh·kw] reshapes straight onto a conv weight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.quant import QuantLeaf, dequantize


@dataclasses.dataclass
class Patch:
    kind: str  # lora | lokr | loha | glora | diff
    tensors: Dict[str, np.ndarray]
    alpha: Optional[float] = None
    dora_scale: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# parsing


_SUFFIXES = (
    ".lora_up.weight", ".lora_down.weight", ".alpha",
    ".lora_A.weight", ".lora_B.weight",
    ".hada_w1_a", ".hada_w1_b", ".hada_w2_a", ".hada_w2_b",
    ".lokr_w1", ".lokr_w2", ".lokr_w1_a", ".lokr_w1_b", ".lokr_w2_a", ".lokr_w2_b",
    ".diff", ".diff_b", ".dora_scale",
    ".a1.weight", ".a2.weight", ".b1.weight", ".b2.weight",  # glora
)


def group_lora_keys(sd: Mapping[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        for suf in _SUFFIXES:
            if k.endswith(suf):
                groups.setdefault(k[: -len(suf)], {})[suf[1:]] = v
                break
    return groups


def _build_key_index(model_keys) -> Dict[str, str]:
    """underscore name → real dotted stem (weights only)."""
    out = {}
    for k in model_keys:
        if k.endswith(".weight"):
            stem = k[: -len(".weight")]
            out[stem.replace(".", "_")] = stem
    return out


def match_lora(lora_sd: Mapping[str, np.ndarray], unet_keys,
               te_keys_by_name: Optional[Mapping[str, Any]] = None,
               ) -> Tuple[Dict[str, Dict[str, Patch]], List[str]]:
    """→ ({'unet': {model_key: Patch}, 'te:<name>': {...}}, unmatched names)."""
    groups = group_lora_keys(lora_sd)
    unet_index = _build_key_index(unet_keys)
    te_indexes = {name: _build_key_index(keys) for name, keys in (te_keys_by_name or {}).items()}

    result: Dict[str, Dict[str, Patch]] = {"unet": {}}
    for name in te_indexes:
        result[f"te:{name}"] = {}
    unmatched: List[str] = []
    for base, tensors in groups.items():
        target_map, stem = None, None
        if base.startswith("lora_unet_"):
            target_map, stem = result["unet"], unet_index.get(base[len("lora_unet_"):])
        elif base.startswith(("lora_te_", "lora_te1_")):
            pfx = "lora_te1_" if base.startswith("lora_te1_") else "lora_te_"
            for name, idx in te_indexes.items():
                s = idx.get(base[len(pfx):])
                if s is not None:
                    target_map, stem = result[f"te:{name}"], s
                    break
        elif base.startswith("lora_te2_"):
            for name, idx in te_indexes.items():
                if "g" in name:
                    s = idx.get(base[len("lora_te2_"):])
                    if s is not None:
                        target_map, stem = result[f"te:{name}"], s
                        break
        else:  # bare dotted-key LoRAs ("diffusion_model.xxx.lora_up.weight")
            cand = base.replace("diffusion_model.", "").replace(".", "_")
            if cand in unet_index:
                target_map, stem = result["unet"], unet_index[cand]
        if target_map is None or stem is None:
            unmatched.append(base)
            continue
        target_map[stem + ".weight"] = _make_patch(tensors)
    return result, unmatched


def _make_patch(t: Dict[str, np.ndarray]) -> Patch:
    alpha = float(t["alpha"]) if "alpha" in t else None
    dora = t.get("dora_scale")
    if "lora_up.weight" in t or "lora_B.weight" in t:
        up = t.get("lora_up.weight", t.get("lora_B.weight"))
        down = t.get("lora_down.weight", t.get("lora_A.weight"))
        return Patch("lora", {"up": up, "down": down}, alpha, dora)
    if "hada_w1_a" in t:
        return Patch("loha", t, alpha, dora)
    if "lokr_w1" in t or "lokr_w1_a" in t:
        return Patch("lokr", t, alpha, dora)
    if "a1.weight" in t:
        return Patch("glora", t, alpha, dora)
    if "diff" in t:
        return Patch("diff", t, alpha, dora)
    raise ValueError(f"unrecognized patch tensors: {list(t)}")


# ---------------------------------------------------------------------------
# merge math (reference patcher/lora.py:85-324)


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _mat(a, device) -> torch.Tensor:
    t = _f32(a, device)
    return t.reshape(t.shape[0], -1)


def _delta(patch: Patch, strength: float, weight_shape, weight: Optional[torch.Tensor] = None,
           device="cpu") -> torch.Tensor:
    """The patch's f32 change to a weight of `weight_shape`, times `strength`.
    Callers run it with TF32 off (`_highest`)."""
    t = patch.tensors
    if patch.kind == "glora":
        # ΔW = W·a1·a2 + b1·b2 (new format); the old lycoris format is
        # b2·b1 + W·a2·a1, told apart by the shapes' chirality
        a1, a2 = _mat(t["a1.weight"], device), _mat(t["a2.weight"], device)
        b1, b2 = _mat(t["b1.weight"], device), _mat(t["b2.weight"], device)
        old_glora = b2.shape[1] == b1.shape[0] == a1.shape[0] == a2.shape[1]
        if (b2.shape[0] == b1.shape[1] == a1.shape[1] == a2.shape[0]) and not (
                old_glora and a2.shape[0] == weight_shape[0] == weight_shape[-1]):
            old_glora = False
        rank = a1.shape[0] if old_glora else a2.shape[0]
        alpha = (patch.alpha / rank) if patch.alpha is not None else 1.0
        w2d = (weight.float().reshape(weight_shape[0], -1) if weight is not None else
               torch.zeros((weight_shape[0], int(np.prod(weight_shape[1:]))), device=device))
        if old_glora:
            delta = b2 @ b1 + (w2d @ a2) @ a1
        else:
            delta = (w2d @ a1) @ a2 + b1 @ b2
        return strength * (delta * alpha).reshape(weight_shape)
    if patch.kind == "lora":
        up, down = _mat(t["up"], device), _mat(t["down"], device)
        rank = down.shape[0]
        scale = (patch.alpha / rank) if patch.alpha is not None else 1.0
        delta = (up @ down) * scale
    elif patch.kind == "loha":
        w1 = _f32(t["hada_w1_a"], device) @ _mat(t["hada_w1_b"], device)
        w2 = _f32(t["hada_w2_a"], device) @ _mat(t["hada_w2_b"], device)
        rank = t["hada_w1_b"].shape[0]
        scale = (patch.alpha / rank) if patch.alpha is not None else 1.0
        delta = (w1 * w2) * scale
    elif patch.kind == "lokr":
        w1 = (_f32(t["lokr_w1"], device) if "lokr_w1" in t
              else _f32(t["lokr_w1_a"], device) @ _f32(t["lokr_w1_b"], device))
        w2 = (_f32(t["lokr_w2"], device) if "lokr_w2" in t
              else _f32(t["lokr_w2_a"], device) @ _f32(t["lokr_w2_b"], device))
        scale = 1.0
        if patch.alpha is not None and "lokr_w2_b" in t:
            scale = patch.alpha / t["lokr_w2_b"].shape[0]
        delta = torch.kron(w1, w2.reshape(w2.shape[0], -1)) * scale
    elif patch.kind == "diff":
        return strength * _f32(t["diff"], device).reshape(weight_shape)
    else:
        raise ValueError(patch.kind)
    return strength * delta.reshape(weight_shape)


class _highest:
    """f32 matmuls at full precision (TF32 off) while merging."""

    def __enter__(self):
        self._prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._prev


def _dora(w: torch.Tensor, dora_scale) -> torch.Tensor:
    """DoRA: rescale each output row of the merged weight to the learned magnitude."""
    ds = _f32(dora_scale, w.device).reshape(-1)
    norm = torch.sqrt(w.square().sum(dim=tuple(range(1, w.dim()))) + 1e-8)
    return w * (ds / norm).reshape(-1, *([1] * (w.dim() - 1)))


def _get(tree, key: str):
    node = tree
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _set(tree: Dict[str, Any], key: str, value) -> None:
    parts = key.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _copy_dicts(tree):
    """A new dict at every level, the same leaves."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def apply_patches(params: Dict[str, Any],
                  patch_sets: List[Tuple[Dict[str, Patch], float]]) -> Dict[str, Any]:
    """params tree + [(patches by key, strength)] → new tree (copy on write)."""
    merged: Dict[str, List[Tuple[Patch, float]]] = {}
    for patches, strength in patch_sets:
        if strength == 0:
            continue
        for key, patch in patches.items():
            merged.setdefault(key, []).append((patch, strength))

    out = _copy_dicts(params)
    with torch.no_grad(), _highest():
        for key, plist in merged.items():
            w = _get(out, key)
            if w is None:
                continue
            if isinstance(w, QuantLeaf):
                _set(out, key, _attach_online(w, plist))
                continue
            new_w = w.float()
            for patch, strength in plist:
                new_w = new_w + _delta(patch, strength, tuple(w.shape), weight=new_w,
                                       device=w.device)
                if patch.dora_scale is not None:
                    new_w = _dora(new_w, patch.dora_scale)
            patched = torch.empty_like(w)  # w's dtype and memory layout
            patched.copy_(new_w)
            _set(out, key, patched)
    return out


def _attach_online(leaf: QuantLeaf, plist) -> QuantLeaf:
    """Online LoRA over a quantized weight: plain low-rank patches become
    (down, up) epilogue factors, everything else (loha, lokr, glora, diff,
    DoRA) one dense delta; both bf16, as the reference keeps them. The codes
    are shared with the engine's leaf, which stays as it was."""
    out_dim, in_dim = leaf.shape
    dev = leaf.codes.device
    factors: List[Tuple[torch.Tensor, torch.Tensor]] = []
    dense = None
    base = None  # the dequantized weight, made only if a dense patch needs it
    for patch, strength in plist:
        if (patch.kind == "lora" and patch.dora_scale is None
                and np.asarray(patch.tensors["down"]).ndim <= 2):
            up, down = _mat(patch.tensors["up"], dev), _mat(patch.tensors["down"], dev)
            scale = (patch.alpha / down.shape[0]) if patch.alpha is not None else 1.0
            factors.append((down, up * (scale * strength)))
        else:
            if base is None:
                base = dequantize(leaf, torch.float32)
            d = _delta(patch, strength, (out_dim, in_dim), weight=base, device=dev)
            if patch.dora_scale is not None:
                d = _dora(base + d, patch.dora_scale) - base
            dense = d if dense is None else dense + d
    new = dataclasses.replace(leaf)
    if factors:
        downs = torch.cat([d for d, _ in factors], dim=0)  # [R, in]
        ups = torch.cat([u for _, u in factors], dim=1)    # [out, R]
        if new.lora_down is not None:  # stack onto an existing epilogue
            downs = torch.cat([new.lora_down.float(), downs], dim=0)
            ups = torch.cat([new.lora_up.float(), ups], dim=1)
        new.lora_down = downs.to(torch.bfloat16)
        new.lora_up = ups.to(torch.bfloat16)
    if dense is not None:
        prev = new.lora_dense
        new.lora_dense = (dense if prev is None else dense + prev.float()).to(torch.bfloat16)
    return new

"""Legacy A1111 hypernetworks (port of forge_tpu/extensions/hypernetworks.py):
for each cross-attention context width a pair of small residual MLPs, one
for the context that to_k reads and one for to_v's:
    context' = context + mlp(context) · strength
through the `attn2_context_patch` slot. Both checkpoint layouts load: the
old one ("linear1.*", "linear2.*") and the new one ("linear.N.*", 1-D
weights being LayerNorms). The new layout's indices skip the parameterless
activations and dropouts of the module's Sequential (Linear, ReLU,
LayerNorm, Linear is linear.0, .2, .3): the port reads every index, where
the reference stops at the first gap. The activation sits between linears, not after
the last; LayerNorm statistics are ddof 0 at eps 1e-5."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_ACTS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}


def _parse_module(sd: Mapping[str, Any], device=None) -> List[Dict[str, Any]]:
    """One module's state dict (numpy arrays or tensors) → its layers in
    order, f32 tensors on `device`."""
    def dev(v):
        if isinstance(v, torch.Tensor):
            return v.float().to(device)
        return torch.as_tensor(np.asarray(v, np.float32)).to(device)

    layers: List[Dict[str, Any]] = []
    if "linear1.weight" in sd:  # the old layout: exactly two linears
        for name in ("linear1", "linear2"):
            layers.append({"kind": "linear", "weight": dev(sd[f"{name}.weight"]),
                           "bias": dev(sd.get(f"{name}.bias", 0))})
        return layers
    indices = sorted(int(k.split(".")[1]) for k in sd
                     if k.startswith("linear.") and k.endswith(".weight") and k.count(".") == 2)
    for idx in indices:  # a parameterless activation or dropout leaves a gap in the indices
        w = dev(sd[f"linear.{idx}.weight"])
        b = sd.get(f"linear.{idx}.bias")
        if w.dim() == 2:
            layers.append({"kind": "linear", "weight": w,
                           "bias": dev(b) if b is not None else None})
        else:  # a 1-D weight: LayerNorm
            layers.append({"kind": "layernorm", "weight": w, "bias": dev(b)})
    return layers


def _module_apply(layers, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = _ACTS.get(activation.lower(), _ACTS["linear"])
    h = x
    n_linear = sum(1 for layer in layers if layer["kind"] == "linear")
    seen = 0
    for layer in layers:
        w = layer["weight"].to(device=h.device, dtype=h.dtype)
        b = layer["bias"]
        b = None if b is None else b.to(device=h.device, dtype=h.dtype)
        if layer["kind"] == "linear":
            h = h @ w.T
            if b is not None:
                h = h + b
            seen += 1
            if seen < n_linear:
                h = act(h)
        else:
            mu = h.mean(-1, keepdim=True)
            var = h.var(-1, keepdim=True, correction=0)
            h = (h - mu) / torch.sqrt(var + 1e-5) * w + b
    return x + h  # residual (hypernetwork.py HypernetworkModule.forward)


class Hypernetwork:
    def __init__(self, modules: Dict[int, Tuple[list, list]], activation: str = "linear",
                 name: str = "hypernetwork"):
        self.modules = modules  # {context width: (k layers, v layers)}
        self.activation = activation
        self.name = name

    def context_patch(self, strength: float = 1.0):
        """→ an `attn2_context_patch` hook: contexts of a width the file
        has no module for pass through."""
        modules, activation = self.modules, self.activation

        def patch(ctx_k, ctx_v, extra):
            dim = ctx_k.shape[-1]
            if dim not in modules:
                return ctx_k, ctx_v
            lk, lv = modules[dim]
            new_k = _module_apply(lk, ctx_k, activation)
            new_v = _module_apply(lv, ctx_v, activation)
            if strength != 1.0:
                new_k = ctx_k + (new_k - ctx_k) * strength
                new_v = ctx_v + (new_v - ctx_v) * strength
            return new_k, new_v

        return patch


def load_hypernetwork(path_or_sd, name: str = "hypernetwork", device=None) -> Hypernetwork:
    """A `.pt` path (read by core/state_dict.py `load_torch_object`, which
    runs no code from the file) or its loaded dict: int context widths →
    [k state, v state]; string keys are metadata (`activation_func`)."""
    if isinstance(path_or_sd, (str, bytes)):
        from ..core.state_dict import load_torch_object

        sd = load_torch_object(path_or_sd)
    else:
        sd = path_or_sd
    activation = str(sd.get("activation_func", "linear") or "linear")
    modules: Dict[int, Tuple[list, list]] = {}
    for key, value in sd.items():
        if isinstance(key, int) and isinstance(value, (list, tuple)) and len(value) == 2:
            modules[key] = (_parse_module(value[0], device), _parse_module(value[1], device))
    return Hypernetwork(modules, activation, name)


def attach(p, hn: Hypernetwork, strength: float = 1.0) -> None:
    hooks = dict(p.unet_hooks or {})
    hooks["attn2_context_patch"] = (tuple(hooks.get("attn2_context_patch", ()))
                                    + (hn.context_patch(strength),))
    p.unet_hooks = hooks
    p.extra_generation_params["Hypernet"] = hn.name
    if strength != 1.0:
        p.extra_generation_params["Hypernet strength"] = strength

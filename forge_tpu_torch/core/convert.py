"""Parameter layouts: flat dotted state dicts, nested trees, and JAX trees.

The port addresses weights by the checkpoints' dotted keys and stores them as
nested dicts of tensors (`nest`), as the JAX package does. `params_from_jax`
turns a forge_tpu parameter tree (conv kernels HWIO, activations NHWC) back
into a flat torch state dict in checkpoint layout (conv kernels OIHW), so
both packages can compute with the very same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def nest(flat: Mapping[str, Any], sep: str = ".") -> Dict[str, Any]:
    """{'a.b.c': x} → {'a': {'b': {'c': x}}}."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        parts = key.split(sep)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"key {key!r} collides with a leaf at {part!r}")
        node[parts[-1]] = value
    return out


def flatten(tree: Mapping[str, Any], sep: str = ".", prefix: str = "") -> Dict[str, Any]:
    """The inverse of `nest`."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, sep, path))
        else:
            out[path] = value
    return out


def to_tensor(value) -> torch.Tensor:
    """numpy array (or tensor) → tensor, copying only read-only buffers."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """forge_tpu nested parameter tree → flat torch state dict.

    Leaves may be numpy or JAX arrays (anything `np.asarray` reads). Every
    4-d leaf is a conv kernel that forge_tpu transposed OIHW → HWIO at load
    (`transform_for_jax`); it is transposed back with axes (3, 2, 0, 1)."""
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in flatten(tree).items():
        arr = np.asarray(leaf)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[key] = to_tensor(np.ascontiguousarray(arr))
    return out

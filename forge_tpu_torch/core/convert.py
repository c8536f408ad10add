"""Parameter layouts: flat dotted state dicts, nested trees, and JAX trees.

The port addresses weights by the checkpoints' dotted keys and stores them as
nested dicts of tensors (`nest`), as the JAX package does. `params_from_jax`
turns a forge_tpu parameter tree (conv kernels HWIO, activations NHWC) back
into a flat torch state dict in checkpoint layout (conv kernels OIHW), so
both packages can compute with the very same weights. Quantized leaves —
forge_tpu's leaf dicts or `QuantTensor`s in the flat layout, and the GGUF
reader's dicts — become the port's `QuantLeaf` (`quant_leaf`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..ops.quant import CODE_DTYPE, SCALE_DTYPE, QuantLeaf


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
        if isinstance(value, Mapping) and not is_quant_dict(value):
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


def is_quant_dict(value) -> bool:
    """A quantized leaf in forge_tpu's dict form (or its QuantTensor)."""
    return hasattr(value, "get") and value.get("kind") is not None and (
        value.get("codes") is not None or value.get("codes2d") is not None)


def quant_leaf(value) -> QuantLeaf:
    """forge_tpu / GGUF quant leaf (numpy or JAX arrays, flat layout) → QuantLeaf."""
    if isinstance(value, QuantLeaf):
        return value
    kind = value["kind"]
    if value.get("codes") is None:
        raise ValueError(f"{kind} leaf holds only the TPU kernel's repacked codes; "
                         "the port reads the flat layout (`codes`)")

    def arr(name, dtype):
        a = value.get(name)
        return None if a is None else to_tensor(np.ascontiguousarray(np.asarray(a).astype(dtype)))

    code_np = np.int8 if CODE_DTYPE[kind] == torch.int8 else np.uint8
    scale_np = np.float32 if SCALE_DTYPE[kind] == torch.float32 else np.float16
    return QuantLeaf(kind, tuple(value["shape"]), arr("codes", code_np),
                     arr("scales", scale_np), arr("mins", np.float16),
                     block=value.get("block") or 0)


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """forge_tpu nested parameter tree → flat torch state dict.

    Leaves may be numpy or JAX arrays (anything `np.asarray` reads). Every
    4-d leaf is a conv kernel that forge_tpu transposed OIHW → HWIO at load
    (`transform_for_jax`); it is transposed back with axes (3, 2, 0, 1)."""
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in flatten(tree).items():
        if is_quant_dict(leaf):
            out[key] = quant_leaf(leaf)
            continue
        arr = np.asarray(leaf)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[key] = to_tensor(np.ascontiguousarray(arr))
    return out

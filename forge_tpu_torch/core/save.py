"""State dicts → .safetensors files (port of forge_tpu/core/save.py `save_safetensors`).

The reference writes through the `safetensors` package, which the card's
machine does not have; the format is simple enough to write by hand: an
8-byte little-endian header length, a JSON header of {key: {dtype, shape,
data_offsets}} (and `__metadata__`), padded with spaces to 8 bytes, then the
raw little-endian tensors in header order. core/state_dict.py reads it back.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Mapping, Optional

import numpy as np

_DTYPE_NAMES = {
    np.dtype(np.float64): "F64", np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64", np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL",
}
_TORCH_NAMES = {"bfloat16": "BF16", "float8_e4m3fn": "F8_E4M3", "float8_e5m2": "F8_E5M2"}


def _dtype_name(value) -> str:
    """The safetensors name of a value's dtype (numpy's, torch's or a LazyTensor's)."""
    dt = getattr(value, "dtype", None)
    text = str(np.asarray(value).dtype if dt is None else dt).removeprefix("torch.")
    if text in _TORCH_NAMES:
        return _TORCH_NAMES[text]
    try:
        return _DTYPE_NAMES[np.dtype(text)]  # torch's float32, int8, bool, ... by numpy's name
    except (TypeError, KeyError):
        raise TypeError(f"dtype {text} has no safetensors name here") from None


_ITEMSIZE = {"F64": 8, "I64": 8, "F32": 4, "I32": 4, "F16": 2, "BF16": 2, "I16": 2, "I8": 1,
             "U8": 1, "BOOL": 1, "F8_E4M3": 1, "F8_E5M2": 1}


def _raw(value) -> memoryview:
    """A value's bytes, little-endian, row-major; a LazyTensor is made here."""
    if hasattr(value, "materialize"):
        value = value.materialize()
    if hasattr(value, "detach"):  # a torch tensor, on any device
        import torch

        return memoryview(value.detach().to("cpu").contiguous().reshape(-1)
                          .view(torch.uint8).numpy())
    arr = np.asarray(value)
    return memoryview(np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).reshape(-1)
                      .view(np.uint8))


def save_safetensors(sd: Mapping[str, Any], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """{key: array} → `path`, byte for byte as the safetensors package writes
    it: the tensors by element size, widest first, then by key. Values are
    numpy arrays, torch tensors (bf16 and fp8 too, on any device) or
    `LazyTensor`s, which are made one at a time as they are written, so a
    full-width checkpoint never sits in host memory whole."""
    header = {"__metadata__": dict(metadata or {"format": "pt"})}
    names = {key: _dtype_name(sd[key]) for key in sd}
    order = sorted(sd, key=lambda k: (-_ITEMSIZE[names[k]], k))
    offset = 0
    for key in order:
        shape = [int(n) for n in (sd[key].shape if hasattr(sd[key], "shape")
                                  else np.shape(sd[key]))]
        size = _ITEMSIZE[names[key]] * int(np.prod(shape, dtype=np.int64))
        header[key] = {"dtype": names[key], "shape": shape, "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for key in order:
            raw = _raw(sd[key])
            begin, end = header[key]["data_offsets"]
            if raw.nbytes != end - begin:
                raise ValueError(f"{key}: {raw.nbytes} bytes for a {header[key]['shape']} "
                                 f"{names[key]} tensor")
            f.write(raw)

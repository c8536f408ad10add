"""State dicts → .safetensors files (port of forge_tpu/core/save.py `save_safetensors`).

The reference writes through the `safetensors` package, which the card's
machine does not have; the format is simple enough to write with numpy: an
8-byte little-endian header length, a JSON header of {key: {dtype, shape,
data_offsets}} (and `__metadata__`), padded with spaces to 8 bytes, then the
raw little-endian tensors in header order. core/state_dict.py reads it back.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping, Optional

import numpy as np

_DTYPE_NAMES = {
    np.dtype(np.float64): "F64", np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64", np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL",
}


def save_safetensors(sd: Mapping[str, np.ndarray], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """{key: numpy array} → `path`, byte for byte as the safetensors package
    writes it: the tensors by element size, widest first, then by key."""
    header = {"__metadata__": dict(metadata or {"format": "pt"})}
    blobs, offset = [], 0
    for key in sorted(sd, key=lambda k: (-np.asarray(sd[k]).dtype.itemsize, k)):
        arr = np.asarray(sd[key])
        if arr.dtype not in _DTYPE_NAMES:
            raise TypeError(f"{key}: dtype {arr.dtype} has no safetensors name here")
        raw = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tobytes()
        header[key] = {"dtype": _DTYPE_NAMES[arr.dtype], "shape": list(arr.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)

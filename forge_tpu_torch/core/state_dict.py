# Copied from forge_tpu/core/state_dict.py (the safetensors reader and the .gguf route); numpy/stdlib only.
"""Checkpoint files → {key: numpy array}.

The safetensors reader and the GGUF route (core/gguf.py) are ported; torch
`.ckpt` pickles and bitsandbytes-prequantized NF4 come with the loaders that
need them.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

_SAFETENSORS_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # handled specially below
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "F8_E4M3": None,
    "F8_E5M2": None,
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 payload → float32 (numpy has no bfloat16)."""
    u32 = raw.astype(np.uint32) << 16
    return u32.view(np.float32)


def load_safetensors(path: str, keep_bf16_raw: bool = False) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into {key: numpy array}.

    bf16 tensors are widened to f32 by default (numpy cannot represent bf16);
    `keep_bf16_raw` returns them as their uint16 bit patterns.
    """
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        meta = json.loads(f.read(header_len))
        data_start = 8 + header_len
        for key, info in meta.items():
            if key == "__metadata__":
                continue
            dt = info["dtype"]
            shape = tuple(info["shape"])
            begin, end = info["data_offsets"]
            f.seek(data_start + begin)
            raw = f.read(end - begin)
            if dt == "BF16":
                u16 = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
                out[key] = u16 if keep_bf16_raw else _bf16_to_f32(u16).reshape(shape)
            elif dt in ("F8_E4M3", "F8_E5M2"):
                out[key] = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
            else:
                out[key] = np.frombuffer(raw, dtype=_SAFETENSORS_DTYPES[dt]).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """→ {key: array}; a `.gguf` file's quantized tensors come as leaf dicts."""
    if path.endswith(".safetensors") or path.endswith(".sft"):
        return load_safetensors(path)
    if path.endswith(".gguf"):
        from .gguf import load_gguf

        sd = load_gguf(path)
        sd.pop("__metadata__", None)
        return sd
    raise NotImplementedError(
        f"{path}: only .safetensors and .gguf checkpoints are read by forge_tpu_torch so far")

# Copied from forge_tpu/core/state_dict.py (the safetensors reader, the .gguf route and load_torch_ckpt, here through torch.load).
"""Checkpoint files → {key: numpy array}.

The safetensors reader, the GGUF route (core/gguf.py) and torch's zip
pickles (`.pth`, `.pt`, `.ckpt`) are ported: `load_torch_ckpt` reads the
latter with `torch.load(weights_only=True)`, which runs no code from the
file, as the reference's restricted unpickler does. Unlike the reference's
reader, it keeps nested dicts of tensors (a `params_ema` wrap) nested rather
than dropping them. bitsandbytes-prequantized NF4 comes with the loader that
needs it.
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


def _tensors_to_numpy(obj: dict) -> dict:
    """Tensors → numpy (bf16 widened to f32), nested dicts kept, anything else dropped."""
    import torch

    out = {}
    for key, value in obj.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            out[key] = (value.float() if value.dtype == torch.bfloat16 else value).numpy()
        elif isinstance(value, dict):
            out[key] = _tensors_to_numpy(value)
    return out


def load_torch_ckpt(path: str) -> Dict[str, np.ndarray]:
    """A torch zip-format checkpoint → {key: numpy array}; its `state_dict`
    entry where it has one, as the reference takes."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state dict ({type(obj).__name__})")
    return _tensors_to_numpy(obj.get("state_dict", obj))


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """→ {key: array}; a `.gguf` file's quantized tensors come as leaf dicts."""
    if path.endswith(".safetensors") or path.endswith(".sft"):
        return load_safetensors(path)
    if path.endswith(".gguf"):
        from .gguf import load_gguf

        sd = load_gguf(path)
        sd.pop("__metadata__", None)
        return sd
    return load_torch_ckpt(path)

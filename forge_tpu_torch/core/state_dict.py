# Copied from forge_tpu/core/state_dict.py (the safetensors reader, collapse_bnb_quant, the .gguf route, load_torch_ckpt and load_torch_object, here through torch.load; filter_prefix, diffusers_unet_to_ldm).
"""Checkpoint files → {key: numpy array}.

The safetensors reader, the GGUF route (core/gguf.py) and torch's zip
pickles (`.pth`, `.pt`, `.ckpt`) are ported: `load_torch_ckpt` and
`load_torch_object` (a nested `.pt` such as a hypernetwork's) read the
latter with `torch.load(weights_only=True)`, which runs no code from the
file, as the reference's restricted unpickler does. Unlike the reference's
reader, it keeps nested dicts of tensors (a `params_ema` wrap) nested rather
than dropping them.

fp8 tensors (safetensors `F8_E4M3`, `F8_E5M2`; torch's float8 storages)
come as `torch.float8_e4m3fn` / `torch.float8_e5m2` tensors, numpy having no
fp8: their values, where the reference keeps the raw bytes as uint8 and so
computes with the numbers 0–255.

`collapse_bnb_quant` folds bitsandbytes-prequantized 4-bit layers (Forge's
`flux1-dev-bnb-nf4`) into weights: NF4 at block 64 becomes a `QuantLeaf`,
the dequant-matmul kernel's own layout (the same nibble order and block-64
f32 absmax), so no code is repacked; FP4 or another block size is
dequantized to f32 here, as the reference does. `load_state_dict` applies
it to safetensors files and torch checkpoints.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Any, Dict, Mapping

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
            elif dt in _FP8_DTYPES:
                out[key] = _fp8_tensor(raw, dt, shape)
            else:
                out[key] = np.frombuffer(raw, dtype=_SAFETENSORS_DTYPES[dt]).reshape(shape)
    return out


_FP8_DTYPES = {"F8_E4M3": "float8_e4m3fn", "F8_E5M2": "float8_e5m2"}


def _fp8_tensor(raw: bytes, name: str, shape):
    """A safetensors fp8 payload → a torch fp8 tensor of its values."""
    import torch

    codes = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    return codes.view(getattr(torch, _FP8_DTYPES[name])).reshape(shape)


def _tensors_to_numpy(obj: dict) -> dict:
    """Tensors → numpy (bf16 widened to f32; fp8 kept as torch fp8 tensors),
    nested dicts kept, anything else dropped."""
    import torch

    out = {}
    for key, value in obj.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            if value.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
                out[key] = value
                continue
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


def load_torch_object(path: str):
    """A torch `.pt` with its whole nested structure (a hypernetwork's: int
    context widths → [k state, v state], and string metadata), its tensors
    as numpy arrays (bf16 widened to f32) at any depth of dicts, lists and
    tuples; everything else as the file holds it."""
    import torch

    def materialize(node):
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu()
            return (node.float() if node.dtype == torch.bfloat16 else node).numpy()
        if isinstance(node, dict):
            return {k: materialize(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(materialize(v) for v in node)
        return node

    return materialize(torch.load(path, map_location="cpu", weights_only=True))


def load_state_dict(path: str) -> Dict[str, Any]:
    """→ {key: array}; a `.gguf` file's quantized tensors come as leaf dicts,
    a bitsandbytes file's NF4 layers as `QuantLeaf`s."""
    if path.endswith(".safetensors") or path.endswith(".sft"):
        return collapse_bnb_quant(load_safetensors(path))
    if path.endswith(".gguf"):
        from .gguf import load_gguf

        sd = load_gguf(path)
        sd.pop("__metadata__", None)
        return sd
    return collapse_bnb_quant(load_torch_ckpt(path))


def collapse_bnb_quant(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Fold bitsandbytes-serialized 4-bit layers into weights.

    Per layer a file holds `{k}` (uint8 [n/2, 1], the first element in the
    high nibble), `{k}.absmax`, `{k}.quant_map` and
    `{k}.quant_state.bitsandbytes__{nf4,fp4}` (its JSON metadata as a uint8
    tensor) and, with double quantization, `{k}.nested_absmax` and
    `{k}.nested_quant_map` (uint8 `absmax` codes; the offset in the JSON),
    which are expanded to f32 absmax first. NF4 at block 64 with the NF4
    table becomes a `QuantLeaf` (one with a shape the kernel cannot take
    raises); anything else is dequantized to f32. Host numpy, one
    vectorized pass a layer."""
    qkeys = [k for k in sd if ".quant_state.bitsandbytes__" in k]
    if not qkeys:
        return sd
    from ..ops.quant import NF4_BLOCK, NF4_CODE
    from .convert import quant_leaf

    out = dict(sd)
    for qk in qkeys:
        base = qk.split(".quant_state.")[0]  # "....weight"
        qtype = qk.rsplit("bitsandbytes__", 1)[1]
        meta = json.loads(bytes(np.asarray(out.pop(qk)).astype(np.uint8).reshape(-1)).decode())
        shape = tuple(int(s) for s in meta["shape"])
        blocksize = int(meta.get("blocksize", 64))
        codes = np.asarray(out.pop(base)).reshape(-1)
        absmax = np.asarray(out.pop(base + ".absmax"))
        quant_map = np.asarray(out.pop(base + ".quant_map"), np.float32)
        if base + ".nested_absmax" in out:  # double-quantized absmax
            nab = np.asarray(out.pop(base + ".nested_absmax"), np.float32)
            nmap = np.asarray(out.pop(base + ".nested_quant_map"), np.float32)
            nbs = int(meta.get("nested_blocksize", 256))
            offset = float(meta.get("nested_offset", 0.0))
            absmax = (nmap[absmax.astype(np.int64).reshape(-1)]
                      * np.repeat(nab, nbs)[: absmax.size] + offset)
        absmax = absmax.astype(np.float32).reshape(-1)
        if (qtype == "nf4" and blocksize == NF4_BLOCK and quant_map.size == 16
                and np.allclose(quant_map, NF4_CODE, atol=1e-4)):
            if len(shape) != 2 or shape[1] % NF4_BLOCK:
                raise ValueError(f"{base}: a bitsandbytes NF4 weight of shape {shape} has no "
                                 f"kernel (it takes [out, in] with in a multiple of {NF4_BLOCK})")
            out[base] = quant_leaf({"kind": "nf4", "codes": codes, "scales": absmax,
                                    "shape": shape})
        else:  # fp4 / another block size: dequantize at load
            idx = np.stack([codes >> 4, codes & 0xF], axis=-1).reshape(-1)
            pad = (-idx.size) % blocksize
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            vals = quant_map[idx.astype(np.int64)].reshape(-1, blocksize) * absmax[:, None]
            n = int(np.prod(shape))
            out[base] = vals.reshape(-1)[:n].reshape(shape).astype(np.float32)
    return out


def filter_prefix(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries under `prefix`, the prefix stripped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def diffusers_unet_to_ldm(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """diffusers' UNet2DConditionModel keys → ldm's (input_blocks/...): the
    published mapping, the geometry read from the keys; values untouched."""
    res_map = {"norm1": "in_layers.0", "conv1": "in_layers.2",
               "time_emb_proj": "emb_layers.1", "norm2": "out_layers.0",
               "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}

    def n_of(prefix: str, part: str) -> int:
        seen = set()
        pat = re.compile(re.escape(prefix) + r"\.(\d+)\." + part + r"\.(\d+)\.")
        for k in sd:
            m = pat.match(k)
            if m:
                seen.add((int(m.group(1)), int(m.group(2))))
        return max((j for _, j in seen), default=-1) + 1

    n_down = max((int(k.split(".")[1]) for k in sd if k.startswith("down_blocks.")),
                 default=-1) + 1
    lpb = n_of("down_blocks", "resnets")
    out: Dict[str, Any] = {}

    def put(dst: str, src: str):
        for k, v in sd.items():
            if k.startswith(src + "."):
                tail = k[len(src) + 1:]
                head, _, rest = tail.partition(".")
                tail = res_map.get(head, head) + ("." + rest if rest else "")
                out[dst + "." + tail] = v

    put("input_blocks.0.0", "conv_in")
    out.update({f"time_embed.0.{t}": sd[f"time_embedding.linear_1.{t}"]
                for t in ("weight", "bias") if f"time_embedding.linear_1.{t}" in sd})
    out.update({f"time_embed.2.{t}": sd[f"time_embedding.linear_2.{t}"]
                for t in ("weight", "bias") if f"time_embedding.linear_2.{t}" in sd})
    for t in ("weight", "bias"):
        for src, dst in (("add_embedding.linear_1", "label_emb.0.0"),
                         ("add_embedding.linear_2", "label_emb.0.2")):
            if f"{src}.{t}" in sd:
                out[f"{dst}.{t}"] = sd[f"{src}.{t}"]
    idx = 1
    for i in range(n_down):
        for j in range(lpb):
            put(f"input_blocks.{idx}.0", f"down_blocks.{i}.resnets.{j}")
            if any(k.startswith(f"down_blocks.{i}.attentions.{j}.") for k in sd):
                put(f"input_blocks.{idx}.1", f"down_blocks.{i}.attentions.{j}")
            idx += 1
        if any(k.startswith(f"down_blocks.{i}.downsamplers.") for k in sd):
            put(f"input_blocks.{idx}.0.op", f"down_blocks.{i}.downsamplers.0.conv")
            idx += 1
    put("middle_block.0", "mid_block.resnets.0")
    put("middle_block.1", "mid_block.attentions.0")
    put("middle_block.2", "mid_block.resnets.1")
    n_up = max((int(k.split(".")[1]) for k in sd if k.startswith("up_blocks.")), default=-1) + 1
    idx = 0
    for i in range(n_up):
        n_res = len({k.split(".")[3] for k in sd if k.startswith(f"up_blocks.{i}.resnets.")})
        for j in range(n_res):
            put(f"output_blocks.{idx}.0", f"up_blocks.{i}.resnets.{j}")
            has_attn = any(k.startswith(f"up_blocks.{i}.attentions.{j}.") for k in sd)
            if has_attn:
                put(f"output_blocks.{idx}.1", f"up_blocks.{i}.attentions.{j}")
            if j == n_res - 1 and any(k.startswith(f"up_blocks.{i}.upsamplers.") for k in sd):
                put(f"output_blocks.{idx}.{2 if has_attn else 1}.conv",
                    f"up_blocks.{i}.upsamplers.0.conv")
            idx += 1
    put("out.0", "conv_norm_out")
    put("out.2", "conv_out")
    return out

"""Low-bit weight quantization: NF4 and the GGUF block kinds (port of forge_tpu/ops/quant.py).

A quantized weight is a `QuantLeaf` in the quantizers' native flat layout:
the `[out, in]` weight flattened row-major and cut into blocks of `block`
elements, with per-block scales (and mins for the asymmetric kinds):

    kind  codes                                         scales, mins     block
    nf4   uint8, 2 per byte, hi nibble = even element   f32 absmax       64
    q8_0  int8                                          f16              32
    q4_0  uint8, 2 per byte: lo = j, hi = j+16 of 32    f16              32
    gq4   uint8, 2 per byte, hi nibble = even element   f16, f16         16 | 32
    gq8   int8 (unsigned code − 128)                    f16, f16         16 | 32

value = NF4_CODE[c]·s (nf4), c·s (q8_0), (c−8)·s (q4_0), c·s − m (gq4, gq8).
The CUDA kernel (csrc/dequant_matmul.cu) decodes this layout as it is, so
nothing is repacked at load and one copy of the codes exists — where the TPU
kernel needed a second, half-packed copy (forge_tpu/ops/dequant_matmul.py
`prepare_for_kernel`).

The quantizers run on any device and give the numpy quantizers' codes and
scales bit for bit: the same f32 arithmetic, `torch.round` and `np.round`
both round half to even, and NF4 keeps the nearest-code search over the
table's midpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_BLOCK = 64
GGUF_BLOCK = 32
DEFAULT_BLOCK = {"nf4": NF4_BLOCK, "q8_0": GGUF_BLOCK, "q4_0": GGUF_BLOCK,
                 "gq4": GGUF_BLOCK, "gq8": GGUF_BLOCK}
SCALE_DTYPE = {"nf4": torch.float32, "q8_0": torch.float16, "q4_0": torch.float16,
               "gq4": torch.float16, "gq8": torch.float16}
CODE_DTYPE = {"nf4": torch.uint8, "q8_0": torch.int8, "q4_0": torch.uint8,
              "gq4": torch.uint8, "gq8": torch.int8}
PACKED = ("nf4", "q4_0", "gq4")  # two 4-bit codes per byte


@dataclasses.dataclass
class QuantLeaf:
    """A block-quantized `[out, in]` weight; `lora_*` carry online-LoRA terms
    added after the product (reference backend/operations.py:16-53)."""

    kind: str
    shape: Tuple[int, ...]
    codes: torch.Tensor
    scales: torch.Tensor
    mins: Optional[torch.Tensor] = None
    block: int = 0
    lora_down: Optional[torch.Tensor] = None
    lora_up: Optional[torch.Tensor] = None
    lora_dense: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.block = int(self.block or DEFAULT_BLOCK[self.kind])

    def to(self, device) -> "QuantLeaf":
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name, value in moved.items():
            if isinstance(value, torch.Tensor):
                moved[name] = value.to(device)
        return QuantLeaf(**moved)


def lora_epilogue(y: torch.Tensor, x2: torch.Tensor, leaf: QuantLeaf) -> torch.Tensor:
    """y [M, out] + x2·downᵀ·upᵀ (+ x2·denseᵀ): the online-LoRA terms of a leaf."""
    if leaf.lora_down is not None:
        t = x2 @ leaf.lora_down.to(x2.dtype).T
        y = y + (t @ leaf.lora_up.to(x2.dtype).T).to(y.dtype)
    if leaf.lora_dense is not None:
        y = y + (x2 @ leaf.lora_dense.to(x2.dtype).T).to(y.dtype)
    return y


def _blocks(w: torch.Tensor, block: int) -> torch.Tensor:
    """Flatten to f32 and zero-pad to whole blocks → [n_blocks, block]."""
    flat = w.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _pack_pairs(idx: torch.Tensor) -> torch.Tensor:
    """uint8 codes < 16 in element order → bytes with the even element in the hi nibble."""
    flat = idx.reshape(-1)
    return (flat[0::2] << 4) | flat[1::2]


def quantize_nf4(w: torch.Tensor, block: int = NF4_BLOCK) -> QuantLeaf:
    """fp weight → NF4 blocks (absmax-scaled, nearest code)."""
    blocks = _blocks(w, block)
    table = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.device)
    mids = (table[:-1] + table[1:]) * 0.5
    absmax = blocks.abs().amax(dim=1)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    idx = torch.searchsorted(mids, (blocks / safe[:, None]).contiguous()).to(torch.uint8)
    return QuantLeaf("nf4", tuple(w.shape), _pack_pairs(idx), absmax, block=block)


def quantize_q8_0(w: torch.Tensor) -> QuantLeaf:
    blocks = _blocks(w, GGUF_BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -128, 127).to(torch.int8)
    return QuantLeaf("q8_0", tuple(w.shape), q.reshape(-1), scale.to(torch.float16))


def quantize_q4_0(w: torch.Tensor) -> QuantLeaf:
    blocks = _blocks(w, GGUF_BLOCK)
    amax = blocks.gather(1, blocks.abs().argmax(dim=1, keepdim=True))[:, 0]  # signed
    scale = amax / -8.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(blocks / safe[:, None] + 8.5, 0, 15).to(torch.uint8)  # truncates
    packed = q[:, :16] | (q[:, 16:] << 4)
    return QuantLeaf("q4_0", tuple(w.shape), packed.reshape(-1), scale.to(torch.float16))


def _asym(w: torch.Tensor, block: int, levels: float):
    g = w.reshape(-1, block).to(torch.float32)
    lo, hi = g.amin(dim=1), g.amax(dim=1)
    scale = torch.where(hi > lo, (hi - lo) / levels, torch.ones_like(lo))
    u = torch.clamp(torch.round((g - lo[:, None]) / scale[:, None]), 0, levels)
    return u, lo, scale


def quantize_gq4(w: torch.Tensor, block: int = 32) -> QuantLeaf:
    """Asymmetric 4-bit min/max quantization (test and utility producer)."""
    u, lo, scale = _asym(w, block, 15.0)
    return QuantLeaf("gq4", tuple(w.shape), _pack_pairs(u.to(torch.uint8)),
                     scale.to(torch.float16), (-lo).to(torch.float16), block=block)


def quantize_gq8(w: torch.Tensor, block: int = 32) -> QuantLeaf:
    """Asymmetric 8-bit over 0..255, stored as int8 c = u − 128 with the
    +128·scale shift folded into the min."""
    u, lo, scale = _asym(w, block, 255.0)
    q = (u - 128).to(torch.int8)
    return QuantLeaf("gq8", tuple(w.shape), q.reshape(-1), scale.to(torch.float16),
                     (-lo - 128.0 * scale).to(torch.float16), block=block)


_QUANT = {"nf4": quantize_nf4, "q8_0": quantize_q8_0, "q4_0": quantize_q4_0,
          "gq4": quantize_gq4, "gq8": quantize_gq8}


def quantize(w: torch.Tensor, kind: str) -> QuantLeaf:
    if kind not in _QUANT:
        raise NotImplementedError(f"quantization kind {kind!r} is not ported "
                                  f"(ported: {', '.join(_QUANT)})")
    return _QUANT[kind](w)


def dequantize(leaf: QuantLeaf, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """QuantLeaf → dense `[out, in]` weight: f32 arithmetic, then `dtype`."""
    kind, block = leaf.kind, leaf.block
    codes = leaf.codes
    scales = leaf.scales.to(torch.float32)[:, None]
    if kind in PACKED:
        if kind == "q4_0":
            packed = codes.reshape(-1, block // 2)
            c = torch.cat([packed & 0xF, packed >> 4], dim=1).to(torch.float32)
        else:
            c = torch.stack([codes >> 4, codes & 0xF], dim=-1).reshape(-1, block)
    else:
        c = codes.reshape(-1, block).to(torch.float32)
    if kind == "nf4":
        table = torch.tensor(NF4_CODE, dtype=torch.float32, device=codes.device)
        vals = table[c.long()] * scales
    elif kind == "q4_0":
        vals = (c - 8.0) * scales
    elif kind in ("gq4", "gq8"):
        vals = c.to(torch.float32) * scales - leaf.mins.to(torch.float32)[:, None]
    else:  # q8_0
        vals = c * scales
    n = math.prod(leaf.shape)
    return vals.reshape(-1)[:n].reshape(leaf.shape).to(dtype)

# Copied from forge_tpu/core/gguf.py; numpy/stdlib only, so the port imports no JAX.
"""GGUF container reader.

Replaces the reference's vendored gguf package (packages_3rdparty/gguf +
backend/operations_gguf.py) for loading .gguf checkpoints (quantized Flux
etc.). Implements the public GGUF v2/v3 binary layout: magic, metadata KV
table, tensor-info table, aligned data section. Quantized tensors surface as
leaf dicts (numpy codes + f16 scales, the flat layout of ops/quant.py) that
the loader turns into `QuantLeaf`s for the dequant-matmul kernel; F32/F16
tensors load as numpy arrays.

Supported ggml tensor types: F32/F16/BF16 (arrays); Q4_0, Q8_0 (symmetric
fused-kernel leaves); Q4_1, Q5_0, Q5_1 and the K-quants Q2_K…Q6_K, which all
reduce to the generalized asymmetric leaves gq4/gq8 (value = scale·code −
min per 16/32-group) after unpacking their super-block scales — those run
the asymmetric decoders of csrc/dequant_matmul.cu.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

import numpy as np

_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

# ggml tensor dtypes
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_BF16 = 30

_BLOCK = 32
_QK_K = 256  # K-quant super-block


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int):
    if vtype == _T_U8:
        return struct.unpack("<B", f.read(1))[0]
    if vtype == _T_I8:
        return struct.unpack("<b", f.read(1))[0]
    if vtype == _T_U16:
        return struct.unpack("<H", f.read(2))[0]
    if vtype == _T_I16:
        return struct.unpack("<h", f.read(2))[0]
    if vtype == _T_U32:
        return struct.unpack("<I", f.read(4))[0]
    if vtype == _T_I32:
        return struct.unpack("<i", f.read(4))[0]
    if vtype == _T_F32:
        return struct.unpack("<f", f.read(4))[0]
    if vtype == _T_BOOL:
        return bool(f.read(1)[0])
    if vtype == _T_STR:
        return _read_str(f)
    if vtype == _T_ARR:
        (atype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, atype) for _ in range(n)]
    if vtype == _T_U64:
        return struct.unpack("<Q", f.read(8))[0]
    if vtype == _T_I64:
        return struct.unpack("<q", f.read(8))[0]
    if vtype == _T_F64:
        return struct.unpack("<d", f.read(8))[0]
    raise ValueError(f"unknown gguf value type {vtype}")


def _tensor_bytes(ggml_type: int, n: int) -> int:
    if ggml_type == GGML_F32:
        return n * 4
    if ggml_type in (GGML_F16, GGML_BF16):
        return n * 2
    if ggml_type in (GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K):
        super_blocks = n // _QK_K
        return super_blocks * {
            GGML_Q2_K: 84,   # 16 scales + 64 qs + d + dmin
            GGML_Q3_K: 110,  # 32 hmask + 64 qs + 12 scales + d
            GGML_Q4_K: 144,  # d + dmin + 12 scales + 128 qs
            GGML_Q5_K: 176,  # d + dmin + 12 scales + 32 qh + 128 qs
            GGML_Q6_K: 210,  # 128 ql + 64 qh + 16 scales + d
        }[ggml_type]
    blocks = n // _BLOCK
    return {
        GGML_Q4_0: blocks * 18,
        GGML_Q4_1: blocks * 20,
        GGML_Q5_0: blocks * 22,
        GGML_Q5_1: blocks * 24,
        GGML_Q8_0: blocks * 34,
    }[ggml_type]


def _decode_tensor(raw: bytes, ggml_type: int, shape) -> Any:
    n = int(np.prod(shape))
    if ggml_type == GGML_F32:
        return np.frombuffer(raw, np.float32).reshape(shape)
    if ggml_type == GGML_F16:
        return np.frombuffer(raw, np.float16).astype(np.float32).reshape(shape)
    if ggml_type == GGML_BF16:
        u16 = np.frombuffer(raw, np.uint16)
        return (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    blocks = n // _BLOCK
    if ggml_type == GGML_Q8_0:
        rec = np.frombuffer(raw, dtype=np.dtype([("scale", "<f2"), ("q", "i1", (32,))]))
        return {"kind": "q8_0", "codes": rec["q"].reshape(-1).copy(),
                "scales": rec["scale"].copy(), "shape": tuple(shape)}
    if ggml_type == GGML_Q4_0:
        rec = np.frombuffer(raw, dtype=np.dtype([("scale", "<f2"), ("q", "u1", (16,))]))
        return {"kind": "q4_0", "codes": rec["q"].reshape(-1).copy(),
                "scales": rec["scale"].copy(), "shape": tuple(shape)}
    # Two-parameter 32-blocks → the generalized asymmetric leaves:
    # value = scale·code − min (ops/quant.py gq4/gq8).
    if ggml_type == GGML_Q4_1:
        rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"), ("m", "<f2"), ("q", "u1", (16,))]))
        lo = rec["q"] & 0xF
        hi = rec["q"] >> 4
        codes = np.concatenate([lo, hi], axis=1)  # element order per block
        return _gq4_leaf(codes, rec["d"].astype(np.float32),
                         -rec["m"].astype(np.float32), shape, block=_BLOCK)
    if ggml_type in (GGML_Q5_0, GGML_Q5_1):
        has_min = ggml_type == GGML_Q5_1
        fields = [("d", "<f2")] + ([("m", "<f2")] if has_min else []) + [("qh", "<u4"), ("q", "u1", (16,))]
        rec = np.frombuffer(raw, dtype=np.dtype(fields))
        lo = (rec["q"] & 0xF).astype(np.uint8)
        hi = (rec["q"] >> 4).astype(np.uint8)
        vals = np.concatenate([lo, hi], axis=1)  # [blocks, 32] low 4 bits
        bits = ((rec["qh"][:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
        vals = vals | (bits << 4)  # 5-bit codes 0..31
        d = rec["d"].astype(np.float32)
        if has_min:
            mins = -rec["m"].astype(np.float32)
        else:
            mins = 16.0 * d  # value = d·(q−16) = d·q − 16d
        return _gq8_leaf(vals, d, mins, shape, block=_BLOCK)

    # K-quants: 256-element super-blocks with packed 6-bit/4-bit sub-scales
    # (ggml spec; unpacking mirrors packages_3rdparty/gguf/quants.py:624-780).
    if ggml_type in (GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K):
        return _decode_kquant(raw, ggml_type, shape)
    raise ValueError(f"unsupported ggml tensor type {ggml_type}")


def _gq4_leaf(codes_u8, scales, mins, shape, block):
    """codes_u8: [blocks, block] unpacked 4-bit values in element order."""
    flat = codes_u8.reshape(-1)
    packed = (flat[0::2] << 4) | flat[1::2]
    return {"kind": "gq4", "codes": packed, "scales": scales.astype(np.float16),
            "mins": mins.astype(np.float16), "shape": tuple(shape), "block": block}


def _gq8_leaf(codes, scales, mins, shape, block):
    return {"kind": "gq8", "codes": codes.reshape(-1).astype(np.int8),
            "scales": scales.astype(np.float16), "mins": mins.astype(np.float16),
            "shape": tuple(shape), "block": block}


def _unpack_kscales(scales12: np.ndarray):
    """Q4_K/Q5_K 12-byte packed 6-bit (scale, min) pairs → two [N, 8] arrays
    (ggml get_scale_min_k4 layout)."""
    s = scales12.reshape(-1, 3, 4)
    d, m, m_d = s[:, 0], s[:, 1], s[:, 2]
    sc = np.concatenate([d & 0x3F, (m_d & 0x0F) | ((d >> 2) & 0x30)], axis=-1)
    mn = np.concatenate([m & 0x3F, (m_d >> 4) | ((m >> 2) & 0x30)], axis=-1)
    return sc, mn


def _decode_kquant(raw: bytes, ggml_type: int, shape):
    buf = np.frombuffer(raw, np.uint8)
    n = int(np.prod(shape))
    nb = n // _QK_K

    if ggml_type == GGML_Q2_K:
        b = buf.reshape(nb, 84)
        scales, qs = b[:, :16], b[:, 16:80]
        d = b[:, 80:82].copy().view(np.float16).astype(np.float32)
        dmin = b[:, 82:84].copy().view(np.float16).astype(np.float32)
        dl = d * (scales & 0xF).astype(np.float32)          # [nb, 16]
        ml = dmin * (scales >> 4).astype(np.float32)
        shift = np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
        q = ((qs.reshape(nb, 2, 1, 32) >> shift) & 3).reshape(nb, 16, 16)
        return _gq4_leaf(q.reshape(-1, 16), dl.reshape(-1), ml.reshape(-1),
                         shape, block=16)

    if ggml_type == GGML_Q3_K:
        b = buf.reshape(nb, 110)
        hmask, qs, scales, d = b[:, :32], b[:, 32:96], b[:, 96:108], b[:, 108:110]
        d = d.copy().view(np.float16).astype(np.float32)
        ls = (scales[:, :8].reshape(nb, 1, 8)
              >> np.array([0, 4], np.uint8).reshape(1, 2, 1)).reshape(nb, 16)
        hs = (scales[:, 8:].reshape(nb, 1, 4)
              >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 4, 1)).reshape(nb, 16)
        sc = ((ls & 0x0F) | ((hs & 0x03) << 4)).astype(np.int8) - 32
        dl = (d * sc.astype(np.float32))                      # [nb, 16]
        shift = np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
        ql = ((qs.reshape(nb, 2, 1, 32) >> shift) & 3).reshape(nb, 16, 16)
        hshift = np.arange(8, dtype=np.uint8).reshape(1, 1, 8, 1)
        qh = ((hmask.reshape(nb, 1, 1, 32) >> hshift) & 1).reshape(nb, 16, 16)
        qh = qh ^ 1  # offset is zero when the high bit is set
        # value = dl·(ql − 4·qh) = dl·c − min with c = ql + 4·(1−qh) ∈ [0,7]
        c = (ql + 4 * (1 - qh)).astype(np.uint8)
        mins = 4.0 * dl
        return _gq4_leaf(c.reshape(-1, 16), dl.reshape(-1), mins.reshape(-1),
                         shape, block=16)

    if ggml_type == GGML_Q4_K:
        b = buf.reshape(nb, 144)
        d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
        dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
        sc, mn = _unpack_kscales(b[:, 4:16])
        qs = b[:, 16:]
        dl = d * sc.astype(np.float32)                        # [nb, 8]
        ml = dmin * mn.astype(np.float32)
        q = ((qs.reshape(nb, 4, 1, 32)
              >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)) & 0x0F)
        q = q.reshape(nb, 8, 32)
        return _gq4_leaf(q.reshape(-1, 32), dl.reshape(-1), ml.reshape(-1),
                         shape, block=32)

    if ggml_type == GGML_Q5_K:
        b = buf.reshape(nb, 176)
        d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
        dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
        sc, mn = _unpack_kscales(b[:, 4:16])
        qh, qs = b[:, 16:48], b[:, 48:]
        dl = d * sc.astype(np.float32)
        ml = dmin * mn.astype(np.float32)
        ql = ((qs.reshape(nb, 4, 1, 32)
               >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)) & 0x0F)
        hb = ((qh.reshape(nb, 1, 1, 32)
               >> np.arange(8, dtype=np.uint8).reshape(1, 1, 8, 1)) & 1)
        q = (ql.reshape(nb, 8, 32) | (hb.reshape(nb, 8, 32) << 4))
        return _gq8_leaf(q, dl.reshape(-1), ml.reshape(-1), shape, block=32)

    # Q6_K
    b = buf.reshape(nb, 210)
    ql, qh, scales, d = b[:, :128], b[:, 128:192], b[:, 192:208], b[:, 208:210]
    d = d.copy().view(np.float16).astype(np.float32)
    sc = scales.view(np.int8).astype(np.float32)              # [nb, 16]
    dl = d * sc
    lo = ((ql.reshape(nb, 2, 1, 64)
           >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)) & 0x0F).reshape(nb, 8, 32)
    hi = ((qh.reshape(nb, 2, 1, 32)
           >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)) & 0x03).reshape(nb, 8, 32)
    q = ((lo | (hi << 4)).astype(np.int8) - 32).reshape(nb, 16, 16)
    return _gq8_leaf(q, dl.reshape(-1), np.zeros_like(dl).reshape(-1),
                     shape, block=16)


def load_gguf(path: str) -> Dict[str, Any]:
    """→ flat {name: np.ndarray | quant leaf dict} plus '__metadata__'."""
    out: Dict[str, Any] = {}
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError("not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version < 2:
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))

        meta: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)

        infos = []
        for _ in range(n_tensors):
            name = _read_str(f)
            (nd,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))
            ttype, offset = struct.unpack("<IQ", f.read(12))
            # gguf dims are innermost-first; numpy wants outermost-first
            shape = tuple(reversed(dims))
            infos.append((name, shape, ttype, offset))

        align = int(meta.get("general.alignment", 32))
        data_start = f.tell()
        data_start += (-data_start) % align

        for name, shape, ttype, offset in infos:
            f.seek(data_start + offset)
            raw = f.read(_tensor_bytes(ttype, int(np.prod(shape))))
            out[name] = _decode_tensor(raw, ttype, shape)

    out["__metadata__"] = meta
    return out

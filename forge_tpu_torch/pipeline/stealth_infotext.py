# Copied from forge_tpu/pipeline/stealth_infotext.py (add_stealth_infotext, read_stealth_infotext); numpy only.
"""Stealth infotext: generation parameters hidden in alpha-channel LSBs.

Behavioral twin of the reference's stealth PNG info
(modules/stealth_infotext.py:7-150, 'stealth_pnginfo' alpha mode): a magic
signature then gzip-compressed UTF-8 parameters, one bit per pixel in the
alpha channel, written column-major. Survives tEXt-stripping rehosting.

Library functions: as in forge_tpu, nothing in the pipeline calls them."""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

_SIG = "stealth_pngcomp"


def _bits_from_bytes(data: bytes):
    for byte in data:
        for i in range(7, -1, -1):
            yield (byte >> i) & 1


def add_stealth_infotext(image: np.ndarray, infotext: str) -> np.ndarray:
    """[H,W,3] uint8 → [H,W,4] uint8 with parameters in alpha LSBs."""
    h, w = image.shape[:2]
    rgba = np.concatenate(
        [image, np.full((h, w, 1), 255, np.uint8)], axis=-1
    )
    payload = gzip.compress(infotext.encode("utf-8"))
    sig_bits = list(_bits_from_bytes(_SIG.encode("utf-8")))
    len_bits = list(_bits_from_bytes(len(payload).to_bytes(4, "big")))
    data_bits = list(_bits_from_bytes(payload))
    bits = sig_bits + len_bits + data_bits
    if len(bits) > h * w:
        return rgba  # image too small to carry the payload

    alpha = rgba[:, :, 3].astype(np.uint8)
    flat = alpha.T.reshape(-1)  # column-major like the reference
    for i, bit in enumerate(bits):
        flat[i] = (flat[i] & 0xFE) | bit
    rgba[:, :, 3] = flat.reshape(w, h).T
    return rgba


def read_stealth_infotext(image: np.ndarray) -> Optional[str]:
    if image.ndim != 3 or image.shape[2] != 4:
        return None
    h, w = image.shape[:2]
    flat = image[:, :, 3].T.reshape(-1) & 1
    n_sig = len(_SIG) * 8
    sig_bits = np.asarray(list(_bits_from_bytes(_SIG.encode("utf-8"))), np.uint8)
    if flat.shape[0] < n_sig + 32 or not np.array_equal(flat[:n_sig], sig_bits):
        return None
    length = int.from_bytes(np.packbits(flat[n_sig : n_sig + 32]).tobytes(), "big")
    total_bits = length * 8
    start = n_sig + 32
    if start + total_bits > flat.shape[0]:
        return None
    payload = np.packbits(flat[start : start + total_bits]).tobytes()
    try:
        return gzip.decompress(payload).decode("utf-8")
    except Exception:
        return None

# Copied from forge_tpu/pipeline/merger.py (weighted_sum, add_difference, run_modelmerger); numpy only, written through the port's core/save.py.
"""Checkpoint merger: weighted-sum / add-difference of up to three
checkpoints, optional VAE bake-in, fp16 export.

Behavioral twin of the reference's run_modelmerger (modules/extras.py:88):
merges operate on raw flat state dicts (host numpy, streaming-friendly) so
device memory is untouched. Modes: "weighted_sum" a·(1 − m) + b·m,
"add_difference" a + (b − c)·m and "no_interpolation" (the primary alone);
a key the secondary lacks, or holds at another shape, keeps the primary's
value. `bake_in_vae` overlays a VAE file's weights under
`first_stage_model.`, `discard_weights` drops the keys a regular expression
finds, and float tensors are written as `dtype` (fp16 unless given).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.state_dict import load_state_dict
from ..core.save import save_safetensors


def weighted_sum(a, b, alpha: float):
    return a * (1.0 - alpha) + b * alpha


def add_difference(a, b, c, alpha: float):
    return a + (b - c) * alpha


def run_modelmerger(
    primary: str,
    secondary: str,
    tertiary: Optional[str] = None,
    mode: str = "weighted_sum",  # weighted_sum | add_difference | no_interpolation
    multiplier: float = 0.3,
    bake_in_vae: Optional[str] = None,
    output_path: str = "merged.safetensors",
    dtype=np.float16,
    discard_weights: Optional[str] = None,
) -> str:
    sd_a = load_state_dict(primary) if isinstance(primary, str) else dict(primary)
    if isinstance(secondary, str) and mode != "no_interpolation":
        sd_b = load_state_dict(secondary)
    else:
        sd_b = secondary if isinstance(secondary, dict) else None
    sd_c = None
    if mode == "add_difference":
        if tertiary is None:
            raise ValueError("add_difference requires a tertiary checkpoint")
        sd_c = load_state_dict(tertiary) if isinstance(tertiary, str) else dict(tertiary)

    out: Dict[str, np.ndarray] = {}
    for key, va in sd_a.items():
        if mode == "no_interpolation" or sd_b is None or key not in sd_b:
            merged = np.asarray(va, np.float32)
        else:
            vb = np.asarray(sd_b[key], np.float32)
            va32 = np.asarray(va, np.float32)
            if va32.shape != vb.shape:
                merged = va32  # e.g. inpaint-model extra channels: keep primary
            elif mode == "add_difference":
                vc = np.asarray(sd_c.get(key, 0.0), np.float32)
                merged = add_difference(va32, vb, vc, multiplier)
            else:
                merged = weighted_sum(va32, vb, multiplier)
        out[key] = merged.astype(dtype) if merged.dtype.kind == "f" else merged

    if bake_in_vae:
        vae_sd = load_state_dict(bake_in_vae)
        for key, v in vae_sd.items():
            k = key if key.startswith("first_stage_model.") else f"first_stage_model.{key}"
            arr = np.asarray(v, np.float32)
            out[k] = arr.astype(dtype) if arr.dtype.kind == "f" else arr

    if discard_weights:
        import re

        pat = re.compile(discard_weights)
        out = {k: v for k, v in out.items() if not pat.search(k)}

    save_safetensors(out, output_path)
    return output_path

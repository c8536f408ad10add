"""The device and dtype an entry point takes when its caller names none.

Entry points run on the CUDA card unless the caller asks for the CPU: where
there is no card, `default_device` raises rather than quietly taking the
CPU. The compute dtype is bf16 on CUDA and f32 elsewhere, as the reference
picks bf16 on the TPU and f32 elsewhere.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device an engine runs on unless the caller names one: the CUDA
    card. Where there is none this raises; the CPU is taken only on request."""
    if not torch.cuda.is_available():
        raise RuntimeError("forge_tpu_torch: no CUDA device found; pass device=\"cpu\" "
                           "to run on the CPU")
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32

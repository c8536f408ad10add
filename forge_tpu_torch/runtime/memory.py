# Copied from forge_tpu/runtime/memory.py (the estimators, Plan and plan_generation, constants unchanged); device_memory reads the CUDA card.
"""Device memory planning: before a request samples, estimate what its
activations and its VAE decode need and decide up front how to chunk the
batch and whether the VAE runs in tiles (the reference's `plan_generation`).

The estimators keep the reference's constants: the UNet's activations at
scaler 2.2 (flash) or 2.6 times B·H·W·dtype·16384/64, and the VAE decode at
2178·h·w·64·dtype per latent pixel. `device_memory` reads
`torch.cuda.mem_get_info` on the engine's device; on the CPU it returns the
zeros the reference returns where no statistics exist, and the plan then
assumes a 16 GiB device less the weights, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def device_memory(device=None) -> dict:
    """{'total': bytes, 'used': bytes, 'free': bytes} of `device` (the current
    CUDA device when None); zeros on the CPU or where CUDA is absent."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {"total": 0, "used": 0, "free": 0}
    free, total = torch.cuda.mem_get_info(dev)
    return {"total": int(total), "used": int(total - free), "free": int(free)}


def unet_activation_bytes(batch: int, height: int, width: int,
                          dtype_size: int = 2, flash: bool = True) -> int:
    """The UNet's activations for a forward at CFG batch `batch` on an image of
    height × width pixels: scaler·B·H·W·dtype·16384/64, scaler 2.2 with flash
    attention and 2.6 without."""
    scaler = 2.2 if flash else 2.6
    return int(scaler * batch * height * width * dtype_size * 16384 / 64)


def vae_decode_bytes(latent_h: int, latent_w: int, dtype_size: int = 2,
                     batch: int = 1) -> int:
    """The VAE decode's activations: 2178·h·w·64·dtype per latent pixel, times batch."""
    return int(batch * 2178 * latent_h * latent_w * 64 * dtype_size / 2)


@dataclasses.dataclass
class Plan:
    batch_chunk: int  # images a forward
    tiled_vae: bool
    note: str = ""


def plan_generation(batch: int, height: int, width: int,
                    weight_bytes: int, free_bytes: Optional[int] = None,
                    reserve: int = 1 << 30, device=None) -> Plan:
    """Chunk the batch until its CFG-batched forward fits the free memory less
    `reserve`, halving (rounded up); tile the VAE where the chunk's decode
    would not fit. `free_bytes` defaults to what `device_memory(device)` reads."""
    free = device_memory(device)["free"] if free_bytes is None else free_bytes
    if free <= 0:  # no statistics: assume a 16 GiB device less the weights
        free = (16 << 30) - weight_bytes
    budget = max(free - reserve, 1 << 28)

    chunk = batch
    while chunk > 1 and unet_activation_bytes(chunk * 2, height, width) > budget:
        chunk = (chunk + 1) // 2

    tiled = vae_decode_bytes(height // 8, width // 8, batch=chunk) > budget
    note = ""
    if chunk < batch:
        note += f"batch chunked {batch}->{chunk}; "
    if tiled:
        note += "tiled VAE; "
    return Plan(batch_chunk=chunk, tiled_vae=tiled, note=note.strip())


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested parameter tree (a quantized leaf's
    codes, scales and mins)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0

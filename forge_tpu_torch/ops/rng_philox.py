# Copied from forge_tpu/ops/rng_philox.py without the native-library fast path; numpy only.
"""Counter-based Philox4x32-10 RNG reproducing torch CUDA `randn` semantics.

Stable Diffusion seeds are user-visible API surface: the same (seed, shape)
must produce the same initial latent noise as the reference webui, whose noise
source is torch's CUDA Philox generator (reproduced on CPU by the reference in
modules/rng_philox.py). We implement the algorithm from the public spec
(Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3", SC'11) plus the
cuRAND normal4 output layout:

  * key = (seed_lo32, seed_hi32)
  * element i is produced by counter = (offset, 0, i, 0); one Philox4x32-10
    evaluation yields 4 uint32 words
  * Box-Muller on word pair (0,1); the CUDA randn layout keeps only the first
    normal of the pair (verified element-exact against the reference generator
    for many seeds/shapes/call sequences)
  * `offset` advances by 1 per randn() call, so consecutive calls on one
    generator (subseed noise, per-step sampler noise) also reproduce

Everything is vectorized numpy on uint32/uint64; noise is generated on host
(cheap — kilobytes per image) and shipped to device once per generation, like
the reference's CPU-RNG mode.
"""

from __future__ import annotations

import numpy as np

_M0 = np.uint64(0xD2511F53)
_M1 = np.uint64(0xCD9E8D57)
_W0 = np.uint32(0x9E3779B9)
_W1 = np.uint32(0xBB67AE85)
# cuRAND's CURAND_2POW32_INV literal, rounded to float32 then widened — the
# exact constants torch's CUDA normal kernel (and hence every SD seed in the
# wild) bakes into its Box-Muller. Do not "fix" the precision: bit-exact seed
# reproduction depends on these very roundings.
_INV32 = np.float64(np.float32(2.3283064e-10))
_INV32_2PI = np.float64(np.float32(2.3283064e-10 * 6.2831855))


def _philox4_round(counter: np.ndarray, key: np.ndarray) -> None:
    """One Philox4x32 round, in place. counter: [4, n] u32, key: [2, n] u32."""
    v0 = counter[0].astype(np.uint64) * _M0
    v1 = counter[2].astype(np.uint64) * _M1
    hi0 = (v0 >> np.uint64(32)).astype(np.uint32)
    lo0 = v0.astype(np.uint32)
    hi1 = (v1 >> np.uint64(32)).astype(np.uint32)
    lo1 = v1.astype(np.uint32)
    counter[0] = hi1 ^ counter[1] ^ key[0]
    counter[1] = lo1
    counter[2] = hi0 ^ counter[3] ^ key[1]
    counter[3] = lo0


def philox4x32_10(counter: np.ndarray, key: np.ndarray) -> np.ndarray:
    """10-round Philox4x32. counter [4,n], key [2,n] → [4,n] u32."""
    counter = counter.copy()
    key = key.copy()
    for _ in range(9):
        _philox4_round(counter, key)
        key[0] = key[0] + _W0
        key[1] = key[1] + _W1
    _philox4_round(counter, key)
    return counter


def _box_muller(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Word pair (u32, u32) → first Box-Muller normal, float64 math, f32 out."""
    u = x.astype(np.float64) * _INV32 + _INV32 / 2
    v = y.astype(np.float64) * _INV32_2PI + _INV32_2PI / 2
    s = np.sqrt(-2.0 * np.log(u))
    return (s * np.sin(v)).astype(np.float32)


class Generator:
    """Stateful generator: repeated randn() calls advance the Philox offset,
    mirroring consecutive torch.randn calls on one CUDA generator."""

    def __init__(self, seed: int):
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.offset = 0

    def randn(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        counter = np.zeros((4, n), dtype=np.uint32)
        counter[0][:] = np.uint32(self.offset & 0xFFFFFFFF)
        counter[1][:] = np.uint32(self.offset >> 32)
        counter[2][:] = np.arange(n, dtype=np.uint32)
        key = np.empty((2, n), dtype=np.uint32)
        key[0][:] = np.uint32(self.seed & 0xFFFFFFFF)
        key[1][:] = np.uint32(self.seed >> 32)
        self.offset += 1

        g = philox4x32_10(counter, key)
        out = _box_muller(g[0], g[1])  # first normal of the pair, per element
        return out.reshape(shape)

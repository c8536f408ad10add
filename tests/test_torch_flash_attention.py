"""The port's flash attention against forge_tpu's Pallas kernel (interpret mode).

Same numpy inputs through `forge_tpu.ops.flash_attention._flash_attention_own
(interpret=True)` and through `forge_tpu_torch.ops.flash_attention` on CPU
tensors, which runs its plain version. Tolerance 2e-5 absolute: both are f32
softmax attention and differ only in summation order and blocking (outputs
are O(1) averages of unit-normal values).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.ops.attention import attention as jax_attention  # noqa: E402
from forge_tpu.ops.flash_attention import _flash_attention_own  # noqa: E402
from forge_tpu_torch.ops import attention as tattn  # noqa: E402
from forge_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402

ATOL = 2e-5


def _qkv(b, h, lq, lk, d, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, lq, d)).astype(np.float32)
    k = r.standard_normal((b, h, lk, d)).astype(np.float32)
    v = r.standard_normal((b, h, lk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (1, 2, 128, 128, 40),    # SD1.5 level-0 head dim
    (2, 1, 130, 140, 80),    # level-1 head dim, ragged, B > 1
    (1, 1, 96, 64, 160),     # level-2 head dim
    (1, 1, 128, 96, 512),    # VAE single head
    (1, 2, 300, 200, 40),    # ragged Lq/Lk across block boundaries
])
def test_plain_matches_pallas_kernel(b, h, lq, lk, d):
    q, k, v = _qkv(b, h, lq, lk, d, seed=d)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(_flash_attention_own(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           scale=scale, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (1, 2, 128, 128, 40),    # SD1.5 level-0 head dim
    (1, 2, 130, 100, 128),   # Flux head dim, ragged
    (1, 1, 128, 96, 512),    # VAE single head
])
def test_plain_matches_pallas_kernel_in_bf16(b, h, lq, lk, d):
    """In bf16 both round the probabilities to bf16 before p·v (the
    tensor-core body does too). Bound: 2e-2 of max |want|, a few bf16 ulps
    (the two round the f32 logits and the output at other points)."""
    q, k, v = _qkv(b, h, lq, lk, d, seed=d + 1)
    want = np.asarray(_flash_attention_own(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                           interpret=True).astype(jnp.float32))
    got = flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v))).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("lq,lk,masked,expect_flash", [
    (512, 512, False, True),
    (512, 77, False, False),   # cross-attention: Lk below the cut
    (256, 256, False, False),  # UNet level 2 at 512²
    (512, 512, True, False),   # masked calls never take the kernel
])
def test_front_end_dispatch(monkeypatch, lq, lk, masked, expect_flash):
    """Lq ≥ 512 and Lk ≥ 512 unmasked → flash, as forge_tpu's attention.py:62;
    the result matches forge_tpu's front end either way."""
    calls = []

    def recording(q, k, v, scale=None):
        calls.append(q.shape)
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(tattn, "flash_attention", recording)
    r = np.random.default_rng(lq + lk)
    heads, d = 2, 16
    q = r.standard_normal((1, lq, heads * d)).astype(np.float32)
    k = r.standard_normal((1, lk, heads * d)).astype(np.float32)
    v = r.standard_normal((1, lk, heads * d)).astype(np.float32)
    mask = np.tril(np.ones((lq, lk), bool))[None, None] if masked else None
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                    mask=None if mask is None else jnp.asarray(mask),
                                    impl="xla"))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
                          mask=None if mask is None else torch.from_numpy(mask))
    assert bool(calls) == expect_flash
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_wrapper_refuses_non_cuda_device():
    q = torch.empty((1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


def test_plain_versions_bypass_the_kernel(monkeypatch):
    """Inside ops.plain_versions() the front end never calls the kernel
    wrapper (the whole-model kernels-vs-plain check relies on it)."""
    from forge_tpu_torch.ops import plain_versions

    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda *a: calls.append(a))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 512, 32)).astype(np.float32))
    with plain_versions():
        out = tattn.attention(x, x, x, heads=2)
    assert not calls and out.shape == x.shape

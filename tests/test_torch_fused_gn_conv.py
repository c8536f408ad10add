"""The port's fused GroupNorm+SiLU+conv3x3 against forge_tpu's (CPU, f32).

Same numpy inputs through `forge_tpu.ops.fused_gn_conv.gn_silu_conv3x3`
(the Pallas kernel in interpret mode where it is supported, the XLA plain
path elsewhere) and through the port's front end on CPU tensors, which runs
the kernel wrapper's plain version. Activations NHWC ↔ NCHW, kernels
HWIO ↔ OIHW. Tolerance 5e-4 absolute, the bound tests/test_fused_gn_conv.py
holds the Pallas kernel to: the 9·C-term f32 dot products differ in order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.ops import fused_gn_conv as jgc  # noqa: E402
from forge_tpu_torch.ops import fused_gn_conv as tgc  # noqa: E402

ATOL = 5e-4


def _params(c, o, seed=0, beta_scale=0.2):
    r = np.random.default_rng(seed)
    gamma = (r.standard_normal(c) + 1.0).astype(np.float32)
    beta = (r.standard_normal(c) * beta_scale).astype(np.float32)
    w = (r.standard_normal((o, c, 3, 3)) * 0.05).astype(np.float32)  # OIHW
    bias = (r.standard_normal(o) * 0.1).astype(np.float32)
    return gamma, beta, w, bias


def _both(x_nhwc, gamma, beta, w, bias, groups=32, eps=1e-5, interpret=None):
    jgn = {"weight": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    jconv = {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(bias)}
    want = np.asarray(jgc.gn_silu_conv3x3(jnp.asarray(x_nhwc), jgn, jconv, num_groups=groups,
                                          eps=eps, interpret=interpret))
    tgn = {"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)}
    tconv = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias)}
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    got = tgc.group_norm_silu_conv3x3(x, tgn, tconv, num_groups=groups, eps=eps)
    return want, got.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (1, 8, 8, 256), (1, 24, 8, 128)])
def test_matches_pallas_kernel(shape):
    """The shapes tests/test_fused_gn_conv.py runs the Pallas body at."""
    x = (np.random.default_rng(5).standard_normal(shape) * 2.0).astype(np.float32)
    want, got = _both(x, *_params(shape[-1], 128, seed=shape[-1]), interpret=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_matches_pallas_kernel_in_bf16():
    """In bf16 both round the activation to bf16 before the product (the
    tensor-core body does too) and accumulate in f32. Bound: 2e-2 of
    max |want|, a few bf16 ulps: the two round the output, and the group
    statistics' f32 sums, at other points."""
    shape = (1, 8, 8, 128)
    x = (np.random.default_rng(7).standard_normal(shape) * 2.0).astype(np.float32)
    gamma, beta, w, bias = _params(128, 128, seed=7)
    x16 = jnp.asarray(x, jnp.bfloat16)
    jgn = {"weight": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    jconv = {"weight": jnp.asarray(w.transpose(2, 3, 1, 0), jnp.bfloat16),
             "bias": jnp.asarray(bias)}
    want = np.asarray(jgc.gn_silu_conv3x3(x16, jgn, jconv, interpret=True).astype(jnp.float32))
    tgn = {"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)}
    tconv = {"weight": torch.from_numpy(w).bfloat16(), "bias": torch.from_numpy(bias)}
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).bfloat16()
    got = tgc.group_norm_silu_conv3x3(xt, tgn, tconv).float().numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("c,o,eps", [(64, 64, 1e-5), (96, 32, 1e-5), (320, 320, 1e-5),
                                     (128, 64, 1e-6)])
def test_matches_plain_path(c, o, eps):
    """C = 320 and other widths the TPU kernel refuses: forge_tpu's XLA path."""
    x = (np.random.default_rng(c).standard_normal((2, 6, 5, c)) * 1.5 + 0.3).astype(np.float32)
    want, got = _both(x, *_params(c, o, seed=c + o), eps=eps)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pad_is_zero_not_silu_of_shift():
    """Constant x makes every group's normalized value 0, so inside the image
    the activation is silu(β) = silu(4) ≈ 3.93; the pad must stay exactly 0.
    A version that pads before the activation gets every border pixel wrong."""
    c, o = 64, 32
    x = np.ones((1, 6, 6, c), np.float32)
    gamma = np.ones(c, np.float32)
    beta = np.full(c, 4.0, np.float32)
    w = np.ones((o, c, 3, 3), np.float32) * 0.01
    bias = np.zeros(o, np.float32)
    want, got = _both(x, gamma, beta, w, bias)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    inner = c * 0.01 * 4.0 / (1.0 + np.exp(-4.0))
    assert np.allclose(got[0, 0, 0], 4 * inner, rtol=1e-5)  # corner: 4 taps
    assert np.allclose(got[0, 3, 3], 9 * inner, rtol=1e-5)  # interior: 9 taps


def test_affine_matches_group_norm():
    """(a, s) from gn_affine reproduce group_norm's normalize+scale+shift."""
    r = np.random.default_rng(11)
    x = torch.from_numpy((r.standard_normal((2, 64, 5, 7)) * 3).astype(np.float32))
    gn_p = {"weight": torch.from_numpy(r.standard_normal(64).astype(np.float32)),
            "bias": torch.from_numpy(r.standard_normal(64).astype(np.float32))}
    a, s = tgc.gn_affine(x, gn_p, 32, 1e-5)
    want = tgc.group_norm(x, gn_p, num_groups=32, eps=1e-5)
    torch.testing.assert_close(x * a[:, :, None, None] + s[:, :, None, None], want,
                               atol=1e-5, rtol=1e-5)


def test_wrapper_refuses_non_cuda_device():
    x = torch.empty((1, 32, 4, 4), device="meta")
    a = torch.empty((1, 32), device="meta")
    w = torch.empty((32, 32, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgc.gn_silu_conv3x3(x, a, a, w, None)


def test_plain_versions_bypass_the_kernel(monkeypatch):
    """Inside ops.plain_versions() the ResBlock front end runs the unfused
    plain ops, with the same result on the CPU."""
    from forge_tpu_torch.ops import plain_versions

    gamma, beta, w, bias = _params(64, 32, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 64, 5, 6)).astype(np.float32))
    tgn = {"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)}
    tconv = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias)}
    fused = tgc.group_norm_silu_conv3x3(x, tgn, tconv)
    calls = []
    monkeypatch.setattr(tgc, "gn_silu_conv3x3", lambda *a: calls.append(a))
    with plain_versions():
        plain = tgc.group_norm_silu_conv3x3(x, tgn, tconv)
    assert not calls
    torch.testing.assert_close(plain, fused, atol=1e-5, rtol=1e-5)

"""forge_tpu_torch.ops.nn against forge_tpu.ops.nn on the same numpy inputs (CPU, f32).

Activations cross the boundary NHWC (JAX) ↔ NCHW (torch); conv kernels
OIHW (torch) ↔ HWIO (JAX). Tolerance: 1e-5 absolute on O(1) values — both
sides compute in f32, so only summation order differs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.ops import nn as jnn  # noqa: E402
from forge_tpu_torch.ops import nn as tnn  # noqa: E402

ATOL = 1e-5


def _r(seed=0):
    return np.random.default_rng(seed)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(jax_out, torch_out, nhwc=False, atol=ATOL):
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    if nhwc:
        got = got.transpose(0, 2, 3, 1)
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


def test_linear():
    r = _r(1)
    x = r.standard_normal((2, 7, 24)).astype(np.float32)
    w = r.standard_normal((16, 24)).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    _close(jnn.linear(jnp.asarray(x), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}),
           tnn.linear(torch.from_numpy(x), {"weight": torch.from_numpy(w),
                                            "bias": torch.from_numpy(b)}))


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv2d(k, stride, padding):
    r = _r(2)
    x = r.standard_normal((2, 9, 10, 6)).astype(np.float32)  # NHWC
    w = (r.standard_normal((5, 6, k, k)) * 0.2).astype(np.float32)  # OIHW
    b = r.standard_normal(5).astype(np.float32)
    want = jnn.conv2d(jnp.asarray(x), {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)),
                                       "bias": jnp.asarray(b)}, stride=stride, padding=padding)
    got = tnn.conv2d(_nchw(x), {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
                     stride=stride, padding=padding)
    _close(want, got, nhwc=True)


@pytest.mark.parametrize("act,affine,eps", [(None, True, 1e-5), ("silu", True, 1e-6),
                                            (None, False, 1e-5)])
def test_group_norm(act, affine, eps):
    r = _r(3)
    x = (r.standard_normal((2, 5, 6, 64)) * 3 + 1).astype(np.float32)
    g = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    jp = {"weight": jnp.asarray(g), "bias": jnp.asarray(b)} if affine else None
    tp = {"weight": torch.from_numpy(g), "bias": torch.from_numpy(b)} if affine else None
    _close(jnn.group_norm(jnp.asarray(x), jp, eps=eps, act=act),
           tnn.group_norm(_nchw(x), tp, eps=eps, act=act), nhwc=True)


def test_layer_norm():
    r = _r(4)
    x = (r.standard_normal((3, 5, 32)) * 2 - 1).astype(np.float32)
    g = r.standard_normal(32).astype(np.float32)
    b = r.standard_normal(32).astype(np.float32)
    _close(jnn.layer_norm(jnp.asarray(x), {"weight": jnp.asarray(g), "bias": jnp.asarray(b)}),
           tnn.layer_norm(torch.from_numpy(x), {"weight": torch.from_numpy(g),
                                                "bias": torch.from_numpy(b)}))


@pytest.mark.parametrize("name", ["silu", "gelu", "quick_gelu"])
def test_activations_f32(name):
    x = (_r(5).standard_normal((4, 33)) * 4).astype(np.float32)
    _close(getattr(jnn, name)(jnp.asarray(x)), getattr(tnn, name)(torch.from_numpy(x)))


def test_gelu_bf16_is_tanh_approximation():
    """bf16 gelu takes the tanh form on both sides: compare in bf16 units."""
    x = (_r(6).standard_normal(256) * 4).astype(np.float32)
    want = np.asarray(jnn.gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tnn.gelu(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)  # a bf16 ulp at |x| ≤ 16


def test_geglu():
    r = _r(7)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    w = (r.standard_normal((64, 16)) * 0.3).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    _close(jnn.geglu(jnp.asarray(x), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}),
           tnn.geglu(torch.from_numpy(x), {"weight": torch.from_numpy(w),
                                           "bias": torch.from_numpy(b)}))


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.5, 999.0], np.float32)
    # |t·freq| reaches 1e3: the sin/cos argument carries ~1e-4 f32 rounding
    _close(jnn.timestep_embedding(jnp.asarray(t), dim),
           tnn.timestep_embedding(torch.from_numpy(t), dim), atol=2e-4)


def test_upsample_nearest_2x():
    x = _r(8).standard_normal((2, 3, 4, 5)).astype(np.float32)
    _close(jnn.upsample_nearest_2x(jnp.asarray(x)), tnn.upsample_nearest_2x(_nchw(x)),
           nhwc=True, atol=0)

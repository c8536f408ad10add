"""The port's `ops/resize.py` against `jax.image.resize`, the resizer of the
reference's latent hires modes (forge_tpu/pipeline/processing.py
`_latent_upscale`).

Every method the hires fix names (bilinear, bicubic, nearest) with and
without antialias, up and down, at integer and non-integer scales, on NCHW
latents: within 1e-6 of the largest value (f32 on both sides; only the
order of the two axis contractions differs), nearest exactly. The last test
shows a divergence on the reference's side, from both sides: its modes are
not upstream Forge's `F.interpolate` modes (bicubic's a is −0.5 against
torch's −0.75, and "nearest" is torch's "nearest-exact").
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SIZES = [((8, 8), (16, 16)), ((8, 8), (12, 12)), ((7, 7), (5, 5)), ((8, 6), (3, 11)),
         ((16, 16), (8, 8)), ((5, 9), (13, 4))]


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_matches_jax_image_resize(method, antialias, src, dst):
    from forge_tpu_torch.ops.resize import resize

    x = np.random.default_rng(3).standard_normal((2, 4) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 4) + dst, method,
                                       antialias=antialias))
    got = resize(torch.from_numpy(x), dst, method, antialias=antialias)
    assert got.shape == (2, 4) + dst and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    if method == "nearest":
        assert err == 0.0
    assert err <= 1e-6 * max(np.abs(want).max(), 1.0), err
    assert np.array_equal(resize(x, dst, method, antialias), got.numpy())  # numpy in, numpy out


@pytest.mark.parametrize("mode,method,antialias", [
    ("Latent", "bilinear", False), ("Latent (antialiased)", "bilinear", True),
    ("Latent (bicubic)", "bicubic", False), ("Latent (bicubic antialiased)", "bicubic", True),
    ("Latent (nearest)", "nearest", False), ("Latent (nearest-exact)", "nearest", False)])
def test_latent_upscale_modes_match_forge_tpu(mode, method, antialias):
    """`_latent_upscale`'s mode names → method and antialias, NCHW against the
    reference's NHWC, by scale and by explicit target."""
    from forge_tpu.pipeline.processing import _latent_upscale as jup
    from forge_tpu_torch.pipeline.processing import _latent_upscale

    x = np.random.default_rng(4).standard_normal((1, 4, 8, 10)).astype(np.float32)
    for scale, target in ((1.5, None), (2.0, None), (2.0, (11, 7))):
        want = np.asarray(jup(jnp.asarray(x.transpose(0, 2, 3, 1)), scale, target, mode))
        got = _latent_upscale(torch.from_numpy(x), scale, target, mode).numpy()
        assert got.shape == want.transpose(0, 3, 1, 2).shape
        assert np.abs(got - want.transpose(0, 3, 1, 2)).max() <= 1e-6 * np.abs(want).max()


def test_reference_latent_modes_are_not_upstream_interpolate():
    """Fault on the reference's side, shown from both sides: forge_tpu's
    `_latent_upscale` (jax.image.resize) against upstream Forge's
    `F.interpolate` modes, and the port equal to forge_tpu, not to
    upstream. Bicubic differs (a = −0.5 against −0.75); "nearest" at 1.5×
    differs (it is nearest-exact); at 2× nearest is equal and bilinear equal
    to rounding."""
    import torch.nn.functional as F

    from forge_tpu.pipeline.processing import _latent_upscale as jup
    from forge_tpu_torch.pipeline.processing import _latent_upscale

    x = np.random.default_rng(5).standard_normal((1, 4, 16, 16)).astype(np.float32)
    t = torch.from_numpy(x)

    def ref(mode, scale):
        return np.asarray(jup(jnp.asarray(x.transpose(0, 2, 3, 1)), scale, None, mode)
                          ).transpose(0, 3, 1, 2)

    upstream_bicubic = F.interpolate(t, scale_factor=2.0, mode="bicubic",
                                     align_corners=False).numpy()
    assert np.abs(ref("Latent (bicubic)", 2.0) - upstream_bicubic).max() > 0.05
    size = (24, 24)
    upstream_nearest = F.interpolate(t, size=size, mode="nearest").numpy()
    exact = F.interpolate(t, size=size, mode="nearest-exact").numpy()
    assert np.abs(ref("Latent (nearest)", 1.5) - upstream_nearest).max() > 0.5
    assert np.array_equal(ref("Latent (nearest)", 1.5), exact)
    assert np.array_equal(ref("Latent (nearest)", 2.0),
                          F.interpolate(t, scale_factor=2.0, mode="nearest").numpy())
    bilinear = F.interpolate(t, scale_factor=2.0, mode="bilinear", align_corners=False).numpy()
    assert np.abs(ref("Latent", 2.0) - bilinear).max() <= 1e-6
    # the port holds to forge_tpu, not to upstream
    got = _latent_upscale(t, 2.0, None, "Latent (bicubic)").numpy()
    assert np.abs(got - ref("Latent (bicubic)", 2.0)).max() <= 1e-6 * np.abs(got).max()
    assert np.abs(got - upstream_bicubic).max() > 0.05
    assert np.array_equal(_latent_upscale(t, 1.5, None, "Latent (nearest)").numpy(), exact)

"""forge_tpu_torch/ops/threefry.py against `jax.random` (threefry2x32,
`jax_threefry_partitionable` on): keys and fold_in, the bits and `uniform`
bit-equal, `normal` within a relative 1e-6 of the largest value (numpy's
float32 log1p against XLA's), over several seeds, folds and shapes; and
the latent modifier's extra noise (gaussian and uniform, add and speckle)
in its `cfg_combine_fn` against forge_tpu's on the same x0 pairs."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_cfg_hooks import _combine_both, _eps_pair  # noqa: E402
from test_torch_sdxl import _assert_close  # noqa: E402

SEEDS = [0, 1, 5, 123456789, 4294967295, 4294967301]
FOLDS = [0, 1, 9, 2147483647, 4294967295]
SHAPES = [(1,), (5,), (3, 7), (2, 16, 12, 4), (1, 128, 128, 4)]
NORMAL_REL = 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match(seed):
    from forge_tpu_torch.ops import threefry

    key = threefry.prng_key(seed)
    assert key == tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    for data in FOLDS:
        want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        assert threefry.fold_in(key, data) == tuple(int(v) for v in np.asarray(want))
    with pytest.raises(OverflowError):
        threefry.fold_in(key, -1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_uniform_normal_match(seed, shape):
    from forge_tpu_torch.ops import threefry

    for data in FOLDS[:3]:
        key = threefry.fold_in(threefry.prng_key(seed), data)
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        bits = threefry.random_bits(key, shape)
        assert bits.dtype == np.uint32 and bits.shape == shape
        assert np.array_equal(bits, np.asarray(jax.random.bits(jkey, shape)))
        u = threefry.uniform(key, shape)
        assert u.dtype == np.float32
        assert np.array_equal(u, np.asarray(jax.random.uniform(jkey, shape, jnp.float32)))
        n = threefry.normal(key, shape)
        want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
        assert n.dtype == np.float32
        assert np.abs(n - want).max() <= NORMAL_REL * np.abs(want).max()


def test_uniform_range_and_erf_inv_edges():
    from forge_tpu_torch.ops import threefry

    key = threefry.prng_key(3)
    jkey = jax.random.PRNGKey(3)
    got = threefry.uniform(key, (1000,), -2.0, 3.0)
    assert np.array_equal(got, np.asarray(jax.random.uniform(jkey, (1000,), jnp.float32,
                                                             -2.0, 3.0)))
    x = np.asarray([-1.0, -0.999, -0.5, 0.0, 0.25, 0.9999, 1.0], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = threefry.erf_inv(x)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    assert np.abs(got[finite] - want[finite]).max() <= NORMAL_REL * np.abs(want[finite]).max()


def test_draw_layout_is_not_transposable():
    """The reference draws NHWC: the same key drawn in NCHW is another array."""
    from forge_tpu_torch.ops import threefry

    key = threefry.prng_key(7)
    nhwc = threefry.normal(key, (1, 6, 5, 4)).transpose(0, 3, 1, 2)
    nchw = threefry.normal(key, (1, 4, 6, 5))
    assert not np.allclose(nhwc, nchw)


EXTRA_NOISE_CASES = {
    "gaussian add": dict(extra_noise_type="gaussian", extra_noise_method="add"),
    "gaussian speckle": dict(extra_noise_type="gaussian", extra_noise_method="speckle"),
    "uniform add": dict(extra_noise_type="uniform", extra_noise_method="add"),
    "uniform speckle, seed 42": dict(extra_noise_type="uniform", extra_noise_method="speckle",
                                     seed=42),
    "gaussian add with a tonemap": dict(extra_noise_type="gaussian", tonemap_multiplier=1.2,
                                        seed=9),
}


@pytest.mark.parametrize("t_from", ["predictor", "sigma table", "neither"])
@pytest.mark.parametrize("case", list(EXTRA_NOISE_CASES))
def test_extra_noise_combine_matches(case, t_from):
    """Each call's noise comes from the step its σ falls in (the σ table), or
    step 0 without one; the predictor sets only the weight 1 − t."""
    from forge_tpu.extensions.latent_modifier import LatentModifierSpec as JSpec
    from forge_tpu.sampling.prediction import DiscretePrediction as JPred
    from forge_tpu_torch.extensions.latent_modifier import LatentModifierSpec
    from forge_tpu_torch.sampling.prediction import DiscretePrediction
    from forge_tpu_torch.sampling.schedules import get_sigmas

    kw = dict(EXTRA_NOISE_CASES[case], extra_noise_multiplier=400.0)
    sigmas = np.asarray(get_sigmas("karras", 6, DiscretePrediction()), np.float32)
    table = None if t_from == "neither" else sigmas
    jpred, tpred = (JPred(), DiscretePrediction()) if t_from == "predictor" else (None, None)
    jfn = JSpec(**kw).build(table, predictor=jpred)
    tfn = LatentModifierSpec(**kw).build(table, predictor=tpred)
    cond, uncond = _eps_pair(11)
    plain = LatentModifierSpec(**dict(kw, extra_noise_multiplier=0.0)).build(table,
                                                                             predictor=tpred)
    outs = []
    for sigma in (float(sigmas[0]), float(sigmas[2]), float(sigmas[4]), 0.4):
        got, want = _combine_both(jfn, tfn, cond, uncond, sigma, 7.0)
        _assert_close(got, want)
        outs.append(got)
        no_noise = plain(torch.from_numpy(cond), torch.from_numpy(uncond), None, sigma,
                         7.0).numpy()
        if t_from != "neither" and sigma == float(sigmas[0]):
            continue  # 1 − t is 0 at the schedule's first σ: the noise weighs nothing
        assert not np.allclose(got, no_noise)
    # another step, another draw (the σ table) or the same one (no table)
    assert np.array_equal(outs[1], outs[2]) == (t_from == "neither")


@pytest.fixture(scope="module")
def engines():
    from torch_controls_cases import sd15_engines, sdxl_engines

    return {"sdxl": sdxl_engines(), "sd15": sd15_engines()}


@pytest.mark.parametrize("model, args", [
    ("sdxl", dict(extra_noise_type="gaussian", extra_noise_method="add",
                  extra_noise_multiplier=300.0, seed=5)),
    ("sd15", dict(extra_noise_type="uniform", extra_noise_method="speckle",
                  extra_noise_multiplier=500.0, tonemap_multiplier=1.1, seed=6)),
], ids=["sdxl, gaussian add", "sd15, uniform speckle with a tonemap"])
def test_extra_noise_slice_matches_forge_tpu(engines, model, args):
    """The latent modifier with extra noise through both `process_images`
    (DPM++ 2M Karras on the tiny SDXL, Euler a on the tiny SD1.5), PSNR ≥ 80 dB."""
    import importlib

    from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice, processing,
                                      run_both)

    request = dict(SDXL_REQUEST if model == "sdxl" else SD15_REQUEST, steps=4)

    def attach(package, p):
        importlib.import_module(f"{package}.extensions.latent_modifier").attach(p, args)

    got, want, _ = run_both(engines[model], request, attach)
    print(model, assert_slice(got, want))
    tproc = processing("forge_tpu_torch")
    quiet = tproc.Processing(**request)
    importlib.import_module("forge_tpu_torch.extensions.latent_modifier").attach(
        quiet, dict(args, extra_noise_multiplier=0.0))
    assert not np.array_equal(got.images[0],
                              tproc.process_images(engines[model][1], quiet).images[0])

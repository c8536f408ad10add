"""The port's schedules and Euler samplers against forge_tpu's (CPU, f32).

σ-schedules are host numpy in both packages and must be identical. The
samplers run a toy denoiser on the same numpy latent and step noise;
forge_tpu's runs as a lax.scan, the port's as a Python loop, both in f32, so
they agree to 1e-5 of the latent's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.sampling import prediction as jpred  # noqa: E402
from forge_tpu.sampling import samplers as jsamp  # noqa: E402
from forge_tpu.sampling.schedules import get_sigmas as jget_sigmas  # noqa: E402
from forge_tpu_torch.sampling import prediction as tpred  # noqa: E402
from forge_tpu_torch.sampling import samplers as tsamp  # noqa: E402
from forge_tpu_torch.sampling.schedules import get_sigmas  # noqa: E402


@pytest.mark.parametrize("name,steps", [("normal", 20), ("normal", 3), ("karras", 20)])
def test_sigmas_identical(name, steps):
    want = jget_sigmas(name, steps, jpred.DiscretePrediction())
    got = get_sigmas(name, steps, tpred.DiscretePrediction())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_timestep_matches():
    sig = np.array([14.6146, 3.2, 0.5, 0.0292], np.float32)
    np.testing.assert_allclose(tpred.DiscretePrediction().timestep(sig),
                               np.asarray(jpred.DiscretePrediction().timestep(jnp.asarray(sig))),
                               rtol=1e-5, atol=1e-3)


def _toy(x, sigma):
    return x * (1.0 / (1.0 + sigma * sigma)) + 0.1


@pytest.mark.parametrize("sampler", ["Euler a", "Euler"])
def test_sampler_matches(sampler):
    r = np.random.default_rng(7)
    sigmas = jget_sigmas("normal", 8, jpred.DiscretePrediction())
    x0 = (r.standard_normal((2, 4, 8, 8)) * sigmas[0]).astype(np.float32)
    noise = r.standard_normal((8, 1, 2, 4, 8, 8)).astype(np.float32)
    jinfo, tinfo = jsamp.get_sampler(sampler), tsamp.get_sampler(sampler)
    if jinfo.noise_draws:
        want = jinfo.fn(_toy, jnp.asarray(x0), sigmas, jnp.asarray(noise))
        got = tinfo.fn(_toy, torch.from_numpy(x0), sigmas, torch.from_numpy(noise))
    else:
        want = jinfo.fn(_toy, jnp.asarray(x0), sigmas)
        got = tinfo.fn(_toy, torch.from_numpy(x0), sigmas)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_ancestral_step_matches():
    for f, t in [(14.6, 10.0), (1.0, 0.5), (0.03, 0.0)]:
        want = [float(v) for v in jsamp.ancestral_step(jnp.float32(f), jnp.float32(t))]
        np.testing.assert_allclose(tsamp.ancestral_step(f, t), want, rtol=1e-6)


def test_unported_sampler_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        tsamp.get_sampler("DPM++ SDE")

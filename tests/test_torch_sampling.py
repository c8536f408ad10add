"""The port's schedules, samplers and sampler noise against forge_tpu's (CPU, f32).

σ-schedules are host numpy in both packages and must be identical (the beta
schedule under each package's options too). Every one of the 25 samplers
runs a toy denoiser (a pair-returning one for CFG++) on the same numpy
latent and step noise, at 8 "normal" and 9 "karras" steps, Restart also at
20 and 36 (its restart branch) and DPM fast at 10, and with non-default
eta, s_noise, s_churn and eta_ddim where it takes them; forge_tpu's runs as
a lax.scan, the port's as a Python loop, both in f32, so they agree to 1e-5
of the latent's scale (DPM adaptive, whose data-dependent controller can
flip a decision on a rounding, to 1e-4). The nine samplers with
k-diffusion oracles (tests/fixtures_samplers.npz) match them within 5e-3.
The Brownian-tree noise is bit-identical to forge_tpu's, and the port's
per-request sampler noise is the reference's NHWC noise in NCHW.
"""

import inspect
import os

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
    """Every sampler is ported: an unknown name raises KeyError in both packages."""
    for get in (jsamp.get_sampler, tsamp.get_sampler):
        with pytest.raises(KeyError, match="unknown sampler"):
            get("DPM++ 4M SDE")


def test_registry_matches():
    """Every name of forge_tpu's SAMPLERS resolves in the port, with equal
    aliases and flags (every SamplerInfo field but fn)."""
    import dataclasses

    assert list(tsamp.SAMPLERS) == list(jsamp.SAMPLERS) and len(tsamp.SAMPLERS) == 25
    fields = [f.name for f in dataclasses.fields(jsamp.SamplerInfo) if f.name != "fn"]
    assert fields == [f.name for f in dataclasses.fields(tsamp.SamplerInfo) if f.name != "fn"]
    for name, jinfo in jsamp.SAMPLERS.items():
        tinfo = tsamp.get_sampler(name)
        assert [getattr(tinfo, f) for f in fields] == [getattr(jinfo, f) for f in fields], name
        for alias in jinfo.aliases + (name.lower(),):
            assert tsamp.get_sampler(alias) is tinfo
        assert (set(inspect.signature(tinfo.fn).parameters)
                == set(inspect.signature(jinfo.fn).parameters)), name


def _toy_pair(x, sigma):
    """(x0, uncond x0): the CFG++ samplers' model_fn."""
    return _toy(x, sigma), x * (0.9 / (1.0 + sigma * sigma)) - 0.05


def _run_both(name, sigmas, seed=7, **kwargs):
    """The same numpy latent and step noise through both packages' sampler →
    (forge_tpu's result in NCHW, the port's). Noise goes in when the sampler
    draws it, or when an eta or s_churn it takes makes it stochastic."""
    jinfo, tinfo = jsamp.get_sampler(name), tsamp.get_sampler(name)
    r = np.random.default_rng(seed)
    n = len(sigmas) - 1
    x0 = (r.standard_normal((2, 4, 8, 8)) * sigmas[0]).astype(np.float32)
    draws = jinfo.noise_draws or (1 if kwargs.get("s_churn", 0) > 0
                                  or (jinfo.uses_eta_ddim and kwargs.get("eta", 0) > 0) else 0)
    noise = r.standard_normal((n, max(draws, 1), 2, 4, 8, 8)).astype(np.float32)
    fn = _toy_pair if jinfo.needs_uncond else _toy
    jargs = (jnp.asarray(noise.transpose(0, 1, 2, 4, 5, 3)),) if draws else ()
    want = jinfo.fn(fn, jnp.asarray(x0.transpose(0, 2, 3, 1)), sigmas, *jargs, **kwargs)
    got = tinfo.fn(fn, torch.from_numpy(x0), sigmas,
                   torch.from_numpy(noise) if draws else None, **kwargs)
    return np.asarray(want).transpose(0, 3, 1, 2), got.numpy()


SAMPLER_CASES = ([(name, "normal", 8) for name in jsamp.SAMPLERS]
                 + [(name, "karras", 9) for name in jsamp.SAMPLERS]
                 + [("Restart", "karras", 20), ("Restart", "karras", 36), ("DPM fast", "karras", 10)])


@pytest.mark.parametrize("name,schedule,steps", SAMPLER_CASES)
def test_every_sampler_matches(name, schedule, steps):
    sigmas = jget_sigmas(schedule, steps, jpred.DiscretePrediction(),
                         discard_next_to_last=jsamp.get_sampler(name).discard_next_to_last_sigma)
    want, got = _run_both(name, sigmas)
    assert np.isfinite(got).all()
    tol = 1e-4 if name == "DPM adaptive" else 1e-5
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


def _option_cases():
    """Each sampler that takes eta, s_noise or s_churn, with a non-default
    value of each that acts on it (eta is eta_ddim's value for the DDIM
    family; s_noise scales drawn noise, which Heun, DPM2, Heun++2, DPM fast
    and LCM take but do not draw or scale)."""
    cases = []
    for name, info in jsamp.SAMPLERS.items():
        params = inspect.signature(info.fn).parameters
        acts = {"eta": True, "s_churn": True, "s_noise": info.noise_draws > 0 and name != "LCM"}
        kw = {k: v for k, v in (("eta", 0.5 if info.uses_eta_ddim else 0.7), ("s_noise", 0.8),
                                ("s_churn", 0.5)) if k in params and acts[k]}
        if kw:
            cases.append((name, kw))
    return cases


@pytest.mark.parametrize("name,kwargs", _option_cases(), ids=lambda v: v if isinstance(v, str) else
                         ",".join(f"{k}={x}" for k, x in v.items()))
def test_sampler_options_match(name, kwargs):
    steps = 20 if name == "Restart" else 9  # Restart injects noise from 20 steps on
    sigmas = jget_sigmas("karras", steps, jpred.DiscretePrediction(),
                         discard_next_to_last=jsamp.get_sampler(name).discard_next_to_last_sigma)
    want, got = _run_both(name, sigmas, seed=11, **kwargs)
    default, _ = _run_both(name, sigmas, seed=11)
    assert not np.allclose(want, default)  # the option changes the result
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), np.abs(got - want).max()


ORACLES = {"euler": "Euler", "heun": "Heun", "dpmpp_2m": "DPM++ 2M", "lms": "LMS",
           "ipndm": "ipndm", "ipndm_v": "ipndm_v", "deis": "DEIS", "dpm_fast": "DPM fast",
           "heunpp2": "Heun++2"}


@pytest.mark.parametrize("key", list(ORACLES))
def test_sampler_matches_kdiffusion_oracle(key):
    """tests/fixtures_samplers.npz: the k-diffusion samplers' final latents on
    x0 = 0.55·x + 0.8 over 8 Karras steps, as tests/test_sampler_parity.py
    holds forge_tpu to them."""
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures_samplers.npz"))
    out = tsamp.get_sampler(ORACLES[key]).fn(lambda x, sigma: 0.55 * x + 0.8,
                                             torch.from_numpy(fix["x_init"]), fix["sigmas"])
    err = np.abs(out.numpy() - fix[key]).max()
    assert err < 5e-3, (key, err)


def test_brownian_noise_bit_identical():
    from forge_tpu.sampling.brownian import brownian_step_noise as jbrownian
    from forge_tpu_torch.sampling.brownian import brownian_step_noise

    sigmas = jget_sigmas("karras", 9, jpred.DiscretePrediction())
    for draws, seeds in ((1, [3]), (2, [1, 31337])):
        want = jbrownian(sigmas, (6, 5, 4), seeds, draws=draws)
        got = brownian_step_noise(sigmas, (6, 5, 4), seeds, draws=draws)
        assert got.dtype == want.dtype == np.float32 and got.shape == (9, draws, len(seeds), 6, 5, 4)
        assert np.array_equal(got, want)
        assert not got[-1].any()  # the final step draws no noise


@pytest.mark.parametrize("sampler", ["DPM++ SDE", "DPM++ 2M SDE", "DPM2 a", "DDIM"])
def test_prepare_noise_matches(sampler):
    """The port's per-request step noise for the pass over these σ and these
    seeds is forge_tpu's NHWC noise in NCHW: Brownian (drawn (h, w, C) a
    node), Philox, and one draw for DDIM under eta_ddim."""
    from forge_tpu.ops.image_rng import ImageRNG as JImageRNG
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.ops.image_rng import ImageRNG
    from forge_tpu_torch.pipeline import processing as tproc

    sigmas = get_sigmas("karras", 6, tpred.DiscretePrediction())[2:]
    seeds = [5, 6]
    jp = jproc.Processing(sampler_name=sampler, eta_ddim=0.5)
    tp = tproc.Processing(sampler_name=sampler, eta_ddim=0.5)
    want = jproc._prepare_noise(jp, JImageRNG((4, 6, 10), seeds), jsamp.get_sampler(sampler),
                                len(sigmas) - 1, sigmas=sigmas, seeds=seeds)
    got = tproc._prepare_noise(tp, ImageRNG((4, 6, 10), seeds), tsamp.get_sampler(sampler),
                               sigmas, seeds, "cpu")
    assert got.shape == (len(sigmas) - 1, tsamp.get_sampler(sampler).noise_draws or 1, 2, 4, 6, 10)
    assert np.array_equal(got.numpy(), np.asarray(want).transpose(0, 1, 2, 5, 3, 4))


def test_beta_schedule_follows_the_options():
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.runtime.options import opts

    values = {"beta_dist_alpha": 0.4, "beta_dist_beta": 0.9}
    default = get_sigmas("beta", 10, tpred.DiscretePrediction())
    with jopts.override(values), opts.override(values):
        want = jget_sigmas("beta", 10, jpred.DiscretePrediction())
        got = get_sigmas("beta", 10, tpred.DiscretePrediction())
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, default)
    np.testing.assert_array_equal(default, jget_sigmas("beta", 10, jpred.DiscretePrediction()))

"""The port's Playground v2.5 slice against forge_tpu (CPU, f32).

Playground v2.5 is SDXL's geometry trained under the EDM objective (σ_data
0.5, σ from 0.002 to 120) with a per-channel latent format; its single-file
export carries `edm_mean`/`edm_std` keys that tell the loaders so. Here:
`PredictionEDM` and every schedule over its σ range against forge_tpu's,
the family tag the Align-Your-Steps schedules read, the channel latent
format on NCHW tensors, and the tiny SDXL checkpoint of
tests/test_torch_sdxl.py with the marker keys through both packages
(64², DPM++ 2M Karras, 3 steps, CFG 3) to PSNR ≥ 70 dB (measured 79.99
dB). The last test traces the published request (1024², 50 steps) at full
width on the meta device.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_sd3 import meta_engine, trace_calls  # noqa: E402
from test_torch_sdxl import ADM, CTX, _tiny_sdxl_checkpoint  # noqa: E402
from test_torch_serving import _count, _meta  # noqa: E402

REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
               seed=1, steps=3, width=64, height=64, sampler_name="DPM++ 2M",
               scheduler="karras", cfg_scale=3.0)
PLAYGROUND_STEPS = 50  # the model card's request: 1024², DPM++ 2M Karras, 50 steps, CFG 3
SCHEDULE_NAMES = ("normal", "karras", "exponential", "polyexponential", "sgm_uniform",
                  "kl_optimal", "align_your_steps", "align_your_steps_GITS",
                  "align_your_steps_11", "align_your_steps_32", "simple", "ddim", "beta",
                  "turbo")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def engines():
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    sd = _tiny_sdxl_checkpoint()
    sd["edm_mean"] = np.zeros(4, np.float32)  # the single-file EDM markers
    sd["edm_std"] = np.ones(4, np.float32)
    jeng = jload(dict(sd), dtype=jnp.float32)
    jeng.unet_cfg = JCfg(context_dim=CTX, num_heads=4, use_linear_projection=True,
                         adm_in_channels=ADM)
    teng = load_engine(dict(sd), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CTX, num_heads=4)
    return jeng, teng


# -- sampling/prediction.py, sampling/schedules.py --------------------------------------------


def test_prediction_edm_matches_forge_tpu():
    """σ_data 0.5 and the σ range 0.002–120; t = 0.25·log σ and back; the
    input scaled by 1/√(σ² + σ_data²); x0 = c_skip·x + c_out·F."""
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu_torch.sampling.prediction import PredictionEDM

    want, got = jpred.PredictionEDM(sigma_data=0.5), PredictionEDM(sigma_data=0.5)
    assert (got.sigma_data, got.sigma_min, got.sigma_max) == (
        want.sigma_data, want.sigma_min, want.sigma_max) == (0.5, 0.002, 120.0)
    r = np.random.default_rng(4)
    x, out, noise = (r.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(3))
    for sigma in (120.0, 14.6, 1.0, 0.5, 0.03, 0.002):
        s = np.float32(sigma)
        t = got.timestep(s)
        assert np.array_equal(t, want.timestep(s))
        np.testing.assert_allclose(got.sigma(t), want.sigma(t), rtol=1e-6)
        np.testing.assert_allclose(got.sigma(t), s, rtol=1e-5)
        np.testing.assert_allclose(got.calculate_input(float(s), torch.from_numpy(x)).numpy(),
                                   np.asarray(want.calculate_input(s, x)), rtol=1e-6)
        np.testing.assert_allclose(
            got.calculate_denoised(float(s), torch.from_numpy(out), torch.from_numpy(x)).numpy(),
            np.asarray(want.calculate_denoised(s, out, x)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.noise_scaling(float(s), noise, x),
                                   np.asarray(want.noise_scaling(s, noise, x)), rtol=1e-6)
    scale = got.calculate_input(120.0, torch.ones(1)).item()
    assert abs(scale - 1 / np.sqrt(120.0 ** 2 + 0.25)) < 1e-9  # the first step's input scale


@pytest.mark.parametrize("name", SCHEDULE_NAMES)
def test_schedules_read_the_edm_range(name):
    """Every named schedule over the EDM predictor, as forge_tpu computes it:
    the σ-range schedules from 120 down to 0.002; the schedules that read a
    discrete σ table ("simple", "ddim", and "turbo", which reads it and
    never uses it) fail alike on both sides, since EDM has none."""
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu.sampling.schedules import get_sigmas as jget
    from forge_tpu_torch.sampling.prediction import PredictionEDM
    from forge_tpu_torch.sampling.schedules import get_sigmas

    want_pred, got_pred = jpred.PredictionEDM(), PredictionEDM()
    want_pred.family = got_pred.family = "playground"
    try:
        want = jget(name, 12, want_pred)
    except AttributeError:
        with pytest.raises(AttributeError, match="sigmas"):
            get_sigmas(name, 12, got_pred)
        assert name in ("simple", "ddim", "turbo")
        return
    got = get_sigmas(name, 12, got_pred)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if name in ("karras", "exponential", "polyexponential", "normal", "kl_optimal"):
        np.testing.assert_allclose(got[0], 120.0, rtol=1e-5)


@pytest.mark.parametrize("family", ["sd15", "sd20", "sdxl", "sdxl_refiner", "playground", "sd3",
                                    "flux"])
def test_align_your_steps_reads_the_family_tag(family):
    """The engines tag their predictor with the family, and the AYS
    schedules pick SD1.5's or SDXL's anchors by it, as forge_tpu's do."""
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu.sampling.schedules import get_sigmas as jget
    from forge_tpu_torch.sampling.prediction import DiscretePrediction
    from forge_tpu_torch.sampling.schedules import get_sigmas

    want_pred, got_pred = jpred.DiscretePrediction(), DiscretePrediction()
    want_pred.family = got_pred.family = family
    for name in ("align_your_steps", "align_your_steps_GITS", "align_your_steps_32"):
        np.testing.assert_array_equal(get_sigmas(name, 20, got_pred), jget(name, 20, want_pred))


def test_engines_tag_their_predictor(engines):
    """Each engine tags its predictor with its family, so an SDXL engine's
    AYS schedule takes SDXL's anchors (before the tag the port's took
    SD1.5's) and Playground's SD1.5's, as forge_tpu's engines do."""
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu.sampling.schedules import get_sigmas as jget
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.sampling.schedules import get_sigmas

    jeng, teng = engines
    assert teng.predictor.family == jeng.predictor.family == "playground"
    np.testing.assert_array_equal(get_sigmas("align_your_steps", 10, teng.predictor),
                                  jget("align_your_steps", 10, jeng.predictor))
    sdxl = load_engine(_tiny_sdxl_checkpoint(), device="cpu")
    assert sdxl.predictor.family == "sdxl"
    want_pred = jpred.DiscretePrediction()
    want_pred.family = "sdxl"
    got = get_sigmas("align_your_steps", 11, sdxl.predictor)
    np.testing.assert_array_equal(got, jget("align_your_steps", 11, want_pred))
    assert abs(float(got[1]) - 6.315) < 1e-3  # SDXL's second anchor (SD1.5's is 6.475)


# -- core/latent_formats.py -------------------------------------------------------------------


def test_channel_latent_format_matches_forge_tpu():
    """Per-channel mean/std and scale 0.5 on NCHW tensors, against forge_tpu's
    on NHWC arrays; process_out undoes process_in."""
    from forge_tpu.core import latent_formats as jfmt
    from forge_tpu_torch.core import latent_formats

    got_fmt, want_fmt = latent_formats.BY_FAMILY["playground"], jfmt.BY_FAMILY["playground"]
    assert got_fmt == latent_formats.PLAYGROUND and got_fmt.mean == want_fmt.mean
    z = (np.random.default_rng(6).standard_normal((2, 4, 5, 7)) * 4).astype(np.float32)
    zt = torch.from_numpy(z)
    for fn in ("process_in", "process_out"):
        got = getattr(got_fmt, fn)(zt).numpy()
        want = np.asarray(getattr(want_fmt, fn)(z.transpose(0, 2, 3, 1))).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_fmt.process_out(got_fmt.process_in(zt)).numpy(), z,
                               rtol=1e-5, atol=1e-5)
    # channel 1's mean and std, not the width axis's
    one = torch.zeros((1, 4, 1, 1))
    np.testing.assert_allclose(got_fmt.process_out(one).numpy().ravel(), got_fmt.mean, rtol=1e-6)


# -- the whole slice ------------------------------------------------------------------------


def test_playground_engine(engines):
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.sampling.prediction import PredictionEDM

    eng = engines[1]
    assert (eng.family, eng.loaded.prediction) == ("playground", "edm")
    assert isinstance(eng.predictor, PredictionEDM) and eng.predictor.sigma_data == 0.5
    assert set(eng.text_engines) == {"clip_l", "clip_g"}
    assert UNetConfig.for_family("playground") == UNetConfig.for_family("sdxl")
    cond = eng.get_learned_conditioning(["a cat"], 64, 64)
    want = engines[0].get_learned_conditioning(["a cat"], 64, 64)
    assert cond["context"].shape == (1, 77, CTX) and cond["y"].shape == (1, ADM)
    np.testing.assert_allclose(cond["y"].numpy(), np.asarray(want["y"]), rtol=1e-4, atol=1e-4)


def test_params_from_jax_carries_the_playground_trees(engines):
    """forge_tpu's loaded UNet (with its label embedding) and VAE come back
    through `params_from_jax` as the port's loader holds them."""
    from forge_tpu_torch.core.convert import flatten, params_from_jax

    jeng, teng = engines
    for jtree, tree in ((jeng.loaded.unet, teng.loaded.unet), (jeng.loaded.vae, teng.loaded.vae)):
        got, want = params_from_jax(jtree), flatten(tree)
        assert set(got) == set(want)
        for key, value in want.items():
            assert np.array_equal(got[key].numpy(), value.numpy()), key
    assert "label_emb" in teng.loaded.unet


def test_playground_txt2img_matches_forge_tpu(engines):
    """DPM++ 2M over Karras σ from 120, the EDM scalings, the channel format's decode."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
    res = process_images(teng, Processing(**REQUEST))
    got = res.images[0]
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    assert float(want.std()) > 1.0
    assert _psnr(got, want) >= 70.0, _psnr(got, want)
    assert np.array_equal(got, process_images(teng, Processing(**REQUEST)).images[0])


@pytest.mark.parametrize("fields", [dict(init_images=[np.zeros((64, 64, 3), np.uint8)]),
                                    dict(enable_hr=True), dict(unet_hooks={"attn2_patch": []}),
                                    dict(refiner_checkpoint="r", refiner_switch_at=0.8)])
def test_playground_refuses_unported_request_features(engines, fields):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    with pytest.raises(NotImplementedError, match="playground"):
        process_images(engines[1], Processing(**dict(REQUEST, **fields)))


# -- Playground v2.5 at full width, traced on the meta device ----------------------------------


def test_playground_full_width_launch_counts_and_bodies():
    """A 1024² request: 50 DPM++ 2M model calls at CFG batch 2 over Karras σ
    from 120, each SDXL's 70 self-attentions and 34 convs; then the 1024²
    decode (1, 28): 3501 flash, 1728 conv, every call on the tensor-core
    body."""
    from forge_tpu_torch.core.synth import DeviceFill, synth_playground_checkpoint
    from forge_tpu_torch.sampling.schedules import get_sigmas

    engine = meta_engine(synth_playground_checkpoint(fill=DeviceFill("cpu")))
    assert engine.family == "playground"
    sigmas = get_sigmas("karras", PLAYGROUND_STEPS, engine.predictor)
    assert len(sigmas) - 1 == 50 and abs(float(sigmas[0]) - 120.0) < 1e-3
    cond = {"context": _meta((1, 77, 2048)), "y": _meta((1, 2816))}
    c = trace_calls(engine, {"x": (1, 4, 128, 128), "cond": cond}, (1, 4, 128, 128))
    assert all(body == "wgmma" for part in c.values() for kind in part.values()
               for *_, body in kind)
    assert _count(c["call"]["flash"]) == {((2, 10, 4096, 64), 4096): 10,
                                          ((2, 20, 1024, 64), 1024): 60}
    assert len(c["call"]["conv"]) == 34
    assert c["decode"]["flash"] == [((1, 1, 16384, 512), 16384, "wgmma")]
    assert len(c["decode"]["conv"]) == 28
    total = {k: 50 * len(c["call"][k]) + len(c["decode"][k]) for k in ("flash", "conv")}
    assert total == {"flash": 3501, "conv": 1728}

"""The port's CFG hook layer and the extensions on it against forge_tpu (CPU, f32).

`make_cfg_model_fn`'s `pre_cfg_hooks`, `cfg_combine_fn` and `post_cfg_hooks`
on the plain and the branched paths (AND weights, regional masks, no uncond,
the CFG++ pair, the rescale) run a stub model and the same elementwise hooks
through both packages: ≤ 1e-6 of the largest value. Dynamic thresholding's
and the latent modifier's combine functions (every schedule mode, every
variability measure and start point; every tonemap, sharpness and drift
method; with the predictor's t and with the σ table's) take the same seeded
x0 predictions: 1e-4 of their scale. PAG's perturbed pass and SAG's mask,
blur and degraded pass on the tiny SDXL of tests/test_torch_sdxl.py: 1e-4 of
their scale. The reference hooks see NHWC, the port's NCHW: the inputs are
transposed, never fed to a port hook in NHWC. Shown from both sides: PAG on
Flux and the latent modifier's "subtract_channels". The port's refusals: the
three fields on SD2, SD3, Playground, Chroma and Flux, in serving, with the
refiner and in a REST payload. The tiny txt2img slices with these
extensions are tests/test_torch_cfg_hooks_slice.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_prompts import _stub_model  # noqa: E402
from test_torch_sdxl import (REQUEST, _assert_close, _jax_engine, _port_engine,  # noqa: E402
                             _tiny_sdxl_checkpoint)

def _nhwc(a):
    return jnp.asarray(np.asarray(a, np.float32).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def engines():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


# -- sampling/cfg.py: the hook layer --------------------------------------------------------


def _hooks(x_to):
    """pre, combine and post hooks of the same elementwise arithmetic in
    either package; `x_to` casts σ (a JAX scalar or a host float)."""
    def pre(ec, eu, x, s):
        return ec * 1.1 + 0.01 * x_to(s), eu * 0.9 - 0.02 * x

    def combine(ec, eu, x, s, cfg):
        return eu + (cfg * 0.8) * (ec - eu) + 0.001 * x * x_to(s)

    def post(x0, ec, eu, x, s):
        return x0 + 0.05 * (ec - eu) - 0.01 * x

    def post2(x0, ec, eu, x, s):
        return x0 * 0.97 + 0.002 * ec

    return pre, combine, post, post2


HOOK_CASES = {  # name: (cfg, weights or None, masks?, branches, rescale, pair, which hooks)
    "plain: pre, combine, post": (7.0, None, False, 0, 0.0, False, "pre combine post"),
    "plain: pre, post, rescale 0.7": (7.0, None, False, 0, 0.7, False, "pre post"),
    "plain: combine, rescale 0.7, two posts": (7.0, None, False, 0, 0.7, False,
                                               "combine post post2"),
    "plain, no uncond: post only": (1.0, None, False, 0, 0.0, False, "pre combine post"),
    "plain, no uncond, CFG++ pair": (1.0, None, False, 0, 0.0, True, "pre combine post"),
    "plain, CFG++ pair": (7.0 / 12.5, None, False, 0, 0.0, True, "pre combine post"),
    "AND: pre, combine, post, rescale 0.5": (7.0, [1.0, 0.8], False, 1, 0.5, False,
                                             "pre combine post"),
    "AND, no uncond: post, CFG++ pair": (1.0, [1.0, 0.6], False, 1, 0.0, True,
                                         "pre combine post"),
    "regional: pre, post": (7.0, [1.0, 0.9, 0.7], True, 2, 0.0, False, "pre post"),
    "AND, CFG++ pair": (7.0 / 12.5, [1.0, 0.8], False, 1, 0.0, True, "pre combine post"),
}


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_cfg_hooks_match_forge_tpu(case):
    from forge_tpu.sampling import cfg as jcfg
    from forge_tpu_torch.sampling import cfg as tcfg

    cfg, weights, masked, n_br, rescale, pair, which = HOOK_CASES[case]
    rng = np.random.default_rng(17)
    b, c, h, w = 2, 4, 8, 6
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)

    def cond_np():
        return {"context": rng.standard_normal((b, 5, 3)).astype(np.float32),
                "y": rng.standard_normal((b, 2)).astype(np.float32)}

    conds = [cond_np() for _ in range(1 + n_br)]
    uncond = None if cfg == 1.0 else cond_np()
    maps = [None] + [rng.random((h, w)).astype(np.float32) for _ in range(n_br)] if masked else None

    def side(cfg_mod, to, wrap_mask, x_to):
        pre, combine, post, post2 = _hooks(x_to)
        names = which.split()
        ms = None if maps is None else [None if m is None else wrap_mask(m) for m in maps]

        def conv(d):
            return None if d is None else {k: to(v) for k, v in d.items()}

        return cfg_mod.make_cfg_model_fn(
            _stub_model(cfg_mod is jcfg), conv(conds[0]), conv(uncond), cfg, cfg_rescale=rescale,
            cond_branches=[conv(cd) for cd in conds[1:]] or None, branch_weights=weights,
            branch_masks=ms, return_uncond=pair,
            pre_cfg_hooks=(pre,) if "pre" in names else (),
            post_cfg_hooks=tuple(fn for name, fn in (("post", post), ("post2", post2))
                                 if name in names),
            cfg_combine_fn=combine if "combine" in names else None)

    jfn = side(jcfg, jnp.asarray, lambda m: jnp.asarray(m)[..., None], lambda s: s)
    tfn = side(tcfg, torch.from_numpy, lambda m: torch.from_numpy(m)[None, None], float)
    hookless = tcfg.make_cfg_model_fn(_stub_model(False), {k: torch.from_numpy(v) for k, v in
                                                           conds[0].items()}, None, 1.0)
    for sigma in (14.6, 2.5):
        want = jfn(_nhwc(x), jnp.float32(sigma))
        got = tfn(torch.from_numpy(x), sigma)
        wants, gots = (want, got) if pair else ((want,), (got,))
        assert len(wants) == len(gots)
        for wv, gv in zip(wants, gots):
            wv, gv = _nchw(wv), gv.numpy()
            assert gv.shape == wv.shape
            assert np.abs(gv - wv).max() <= 1e-6 * np.abs(wv).max(), (case, sigma)
        if n_br == 0 and uncond is None:  # the hooks moved the result
            assert not np.allclose(gots[0].numpy(), hookless(torch.from_numpy(x), sigma).numpy())


# -- extensions/dynamic_thresholding.py ------------------------------------------------------


DYNTHRESH_CASES = {
    "AD, MEAN, per channel": {},
    "STD, MEAN, per channel": dict(variability_measure="STD"),
    "AD, ZERO, per channel": dict(scaling_startpoint="ZERO"),
    "STD, ZERO, whole tensor": dict(variability_measure="STD", scaling_startpoint="ZERO",
                                    separate_feature_channels=False),
    "AD, MEAN, whole tensor, percentile 0.95": dict(separate_feature_channels=False,
                                                     threshold_percentile=0.95),
    "percentile 0.9, phi 0.7, mimic 4": dict(threshold_percentile=0.9, interpolate_phi=0.7,
                                             mimic_scale=4.0),
}


def _eps_pair(seed, shape=(2, 4, 16, 12)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.8 * rng.standard_normal(shape) + 0.1).astype(np.float32))


def _combine_both(jfn, tfn, cond, uncond, sigma, cfg):
    """The two combine functions on the same x0 predictions → (port NCHW, reference NCHW)."""
    want = _nchw(jfn(_nhwc(cond), _nhwc(uncond), None, jnp.float32(sigma), cfg))
    got = tfn(torch.from_numpy(cond), torch.from_numpy(uncond), None, sigma, cfg).numpy()
    return got, want


@pytest.mark.parametrize("case", list(DYNTHRESH_CASES))
def test_dynthresh_combine_matches(case):
    from forge_tpu.extensions.dynamic_thresholding import build_dynthresh_cfg_fn as jbuild
    from forge_tpu_torch.extensions.dynamic_thresholding import build_dynthresh_cfg_fn

    kw = DYNTHRESH_CASES[case]
    cond, uncond = _eps_pair(3)
    got, want = _combine_both(jbuild(**kw), build_dynthresh_cfg_fn(**kw), cond, uncond, 5.0, 15.0)
    _assert_close(got, want)
    plain = uncond + 15.0 * (cond - uncond)
    assert np.abs(got - plain).max() > 1e-2  # the threshold acted


@pytest.mark.parametrize("mode", ["Constant", "Linear Down", "Cosine Down", "Half Cosine Down",
                                  "Linear Up", "Cosine Up", "Half Cosine Up", "Power Up",
                                  "Power Down", "Linear Repeating", "Cosine Repeating",
                                  "Sawtooth"])
def test_dynthresh_schedule_modes_match(mode):
    """Each mode on the mimic and the CFG scale, over the σ table of 8
    Karras steps: the step's fraction found on the host as the reference
    finds it on the card."""
    from forge_tpu.extensions.dynamic_thresholding import DynThreshSpec as JSpec
    from forge_tpu_torch.extensions.dynamic_thresholding import MODES, DynThreshSpec
    from forge_tpu_torch.sampling.prediction import DiscretePrediction
    from forge_tpu_torch.sampling.schedules import get_sigmas

    assert mode in MODES
    sigmas = np.asarray(get_sigmas("karras", 8, DiscretePrediction()), np.float32)
    kw = dict(mimic_scale=5.0, mimic_mode=mode, mimic_scale_min=1.5, cfg_mode=mode,
              cfg_scale_min=2.0, sched_val=2.5, variability_measure="STD")
    jfn, tfn = JSpec(**kw).build(sigmas), DynThreshSpec(**kw).build(sigmas)
    cond, uncond = _eps_pair(4, (1, 4, 8, 8))
    for sigma in list(sigmas[:-1]) + [0.5 * (sigmas[2] + sigmas[3])]:
        got, want = _combine_both(jfn, tfn, cond, uncond, float(sigma), 12.0)
        _assert_close(got, want)


def test_dynthresh_attach_writes_the_reference_keys():
    from forge_tpu.extensions.dynamic_thresholding import attach as jattach
    from forge_tpu.pipeline.processing import Processing as JP
    from forge_tpu_torch.extensions.dynamic_thresholding import DynThreshSpec, attach
    from forge_tpu_torch.pipeline.processing import Processing

    args = {"mimic_scale": 4.0, "threshold_percentile": 0.98, "cfg_mode": "Linear Down",
            "not_a_field": 1}
    jp, tp = JP(), Processing()
    jattach(jp, args)
    attach(tp, args)
    assert tp.extra_generation_params == jp.extra_generation_params
    assert tp.cfg_combine_hook == DynThreshSpec(mimic_scale=4.0, threshold_percentile=0.98,
                                                cfg_mode="Linear Down")


# -- extensions/latent_modifier.py ------------------------------------------------------------


LATENT_MODIFIER_CASES = {
    "sharpness gaussian": dict(sharpness_multiplier=800.0),
    "sharpness cas": dict(sharpness_multiplier=900.0, sharpness_method="cas"),
    "tonemap reinhard": dict(tonemap_multiplier=1.2),
    "tonemap reinhard, percentile 90": dict(tonemap_multiplier=0.8, tonemap_percentile=90.0),
    "tonemap reinhard_perchannel": dict(tonemap_multiplier=1.5,
                                        tonemap_method="reinhard_perchannel"),
    "tonemap arctan": dict(tonemap_multiplier=2.0, tonemap_method="arctan",
                           tonemap_percentile=95.0),
    "tonemap quantile": dict(tonemap_multiplier=0.4, tonemap_method="quantile",
                             tonemap_percentile=97.0),
    "tonemap cfg-mimic": dict(tonemap_multiplier=4.0, tonemap_method="cfg-mimic",
                              tonemap_percentile=99.0),
    "tonemap spatial-norm": dict(tonemap_multiplier=3.0, tonemap_method="spatial-norm"),
    "contrast": dict(contrast_multiplier=700.0),
    "rescale phi": dict(rescale_cfg_phi=0.7),
    "combat subtract": dict(combat_cfg_drift=0.8),
    "combat subtract_median": dict(combat_cfg_drift=0.8, combat_method="subtract_median"),
    "combat sharpen": dict(combat_cfg_drift=0.6, combat_method="sharpen"),
    "all at once": dict(sharpness_multiplier=500.0, tonemap_multiplier=1.1,
                        contrast_multiplier=300.0, rescale_cfg_phi=0.5, combat_cfg_drift=0.5),
}


@pytest.mark.parametrize("t_from", ["predictor", "sigma table"])
@pytest.mark.parametrize("case", list(LATENT_MODIFIER_CASES))
def test_latent_modifier_combine_matches(case, t_from):
    from forge_tpu.extensions.latent_modifier import LatentModifierSpec as JSpec
    from forge_tpu.sampling.prediction import DiscretePrediction as JPred
    from forge_tpu_torch.extensions.latent_modifier import LatentModifierSpec
    from forge_tpu_torch.sampling.prediction import DiscretePrediction
    from forge_tpu_torch.sampling.schedules import get_sigmas

    kw = LATENT_MODIFIER_CASES[case]
    sigmas = np.asarray(get_sigmas("karras", 6, DiscretePrediction()), np.float32)
    jpred, tpred = (JPred(), DiscretePrediction()) if t_from == "predictor" else (None, None)
    jfn = JSpec(**kw).build(sigmas, predictor=jpred)
    tfn = LatentModifierSpec(**kw).build(sigmas, predictor=tpred)
    cond, uncond = _eps_pair(5)
    for sigma in (float(sigmas[1]), float(sigmas[4]), 0.4):
        got, want = _combine_both(jfn, tfn, cond, uncond, sigma, 7.0)
        _assert_close(got, want)


def test_latent_modifier_subtract_channels_from_both_sides():
    """The reference's "subtract_channels" concatenates a [B, 1, 1, 1] mean
    with [B, H, W, 3] zeros and raises; the port centres channel 0 only."""
    from forge_tpu.extensions.latent_modifier import LatentModifierSpec as JSpec
    from forge_tpu_torch.extensions.latent_modifier import LatentModifierSpec

    kw = dict(combat_cfg_drift=0.8, combat_method="subtract_channels")
    cond, uncond = _eps_pair(5)
    with pytest.raises(TypeError, match="concatenate"):
        JSpec(**kw).build(None)(_nhwc(cond), _nhwc(uncond), None, jnp.float32(1.0), 7.0)
    got = LatentModifierSpec(**kw).build(None)(torch.from_numpy(cond), torch.from_numpy(uncond),
                                               None, 1.0, 7.0).numpy()
    x = uncond + 7.0 * (cond - uncond)
    a = 0.5 * 0.8  # (1 − t) · drift, t = 0.5 without a predictor or a σ table
    want = x.copy()
    want[:, 0] = (x[:, 0] - x[:, 0].mean(axis=(1, 2), keepdims=True)) * a + x[:, 0] * (1 - a)
    _assert_close(got, want, rel=1e-5)


def test_latent_modifier_refusals():
    """The noise types the reference refuses raise ValueError on both sides;
    its gaussian and uniform extra noise (JAX's threefry PRNG) raise
    NotImplementedError in the port."""
    from forge_tpu.extensions.latent_modifier import LatentModifierSpec as JSpec
    from forge_tpu_torch.extensions.latent_modifier import LatentModifierSpec

    for spec in (JSpec, LatentModifierSpec):
        with pytest.raises(ValueError, match="perlin"):
            spec(extra_noise_multiplier=1.0, extra_noise_type="perlin")
    JSpec(extra_noise_multiplier=1.0, extra_noise_type="uniform").build(None)
    for kind in ("gaussian", "uniform"):
        with pytest.raises(NotImplementedError, match="threefry"):
            LatentModifierSpec(extra_noise_multiplier=1.0, extra_noise_type=kind)


def test_latent_modifier_attach_writes_the_reference_keys():
    from forge_tpu.extensions.latent_modifier import attach as jattach
    from forge_tpu.pipeline.processing import Processing as JP
    from forge_tpu_torch.extensions.latent_modifier import attach
    from forge_tpu_torch.pipeline.processing import Processing

    args = {"tonemap_multiplier": 1.2, "tonemap_method": "arctan", "sharpness_multiplier": 3.0}
    jp, tp = JP(), Processing()
    jattach(jp, args)
    attach(tp, args)
    assert tp.extra_generation_params == jp.extra_generation_params


# -- extensions/pag.py, extensions/sag.py on the tiny SDXL ----------------------------------


def _x0_inputs(seed=9, b=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 4, 8, 8)).astype(np.float32) for _ in range(4)]


def test_pag_post_cfg_matches(engines):
    from forge_tpu.extensions.pag import build_pag_post_cfg as jbuild
    from forge_tpu_torch.extensions.pag import build_pag_post_cfg

    jeng, teng = engines
    jcond = jeng.get_learned_conditioning(["a red fox"], 64, 64)
    tcond = teng.get_learned_conditioning(["a red fox"], 64, 64)
    jpost, tpost = jbuild(jeng, jcond, pag_scale=3.0), build_pag_post_cfg(teng, tcond, 3.0)
    x0, ec, eu, x = _x0_inputs()
    x = 8.0 * x
    for sigma in (14.6, 1.3):
        want = _nchw(jpost(_nhwc(x0), _nhwc(ec), _nhwc(eu), _nhwc(x), jnp.float32(sigma)))
        with torch.no_grad():
            got = tpost(*(torch.from_numpy(a) for a in (x0, ec, eu, x)), sigma).numpy()
        _assert_close(got, want)
        assert np.abs(got - x0).max() > 1e-2


def test_gaussian_blur_matches():
    from forge_tpu.extensions.sag import gaussian_blur_2d as jblur
    from forge_tpu_torch.extensions.sag import gaussian_blur_2d

    x = np.random.default_rng(2).standard_normal((2, 3, 13, 10)).astype(np.float32)
    for k, s in ((9, 1.0), (9, 2.0), (5, 0.7)):
        _assert_close(gaussian_blur_2d(torch.from_numpy(x), k, s).numpy(),
                      _nchw(jblur(_nhwc(x), k, s)), rel=1e-5)


def test_sag_record_and_post_cfg_match(engines):
    """One hooked forward at CFG batch 2 records the middle block's q and k
    in each package; then the post-CFG hook (the mask, the blur, the
    degraded pass at batch 1)."""
    from forge_tpu.extensions.sag import build_sag as jbuild
    from forge_tpu_torch.extensions.sag import build_sag

    jeng, teng = engines
    prompts = ["a red fox", "blurry"]
    jc = jeng.get_learned_conditioning(prompts, 64, 64)
    tc = teng.get_learned_conditioning(prompts, 64, 64)
    jhooks, jpost = jbuild(jeng, {k: v[:1] for k, v in jc.items()}, 0.75, 2.0)
    thooks, tpost = build_sag(teng, {k: v[:1] for k, v in tc.items()}, 0.75, 2.0)
    x0, ec, eu, x = _x0_inputs(11)
    x = 8.0 * x
    xin = np.concatenate([x, x]) / np.sqrt(64.0 + 1.0)
    ts = np.full((2,), 800.0, np.float32)
    jeng.unet_apply_fn(hooks=jhooks)(jeng.loaded.unet, _nhwc(xin), jnp.asarray(ts), **jc)
    with torch.no_grad():
        teng.unet_apply_fn(hooks=thooks)(teng.loaded.unet, torch.from_numpy(xin),
                                         torch.from_numpy(ts), **tc)
        got = tpost(*(torch.from_numpy(a) for a in (x0, ec, eu, x)), 8.0).numpy()
    want = _nchw(jpost(_nhwc(x0), _nhwc(ec), _nhwc(eu), _nhwc(x), jnp.float32(8.0)))
    _assert_close(got, want)
    assert np.abs(got - x0).max() > 1e-2


# -- the refusals ---------------------------------------------------------------------------


def test_pag_on_flux_from_both_sides():
    """The reference's Flux apply drops PAG's identity hooks without a word:
    its perturbed pass is the plain cond pass, so PAG adds scale · 0 to x0;
    and a Flux request with PAG fails in the reference's jit-key digest of
    the hook (AttributeError). The port refuses the hooks on Flux and the
    CFG hooks on a Flux request."""
    from forge_tpu.extensions.pag import build_pag_post_cfg as jbuild
    from forge_tpu.models.flux import FluxConfig as JCfg
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu.sampling.cfg import make_apply_model as jmake_apply
    from forge_tpu_torch.extensions.pag import build_pag_post_cfg
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from test_torch_flux import REQUEST as FLUX_REQUEST
    from test_torch_flux import _port_engine as flux_port_engine
    from test_torch_flux import _tiny_flux_checkpoint

    sd = _tiny_flux_checkpoint()
    jeng = jload(dict(sd), dtype=jnp.float32)
    jeng.flux_cfg = JCfg(num_heads=4, axes_dim=(4, 6, 6), guidance_embed=True)
    cond = jeng.get_learned_conditioning([FLUX_REQUEST["prompt"]], 32, 32)
    cond["guidance"] = jnp.full((1,), 3.5, jnp.float32)
    post = jbuild(jeng, cond, 3.0)
    apply = jmake_apply(jeng.unet_apply_fn(), jeng.loaded.unet, jeng.predictor,
                        jeng.compute_dtype)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((1, 4, 4, 16)).astype(np.float32))
    x0 = jnp.asarray(rng.standard_normal((1, 4, 4, 16)).astype(np.float32))
    sigma = jnp.float32(0.7)
    eps = apply(x, sigma, cond)
    assert np.array_equal(np.asarray(post(x0, eps, eps, x, sigma)), np.asarray(x0))
    with pytest.raises(AttributeError, match="co_code"):
        jproc.process_images(jeng, jproc.Processing(**FLUX_REQUEST, post_cfg_hooks=[post]))

    teng = flux_port_engine(dict(sd))
    tcond = teng.get_learned_conditioning([FLUX_REQUEST["prompt"]], 32, 32)
    with pytest.raises(NotImplementedError, match="flux"):
        build_pag_post_cfg(teng, tcond, 3.0)
    with pytest.raises(NotImplementedError, match="post_cfg_hooks on flux"):
        process_images(teng, Processing(**FLUX_REQUEST, post_cfg_hooks=[lambda *a: a[0]]))


def _family_engine(family):
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    if family == "sd20":
        from test_torch_sd2 import W, _tiny_sd2_checkpoint

        eng = load_engine(_tiny_sd2_checkpoint(False), device="cpu")
        eng.unet_cfg = UNetConfig(context_dim=W, num_heads=4)
    elif family == "sd3":
        from test_torch_sd3 import CTX as SD3_CTX
        from test_torch_sd3 import _tiny_sd3_checkpoint

        eng = load_engine(_tiny_sd3_checkpoint(), device="cpu")
        eng.loaded.context_dim = SD3_CTX
    elif family == "playground":
        sd = _tiny_sdxl_checkpoint()
        sd["edm_mean"] = np.zeros(4, np.float32)
        sd["edm_std"] = np.ones(4, np.float32)
        eng = _port_engine(sd)
    else:
        from test_torch_chroma import _tiny_chroma_checkpoint

        eng = load_engine(_tiny_chroma_checkpoint(), device="cpu")
    assert eng.family == family
    return eng


@pytest.mark.parametrize("family", ["sd20", "sd3", "playground", "chroma"])
def test_other_families_refuse_the_cfg_hooks(family):
    from forge_tpu_torch.extensions.dynamic_thresholding import DynThreshSpec
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    eng = _family_engine(family)
    request = dict(prompt="a fox", seed=1, steps=2, width=32, height=32)
    for field, value in (("pre_cfg_hooks", [lambda c, u, x, s: (c, u)]),
                         ("post_cfg_hooks", [lambda x0, c, u, x, s: x0]),
                         ("cfg_combine_hook", DynThreshSpec())):
        with pytest.raises(NotImplementedError, match=f"{field} on {family}"):
            process_images(eng, Processing(**request, **{field: value}))
    with pytest.raises(NotImplementedError, match=f"unet_hooks on {family}"):
        process_images(eng, Processing(**request, unet_hooks={"output_block_patch": ()}))


def test_serving_and_the_refiner_refuse_the_cfg_hooks(engines):
    from forge_tpu_torch.extensions.dynamic_thresholding import DynThreshSpec
    from forge_tpu_torch.extensions.freeu import build_freeu_hooks
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from forge_tpu_torch.runtime.serving import ServingPipeline

    teng = engines[1]
    pipe = ServingPipeline(teng, depth=2)
    try:
        futures = [pipe.submit(Processing(**REQUEST, **{field: value})) for field, value in (
            ("pre_cfg_hooks", [lambda c, u, x, s: (c, u)]),
            ("post_cfg_hooks", [lambda x0, c, u, x, s: x0]),
            ("cfg_combine_hook", DynThreshSpec()))]
        for fut in futures:
            with pytest.raises(NotImplementedError, match="serving with"):
                fut.result(timeout=60)
    finally:
        pipe.close()
    for fields in (dict(cfg_combine_hook=DynThreshSpec()),
                   dict(unet_hooks=build_freeu_hooks(model_channels=32))):
        p = Processing(**REQUEST, refiner_switch_at=0.5, **fields)
        p._refiner_engine = teng
        with pytest.raises(NotImplementedError, match="with the refiner"):
            process_images(teng, p)


def test_rest_payload_refuses_the_cfg_hooks():
    """A JSON payload cannot carry Python hooks: 422, as before the fields
    were ported; null values are dropped as the reference's defaults."""
    from forge_tpu_torch.api.server import ApiError, _processing_from_payload

    for field in ("pre_cfg_hooks", "post_cfg_hooks", "cfg_combine_hook"):
        with pytest.raises(ApiError) as err:
            _processing_from_payload({"prompt": "a fox", field: ["not a hook"]})
        assert err.value.status == 422 and field in str(err.value)
        assert getattr(_processing_from_payload({"prompt": "a fox", field: None}), field) is None

"""Soft inpainting and the img2img options (forge_tpu_torch/extensions/
soft_inpainting.py, pipeline/processing.py) against forge_tpu's (CPU, f32).

`get_modified_nmask` and `latent_blend` on seeded latents (the port's NCHW
against the reference's NHWC) within 1e-5 relative, the soft-masked model
function with a plain and a CFG++ pair model, `attach`'s settings and
infotext keys; then the tiny SDXL of tests/test_torch_sdxl.py through both
packages' process_images: an inpaint request with soft inpainting at its
defaults, `img2img_extra_noise` 0.1, `img2img_color_correction`, and all
three together, each unlike the request without it, with equal infotexts.
The decoded batches (a script's `postprocess_batch` sees them before the
colour correction and the paste) meet the slice bar (80 dB), and
forge_tpu's finish handed the port's batch (the script returns it) gives
the port's images byte for byte: colour correction's histogram matching
can turn the ±1 level of two decodes at 86 dB into a few levels, so the
final images of the colour-corrected requests are held this way.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_controls_cases import (SDXL_REQUEST, SLICE_BAR, assert_slice, init_and_mask,  # noqa: E402
                                  processing, run_both, sdxl_engines)

RTOL = 1e-5


def _settings(package, **kw):
    import importlib

    return importlib.import_module(f"{package}.extensions.soft_inpainting").SoftInpaintingSettings(
        **kw)


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("kw", [dict(), dict(mask_blend_power=0.5, mask_blend_scale=1.5,
                                              inpaint_detail_preservation=2.0)])
def test_blend_and_mask_match_forge_tpu(kw):
    import jax.numpy as jnp

    from forge_tpu.extensions import soft_inpainting as jsoft
    from forge_tpu_torch.extensions import soft_inpainting as soft

    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 4, 8, 12)).astype(np.float32)
    b = rng.standard_normal((2, 4, 8, 12)).astype(np.float32) * 2
    nmask = rng.uniform(0, 1, (1, 1, 8, 12)).astype(np.float32)
    jset, tset = _settings("forge_tpu", **kw), _settings("forge_tpu_torch", **kw)
    for sigma in (14.6, 3.2, 0.03):
        want_t = np.asarray(jsoft.get_modified_nmask(jset, jnp.asarray(_nhwc(nmask)), sigma))
        t = soft.get_modified_nmask(tset, torch.from_numpy(nmask), sigma)
        np.testing.assert_allclose(_nhwc(t.numpy()), want_t, rtol=RTOL, atol=1e-7)
        want = np.asarray(jsoft.latent_blend(jset, jnp.asarray(_nhwc(a)), jnp.asarray(_nhwc(b)),
                                             jnp.asarray(want_t)))
        got = soft.latent_blend(tset, torch.from_numpy(a), torch.from_numpy(b), t)
        np.testing.assert_allclose(_nhwc(got.numpy()), want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("pair", [False, True])
def test_soft_masked_model_fn(pair):
    """The wrapped model function blends x0 with the init latent; a CFG++
    pair keeps its uncond term; a bf16 x0 is blended in f32 and cast back."""
    import jax.numpy as jnp

    from forge_tpu.extensions import soft_inpainting as jsoft
    from forge_tpu_torch.extensions import soft_inpainting as soft

    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    init = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    mask = rng.uniform(0, 1, (1, 1, 8, 8)).astype(np.float32)
    un = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)

    def model(x, sigma):
        return (x, x * 0 + jnp.asarray(_nhwc(un))) if pair else x

    def tmodel(x, sigma):
        return (x, torch.from_numpy(un)) if pair else x

    want = jsoft.make_soft_masked_model_fn(model, jnp.asarray(_nhwc(mask)),
                                           jnp.asarray(_nhwc(init)),
                                           _settings("forge_tpu"))(jnp.asarray(_nhwc(x0)), 2.5)
    got = soft.make_soft_masked_model_fn(tmodel, torch.from_numpy(mask), torch.from_numpy(init),
                                         _settings("forge_tpu_torch"))(torch.from_numpy(x0), 2.5)
    if pair:
        (want, want_un), (got, got_un) = want, got
        assert np.array_equal(got_un.numpy(), un)
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), rtol=RTOL, atol=RTOL)
    half = soft.make_soft_masked_model_fn(lambda x, s: x, torch.from_numpy(mask),
                                          torch.from_numpy(init), _settings("forge_tpu_torch"))(
        torch.from_numpy(x0).bfloat16(), 2.5)
    assert half.dtype == torch.bfloat16


def test_attach_settings_and_infotext():
    from forge_tpu.extensions import soft_inpainting as jsoft
    from forge_tpu_torch.extensions import soft_inpainting as soft

    args = {"Schedule bias": 2, "Preservation strength": 0.25, "mask_blend_power": 1.5,
            "Transition contrast boost": 8, "Mask influence": 0.1}
    for mod, proc in ((jsoft, processing("forge_tpu")), (soft, processing("forge_tpu_torch"))):
        p = proc.Processing()
        mod.attach(p, args)
        assert p.soft_inpainting.mask_blend_power == 1.5
        assert p.soft_inpainting.mask_blend_scale == 0.25
        assert p.soft_inpainting.composite_mask_influence == 0.1
        assert p.extra_generation_params == {
            "Soft inpainting": "True", "Soft inpainting schedule bias": 1.5,
            "Soft inpainting preservation strength": 0.25,
            "Soft inpainting transition contrast boost": 8.0}


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


CASES = {
    "soft inpainting": (dict(), True),
    "extra noise": (dict(img2img_extra_noise=0.1), False),
    "color correction": (dict(img2img_color_correction=True), False),
    "all three": (dict(img2img_extra_noise=0.1, img2img_color_correction=True), True),
}


def _batch_script(package, seen, replace=None):
    """A runner whose script records the decoded batch its
    `postprocess_batch` sees (before colour correction and the paste) and,
    given `replace`, hands that batch on in its place."""
    import importlib

    mod = importlib.import_module(f"{package}.runtime.scripts")

    class Batch(mod.Script):
        name = "batch"

        def postprocess_batch(self, p, images, **kw):
            seen.append(np.array(images))
            return replace

    runner = mod.ScriptRunner()
    runner.register(Batch())
    return runner


@pytest.mark.parametrize("case", list(CASES))
def test_inpaint_request_matches_forge_tpu(engines, case):
    """The decoded batches at the slice bar; forge_tpu's finish (its cv2
    colour correction and paste) handed the port's decoded batch gives the
    port's images byte for byte; the infotexts equal."""
    import importlib

    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.runtime.options import opts
    from test_torch_sdxl import _psnr

    options, soft_on = CASES[case]
    init, mask = init_and_mask()
    fields = dict(SDXL_REQUEST, init_images=[init], inpaint_mask=mask, denoising_strength=0.75,
                  mask_blur=2)
    raw, handed = {}, []

    def attach(package, p):
        if soft_on:
            importlib.import_module(f"{package}.extensions.soft_inpainting").attach(p, {})

    with jopts.override(options), opts.override(options):
        got, want, tp = run_both(engines, fields, lambda pk, p: (
            attach(pk, p), setattr(p, "scripts", _batch_script(pk, raw.setdefault(pk, []))),
        ))
        jproc = processing("forge_tpu")
        jp = jproc.Processing(**fields)
        attach("forge_tpu", jp)
        jp.scripts = _batch_script("forge_tpu", handed, replace=raw["forge_tpu_torch"][0])
        finished = jproc.process_images(engines[0], jp)
    assert _psnr(raw["forge_tpu_torch"][0], raw["forge_tpu"][0]) >= SLICE_BAR
    assert np.array_equal(finished.images[0], got.images[0])
    assert_slice(got, want, bar=SLICE_BAR if "img2img_color_correction" not in options
                 else 0.0)
    text = got.infotexts[0]
    assert ("Soft inpainting: True" in text) == soft_on
    assert ("Extra noise: 0.1" in text) == ("img2img_extra_noise" in options)
    proc = processing("forge_tpu_torch")
    plain = proc.process_images(engines[1], proc.Processing(**fields)).images[0]
    assert not np.array_equal(got.images[0], plain)
    far = np.ones(mask.shape, bool)  # 4σ of the blur past the mask: the init image (the
    far[16 - 9:48 + 9, 16 - 9:48 + 9] = False  # colour correction comes before the paste)
    assert np.array_equal(got.images[0][far], init[far])

"""The img2img selectable scripts through both packages (CPU, f32): loopback,
SD upscale, poor man's outpainting, Outpainting mk2 and img2img alternative
test.

The tiny SDXL of tests/test_torch_sdxl.py (DPM++ 2M Karras, 3 steps, CFG 7)
from a seeded 64² init image: loopback at 2 loops to denoising 0.5; SD
upscale ×2 by Lanczos (pipeline/upscalers.py's numpy Lanczos, Pillow's to
the byte) in 64² tiles with overlap 16 (9 tiles); both outpaintings 32 px
on every side (a 128² canvas; mk2's spectrum-matched noise drawn from
numpy's generator, bit-equal); img2img alternative test with 3 decode
steps, its noise found by the reverse Euler walk and its randomness drawn
NHWC as the reference draws it. Each image at the slice bar (80 dB; the
alternative test at 70 dB, `ALT_BAR`), the infotexts and seeds equal.
`_matched_noise_fill` bit-equal; the alternative test's
`find_noise_for_image` within 1e-4 of the reference's.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_selectable_scripts import run_script, scripts_of  # noqa: E402
from torch_controls_cases import (PACKAGES, SDXL_REQUEST, assert_slice, init_and_mask,  # noqa: E402
                                  processing, sdxl_engines)


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


def _img2img(**fields):
    init, _ = init_and_mask()
    return {**SDXL_REQUEST, "init_images": [init], "denoising_strength": 0.6, **fields}


def test_loopback_matches_forge_tpu(engines):
    got, want, _ = run_script(engines, "Loopback", _img2img(), loops=2,
                              final_denoising_strength=0.5, denoising_curve="Aggressive")
    assert_slice(got, want)
    assert got.seeds == want.seeds == [1, 2] and len(got.images) == 2
    assert "Denoising strength: 0.5," in got.infotexts[1]


def test_sd_upscale_matches_forge_tpu(engines):
    got, want, tp = run_script(engines, "SD upscale", _img2img(), None, 16, "Lanczos", 2.0)
    assert got.images[0].shape == (128, 128, 3) and (tp.width, tp.height) == (64, 64)
    assert_slice(got, want)
    assert got.seeds == want.seeds == [1]


@pytest.mark.parametrize("name,kwargs", [
    ("Poor man's outpainting", dict(pixels=32, mask_blur=4, inpainting_fill="fill")),
    ("Outpainting mk2", dict(pixels=32, mask_blur=8, noise_q=1.0, color_variation=0.05)),
])
def test_outpainting_matches_forge_tpu(engines, name, kwargs):
    got, want, _ = run_script(engines, name, _img2img(denoising_strength=0.8), **kwargs)
    assert got.images[0].shape == (128, 128, 3)
    assert_slice(got, want)


def test_matched_noise_fill_is_bit_equal():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for sides, seed in (((32, 0, 8, 16), 3), ((0, 24, 24, 0), 2 ** 33 + 5)):
        want = scripts_of("forge_tpu")._matched_noise_fill(img, *sides, 0.8, 0.1, seed=seed)
        got = scripts_of("forge_tpu_torch")._matched_noise_fill(img, *sides, 0.8, 0.1, seed=seed)
        assert np.array_equal(got, want)


# the reverse walk's first step divides by the least σ (0.029 on this schedule), which takes
# the two packages' f32 rounding up ~35 times: 73.84 dB measured on this request
ALT_BAR = 70.0


def test_img2img_alternative_matches_forge_tpu(engines):
    kwargs = dict(original_prompt="a photograph of an astronaut", original_negative_prompt="",
                  st=3, randomness=0.25)
    got, want, _ = run_script(engines, "img2img alternative test", _img2img(), None, **kwargs)
    assert_slice(got, want, bar=ALT_BAR)
    assert got.infotexts == want.infotexts == [
        f"{SDXL_REQUEST['prompt']}\nimg2img alternative, decode steps 3"]


def test_find_noise_for_image_matches_forge_tpu(engines):
    """The reverse Euler walk on the same encoded latent and conds; the
    result in noise units (numpy's std: no Bessel correction)."""
    import jax.numpy as jnp

    latent = np.random.default_rng(8).standard_normal((1, 4, 8, 8)).astype(np.float32)
    outs = []
    for package, engine in zip(PACKAGES, engines):
        c = engine.get_learned_conditioning(["a castle"], 64, 64)
        u = engine.get_learned_conditioning([""], 64, 64, is_negative=True)
        mod = scripts_of(package)
        if package == "forge_tpu":
            x = np.asarray(mod.find_noise_for_image(
                engine, jnp.asarray(latent.transpose(0, 2, 3, 1)), c, u, 1.0, 3))
            x = x.transpose(0, 3, 1, 2)
        else:
            x = mod.find_noise_for_image(engine, torch.from_numpy(latent), c, u, 1.0, 3).numpy()
        outs.append(x)
    want, got = outs
    assert abs(float(got.std()) - 1.0) < 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_img2img_scripts_need_an_init_image(engines):
    for package, engine in zip(PACKAGES, engines):
        for name in ("Loopback", "SD upscale", "Poor man's outpainting", "Outpainting mk2",
                     "img2img alternative test"):
            with pytest.raises(ValueError, match="init image"):
                scripts_of(package).get_script(name).run(
                    engine, processing(package).Processing(**SDXL_REQUEST))

"""The port's samplers on img2img, inpainting and the hires fix, against forge_tpu.

The tiny SD1.5 checkpoint (tests/fixtures.py `make_sd15_checkpoint(0)`) in
both packages, `process_images` at 64², CFG 7, seed 1 (f32 on the CPU):
"UniPC" img2img at strength 0.6 of 6 steps (the schedule's tail, UniPC's
peeled last step); "DDIM CFG++" inpainting with `eta_ddim` 0.5 (the CFG++
pair under the mask composite, the scale × 1/12.5, one Philox draw a step
that eta_ddim turns on); and a "DPM++ SDE" Karras request with the hires
fix ("Latent" × 2 at denoising 0.6: the Brownian noise over the hires
pass's tail of σ at 128²). The uint8 images must reach PSNR ≥ 40 dB
against each other, the bar of tests/test_golden_parity.py, and the port's
must repeat byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402

SIZE = 64
REQUEST = dict(prompt="a castle on a hill", negative_prompt="blurry", seed=1, steps=6,
               width=SIZE, height=SIZE, cfg_scale=7.0)
CASES = {  # name: (request fields, masked, output side)
    "UniPC img2img": (dict(sampler_name="UniPC", denoising_strength=0.6), False, SIZE),
    "DDIM CFG++ inpaint, eta_ddim": (dict(sampler_name="DDIM CFG++", eta_ddim=0.5,
                                          denoising_strength=0.75), True, SIZE),
    "DPM++ SDE hires": (dict(sampler_name="DPM++ SDE", scheduler="karras", steps=4,
                             enable_hr=True, hr_scale=2.0, hr_upscaler="Latent",
                             hr_denoising_strength=0.6), False, 2 * SIZE),
}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def engines():
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    init = np.random.default_rng(0).uniform(0, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)
    init[8:40, 12:52] //= 3
    return make_tiny_engine(0), teng, init


def _request(proc, init, case):
    fields, masked, _ = CASES[case]
    p = proc.Processing(**dict(REQUEST, **fields))
    if "denoising_strength" in fields:
        p.init_images = [init]
    if masked:
        mask = np.zeros((SIZE, SIZE), np.float32)
        mask[20:44, 16:48] = 1.0
        p.inpaint_mask = mask
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_img2img_matches_forge_tpu(engines, case):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    jeng, teng, init = engines
    side = CASES[case][2]
    want = jproc.process_images(jeng, _request(jproc, init, case)).images[0]
    got = tproc.process_images(teng, _request(tproc, init, case)).images[0]
    assert got.shape == want.shape == (side, side, 3) and got.dtype == np.uint8
    value = _psnr(got, want)
    print(f"{case}: PSNR {value:.2f} dB")
    assert value >= 40.0, value
    assert np.array_equal(got, tproc.process_images(teng, _request(tproc, init, case)).images[0])

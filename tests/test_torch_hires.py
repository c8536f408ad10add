"""The port's hires fix end to end against forge_tpu: config 2's second pass in small.

A tiny SD1.5 (tests/fixtures.py `make_sd15_checkpoint(0)`; 64², Euler a, 3
steps, CFG 7) and the tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M
Karras, 3 steps) through `process_images` in both packages (f32 on the
CPU) with the hires fix: the latent modes ("Latent", "Latent (bicubic)",
"Latent (nearest)"), an explicit target (`hr_resize_x/y`, a non-integer
scale), `hr_second_pass_steps`, `hr_cfg_scale`, `hr_prompt` and
`hr_negative_prompt`, the pixel mode through Lanczos and through a tiny
ESRGAN (tests/test_torch_upscalers.py's, from each package's registry), and
another checkpoint for the second pass (`_hr_engine`). The uint8 images
must reach PSNR ≥ 40 dB against each other, the bar of
tests/test_golden_parity.py. tests/test_torch_hires_fields.py holds the
port's own checks of the same fields.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402
from test_torch_sdxl import _jax_engine, _port_engine, _psnr, _tiny_sdxl_checkpoint  # noqa: E402
from test_torch_upscalers import tiny_esrgan_sd  # noqa: E402

SD15 = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
            seed=1, steps=3, width=64, height=64, sampler_name="Euler a", cfg_scale=7.0,
            enable_hr=True, hr_scale=2.0)
SDXL = dict(SD15, sampler_name="DPM++ 2M", scheduler="karras")
CASES = {  # name: (model, the request's hires fields, image size)
    "sd15 latent": ("sd15", dict(), (128, 128)),
    "sd15 latent bicubic, steps, cfg": ("sd15", dict(hr_upscaler="Latent (bicubic)",
                                                     hr_second_pass_steps=4, hr_cfg_scale=4.0),
                                        (128, 128)),
    "sd15 latent nearest, resize to 96x80": ("sd15", dict(hr_upscaler="Latent (nearest)",
                                                          hr_resize_x=96, hr_resize_y=80),
                                             (80, 96)),
    "sd15 lanczos": ("sd15", dict(hr_upscaler="Lanczos", hr_denoising_strength=0.5),
                     (128, 128)),
    "sd15 esrgan": ("sd15", dict(hr_upscaler="tiny_x4"), (128, 128)),
    "sd15 hr engine, hr prompt": ("sd15", dict(hr_prompt="a red castle", hr_cfg_scale=5.0,
                                               hr_engine=True), (128, 128)),
    "sdxl latent, hr prompts": ("sdxl", dict(hr_prompt="a castle on a hill",
                                             hr_negative_prompt="dark"), (128, 128)),
    "sdxl esrgan, resize to 112x96": ("sdxl", dict(hr_upscaler="tiny_x4", hr_resize_x=112,
                                                   hr_resize_y=96), (96, 112)),
}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from forge_tpu.pipeline.upscalers import UpscalerRegistry as JRegistry
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry

    d = tmp_path_factory.mktemp("ESRGAN")
    save_safetensors(tiny_esrgan_sd(), str(d / "tiny_x4.safetensors"))

    def sd15(seed):
        eng = load_engine(make_sd15_checkpoint(seed), device="cpu")
        eng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
        return eng

    sdxl = _tiny_sdxl_checkpoint()
    out = {"sd15": (make_tiny_engine(0), sd15(0)), "sdxl": (_jax_engine(sdxl), _port_engine(sdxl)),
           "hr": (make_tiny_engine(42), sd15(42))}
    for jeng, teng in out.values():
        jeng.upscalers = JRegistry(model_dirs={"ESRGAN": str(d)})
        teng.upscalers = UpscalerRegistry(model_dirs={"ESRGAN": str(d)}, device="cpu")
    return out


def _run(proc, eng, hr_eng, model, fields):
    request = dict(SD15 if model == "sd15" else SDXL)
    request.update((k, v) for k, v in fields.items() if k != "hr_engine")
    p = proc.Processing(**request)
    if fields.get("hr_engine"):
        p._hr_engine = hr_eng
    return proc.process_images(eng, p)


@pytest.mark.parametrize("case", list(CASES))
def test_hires_matches_forge_tpu(engines, case):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    model, fields, (h, w) = CASES[case]
    (jeng, teng), (jhr, thr) = engines[model], engines["hr"]
    want = _run(jproc, jeng, jhr, model, fields).images[0]
    res = _run(tproc, teng, thr, model, fields)
    got = res.images[0]
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    pixel = not fields.get("hr_upscaler", "Latent").startswith("Latent")
    assert {"sample", "hires_upscale", "hires_sample", "decode"} <= set(res.timings)
    assert ("hires_encode" in res.timings) == pixel
    assert ("hires_cond" in res.timings) == bool(fields.get("hr_prompt"))
    value = _psnr(got, want)
    print(f"{case}: PSNR {value:.2f} dB")
    assert value >= 40.0, value

"""The port's hires fix on its own: each field moves the image, and another
checkpoint for the second pass comes from the engine resolver.

The tiny SD1.5 of tests/test_torch_hires.py (tests/fixtures.py
`make_sd15_checkpoint`, seeds 0 and 42; 64², Euler a, 3 steps, CFG 7, hires
×2), through the port alone; tests/test_torch_hires.py holds the same
requests against forge_tpu.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint  # noqa: E402
from torch_hires_cases import SD15, _run  # noqa: E402
from test_torch_upscalers import tiny_esrgan_sd  # noqa: E402


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The port's engines of tests/test_torch_hires.py's fixture (no forge_tpu side)."""
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry

    d = tmp_path_factory.mktemp("ESRGAN")
    save_safetensors(tiny_esrgan_sd(), str(d / "tiny_x4.safetensors"))

    def sd15(seed):
        eng = load_engine(make_sd15_checkpoint(seed), device="cpu")
        eng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
        eng.upscalers = UpscalerRegistry(model_dirs={"ESRGAN": str(d)}, device="cpu")
        return eng

    return {"sd15": (None, sd15(0)), "hr": (None, sd15(42))}


def test_hires_fields_change_the_image(engines):
    """Each field the parity cases pass moves the port's image: the hires
    pass itself, its upscaler, its prompt and its engine."""
    from forge_tpu_torch.pipeline import processing as tproc

    (_, teng), (_, thr) = engines["sd15"], engines["hr"]

    def run(**fields):
        return _run(tproc, teng, thr, "sd15", fields).images[0]

    base = run()
    assert base.shape == (128, 128, 3)
    assert np.array_equal(base, run())  # the same seed twice
    for fields in (dict(hr_upscaler="Latent (bicubic)"), dict(hr_upscaler="Lanczos"),
                   dict(hr_prompt="a red castle"), dict(hr_engine=True),
                   dict(hr_denoising_strength=0.3), dict(seed=2)):
        assert not np.array_equal(base, run(**fields)), fields
    first = tproc.process_images(teng, tproc.Processing(**dict(SD15, enable_hr=False)))
    assert first.images[0].shape == (64, 64, 3) and "hires_sample" not in first.timings


def test_hires_checkpoint_needs_a_resolver(engines, monkeypatch):
    from forge_tpu_torch.pipeline import processing as tproc

    (_, teng), (_, thr) = engines["sd15"], engines["hr"]
    with pytest.raises(ValueError, match="no engine resolver"):
        tproc.process_images(teng, tproc.Processing(**SD15, hr_checkpoint_name="other"))
    monkeypatch.setattr(tproc, "ENGINE_RESOLVER", {"other": thr}.__getitem__)
    by_name = tproc.process_images(teng, tproc.Processing(**SD15, hr_checkpoint_name="other"))
    p = tproc.Processing(**SD15)
    p._hr_engine = thr
    assert np.array_equal(by_name.images[0], tproc.process_images(teng, p).images[0])

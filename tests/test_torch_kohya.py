"""Kohya HRFix / Deep Shrink (extensions/kohya_hrfix.py) against forge_tpu
(CPU, f32): the hooks on one tiny SDXL UNet forward at every downscale and
upscale method (ops/resize.py against `jax.image.resize`, the antialiased
downscale included), before and after the skip, at a factor that does not
divide; then `attach`'s hook phases through both `process_images` on the
tiny SDXL (DPM++ 2M Karras) and SD1.5 (Euler a), PSNR ≥ 80 dB with the
reference's infotexts."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_block_patches import _run, _unet_sd  # noqa: E402
from test_torch_sdxl import _assert_close  # noqa: E402
from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice,  # noqa: E402
                                  processing, run_both, sd15_engines, sdxl_engines)

METHODS = ["bicubic", "bilinear", "bislerp", "nearest-exact", "area", "nearest"]


@pytest.fixture(scope="module")
def unet_trees():
    return _unet_sd()


@pytest.mark.parametrize("kw", [
    *[dict(downscale_method=m, upscale_method="bicubic") for m in METHODS],
    *[dict(downscale_method="bilinear", upscale_method=m) for m in METHODS],
    dict(block_number=1, downscale_after_skip=False),
    dict(block_number=1, downscale_factor=1.5, downscale_method="nearest"),
    dict(block_number=0, downscale_factor=3.0, upscale_method="area"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_kohya_hooks_match(unet_trees, kw):
    from forge_tpu.extensions.kohya_hrfix import build_kohya_hooks as jbuild
    from forge_tpu_torch.extensions.kohya_hrfix import build_kohya_hooks

    got, want = _run(unet_trees, jbuild(**kw), build_kohya_hooks(**kw))
    _assert_close(got, want)
    plain, _ = _run(unet_trees, None, None)
    assert not np.allclose(got, plain)


@pytest.fixture(scope="module")
def engines():
    return {"sdxl": sdxl_engines(), "sd15": sd15_engines()}


SLICES = {
    "sdxl, Forge's defaults": ("sdxl", dict(steps=4), {}),
    "sdxl, from 0.2 to 0.6, nearest down, bilinear up": (
        "sdxl", dict(steps=5), dict(start_percent=0.2, end_percent=0.6,
                                    downscale_method="nearest-exact", upscale_method="bilinear")),
    "sd15, block 1 x1.5 before the skip": (
        "sd15", dict(steps=4), dict(block_number=1, downscale_factor=1.5,
                                    downscale_after_skip=False, end_percent=0.5)),
}


@pytest.mark.parametrize("case", list(SLICES))
def test_kohya_slice_matches_forge_tpu(engines, case):
    model, fields, args = SLICES[case]
    request = dict(SDXL_REQUEST if model == "sdxl" else SD15_REQUEST, **fields)

    def attach(package, p):
        import importlib

        importlib.import_module(f"{package}.extensions.kohya_hrfix").attach(p, args)

    got, want, tp = run_both(engines[model], request, attach)
    print(case, assert_slice(got, want))
    assert "Kohya HRFix" in tp.extra_generation_params
    tproc = processing("forge_tpu_torch")
    plain = tproc.process_images(engines[model][1], tproc.Processing(**request))
    assert not np.array_equal(got.images[0], plain.images[0])

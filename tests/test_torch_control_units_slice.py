"""ControlNet units through both `process_images` (CPU, f32, PSNR ≥ 80 dB
with the reference's infotexts): a Control-LoRA unit on the tiny SDXL and
SD1.5, a cldm "canny" unit on the tiny SD1.5, "inpaint_global_harmonious"
on an img2img inpaint and on txt2img, and "inpaint_only" on txt2img (the latent composite
each step, the final composite), with a hires pass (the composite skipped
at the other size), on img2img with and without an inpaint mask (its
composite before the inpaint paste), on "only masked" inpainting (after
the paste) and without a model. The units' parts are held one by one in
tests/test_torch_control_units.py."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_control_units import _save, control_lora_sd  # noqa: E402
from test_torch_controlnet import tiny_controlnet_sd  # noqa: E402
from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice,  # noqa: E402
                                  init_and_mask, processing, run_both, sd15_engines,
                                  sdxl_engines)


@pytest.fixture(scope="module")
def engines():
    return {"sdxl": sdxl_engines(), "sd15": sd15_engines()}


@pytest.fixture(scope="module")
def model_dir(engines, tmp_path_factory):
    from test_controlnet import make_cldm_sd  # the tiny SD1.5's encoder as a cldm

    d = tmp_path_factory.mktemp("ControlNet")
    _save(tiny_controlnet_sd(seed=23), d / "cldm_tiny_xl.safetensors")
    _save(make_cldm_sd(seed=9), d / "cldm_tiny_sd15.safetensors")
    _save(control_lora_sd(engines["sdxl"][1].loaded.unet, rank=8),
          d / "control_lora_tiny.safetensors")
    _save(control_lora_sd(engines["sd15"][1].loaded.unet, rank=8, seed=22),
          d / "control_lora_tiny_sd15.safetensors")
    return str(d)


def _unit_image(size=64):
    init, mask = init_and_mask(size, seed=5)
    img = init.copy()
    img[20:44, 8:30] = 250
    return img, (mask * 255).astype(np.uint8)


CASES = {  # name: (model, the request's fields, the unit)
    "Control-LoRA canny, sdxl": ("sdxl", {}, dict(module="canny", model="control_lora_tiny",
                                                  weight=1.3)),
    "Control-LoRA none, sd15": ("sd15", {}, dict(module="none", model="control_lora_tiny_sd15",
                                                 processor_res=32)),
    "cldm canny, sd15": ("sd15", {}, dict(module="canny", model="cldm_tiny_sd15", weight=1.5,
                                          guidance_end=0.7)),
    "inpaint_global_harmonious, sd15 txt2img": (
        "sd15", {}, dict(module="inpaint_global_harmonious", model="cldm_tiny_sd15")),
    "inpaint_only, sd15 img2img inpaint": ("sd15", dict(inpaint=True, denoising_strength=0.8),
                                           dict(module="inpaint_only", model="cldm_tiny_sd15")),
    "inpaint_global_harmonious, img2img inpaint": (
        "sdxl", dict(inpaint=True, denoising_strength=0.75),
        dict(module="inpaint_global_harmonious", model="cldm_tiny_xl", weight=1.2)),
    "inpaint_only, txt2img": ("sdxl", {}, dict(module="inpaint_only", model="cldm_tiny_xl")),
    "inpaint_only, txt2img with a hires pass": (
        "sdxl", dict(enable_hr=True, hr_scale=1.5, hr_denoising_strength=0.6),
        dict(module="inpaint_only", model="cldm_tiny_xl")),
    "inpaint_only, img2img": ("sdxl", dict(init=True, denoising_strength=0.7),
                              dict(module="inpaint_only", model="cldm_tiny_xl")),
    "inpaint_only, img2img inpaint": ("sdxl", dict(inpaint=True, denoising_strength=0.9),
                                      dict(module="inpaint_only", model="cldm_tiny_xl")),
    "inpaint_only, only masked": ("sdxl", dict(inpaint=True, inpaint_full_res=True,
                                               inpaint_full_res_padding=8),
                                  dict(module="inpaint_only", model="cldm_tiny_xl")),
    "inpaint_only without a model, sd15": ("sd15", {}, dict(module="inpaint_only")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unit_request_matches_forge_tpu(engines, model_dir, case):
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu_torch.extensions import controlnet as tcn

    model, fields, unit = CASES[case]
    img, mask = _unit_image()
    request = dict(SDXL_REQUEST if model == "sdxl" else SD15_REQUEST)
    request.update((k, v) for k, v in fields.items() if k not in ("init", "inpaint"))
    if fields.get("init") or fields.get("inpaint"):
        init, _ = init_and_mask(64, seed=8)
        request["init_images"] = [init]
    if fields.get("inpaint"):
        request["inpaint_mask"] = mask
    unit = dict(unit, image=img, mask=mask)

    def attach(package, p):
        ext = jcn if package == "forge_tpu" else tcn
        ext.set_model_dirs([model_dir])
        kw = {} if package == "forge_tpu" else {"device": "cpu"}
        assert ext.attach_units(p, [unit], **kw) == 1

    try:
        got, want, tp = run_both(engines[model], request, attach)
    finally:
        for ext in (jcn, tcn):
            ext.set_model_dirs(["models/ControlNet", "models/controlnet"])
            ext._MODEL_CACHE.clear()
    print(case, assert_slice(got, want))
    tproc = processing("forge_tpu_torch")
    plain = tproc.process_images(engines[model][1], tproc.Processing(**request))
    assert not np.array_equal(got.images[0], plain.images[0])
    if unit["module"] == "inpaint_only" and not fields.get("inpaint"):
        # the final composite keeps the source outside the feathered mask
        from forge_tpu_torch.pipeline.cn_inpaint import feather_mask

        size = got.images[0].shape[:2]
        keep = feather_mask(tp._cn_inpaint["mask"]) == 0
        if size == keep.shape:
            src = np.clip(tp._cn_inpaint["image"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            assert keep.any() and np.array_equal(got.images[0][keep], src[keep])

"""The port's img2img slice end to end against forge_tpu: config 3 in small.

The tiny SDXL checkpoint of tests/test_torch_sdxl.py, a tiny LoRA over its
UNet attention and both text towers (written by the port's safetensors
writer, read by each package's registry), and a tiny SDXL-geometry
ControlNet-canny whose hint is `canny` of the init image, through
`process_images` in both packages (f32 on the CPU): img2img; inpainting
with the "original" and "latent noise" fills; "only masked" inpainting.
64² DPM++ 2M Karras, 5 steps at strength 0.6 (4 model calls), CFG 7,
seed 1. The uint8 images must reach PSNR ≥ 40 dB against each other, the
bar of tests/test_golden_parity.py; pixels the blurred mask does not reach
equal the init image's. This file holds img2img and the "original" fill;
tests/test_torch_img2img_inpaint.py the "latent noise" fill and "only
masked"; the request, fixtures and check are tests/torch_img2img_cases.py's.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import pytest

torch = pytest.importorskip("torch")

from test_torch_sdxl import _psnr  # noqa: E402
from torch_img2img_cases import (_request, check_img2img_slice_matches_forge_tpu,  # noqa: E402
                                 make_setup)

FILE_CASES = ["img2img", "inpaint original"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory)


@pytest.mark.parametrize("case", FILE_CASES)
def test_img2img_slice_matches_forge_tpu(setup, case):
    check_img2img_slice_matches_forge_tpu(setup, case)


def test_lora_and_controlnet_change_the_image(setup):
    """The LoRA and the ControlNet each move the result (the test above
    would pass with either left out if both packages left it out), and the
    engine's weights are unchanged after a LoRA request."""
    from forge_tpu_torch.models import controlnet as tcn_mod
    from forge_tpu_torch.pipeline import processing as tproc

    _, teng, _, tcn, init, hint = setup
    w = teng.loaded.unet["input_blocks"]["3"]["1"]["transformer_blocks"]["0"]["attn1"]["to_q"]["weight"]
    w0 = w.clone()
    thint = torch.from_numpy(hint.transpose(0, 3, 1, 2))
    base = tproc.process_images(teng, _request(tproc, tcn_mod, tcn, thint, init, "img2img")).images[0]
    p = _request(tproc, tcn_mod, tcn, thint, init, "img2img")
    p.prompt = "a castle on a hill"
    no_lora = tproc.process_images(teng, p).images[0]
    p = _request(tproc, tcn_mod, tcn, thint, init, "img2img")
    p.controlnets = None
    no_cn = tproc.process_images(teng, p).images[0]
    assert _psnr(base, no_lora) < 60 and _psnr(base, no_cn) < 60
    assert torch.equal(w, w0)
    assert teng.loaded.unet["input_blocks"]["3"]["1"]["transformer_blocks"]["0"]["attn1"]["to_q"][
        "weight"] is w

"""The port's img2img slice against forge_tpu: the "latent noise" fill and
"only masked" inpainting (split from tests/test_torch_img2img_slice.py, which
holds img2img and the "original" fill; the request, fixtures and check are
tests/torch_img2img_cases.py's), then the port's own checks: "only masked"
with an inverted mask, and prompt features with a LoRA tag on img2img.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_img2img_cases import (SIZE, _request,  # noqa: E402
                                 check_img2img_slice_matches_forge_tpu, make_setup)

FILE_CASES = ["inpaint latent noise", "only masked"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory)


@pytest.mark.parametrize("case", FILE_CASES)
def test_img2img_slice_matches_forge_tpu(setup, case):
    check_img2img_slice_matches_forge_tpu(setup, case)


def test_only_masked_inverts_the_mask_once(setup):
    """"Only masked" with `inpainting_mask_invert` repaints what the inverted
    mask marks: the same image as the inverted mask given outright. The
    reference inverts the crop's mask a second time (its
    processing.py:1619 passes the flag on with the already inverted crop)."""
    from forge_tpu_torch.models import controlnet as tcn_mod
    from forge_tpu_torch.pipeline import processing as tproc

    _, teng, _, tcn, init, hint = setup
    thint = torch.from_numpy(hint.transpose(0, 3, 1, 2))
    inverted = _request(tproc, tcn_mod, tcn, thint, init, "only masked")
    inverted.inpaint_mask = 1.0 - inverted.inpaint_mask
    inverted.inpainting_mask_invert = True
    plain = _request(tproc, tcn_mod, tcn, thint, init, "only masked")
    got = tproc.process_images(teng, inverted).images[0]
    assert np.array_equal(got, tproc.process_images(teng, plain).images[0])


def test_prompt_features_not_ported_still_raise(setup):
    """Prompt editing and AND run now, beside a LoRA tag (its hash in the
    infotext), on img2img too; in the prompt a hires pass encodes for
    itself they still raise (the reference encodes them as literal text)."""
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts

    teng, init = setup[1], setup[4]
    with opts.override({"save_write_params_txt": False}):
        for prompt in ("a [cat:dog:0.5] <lora:tiny:0.8>", "a cat AND a dog"):
            for fields in ({}, dict(init_images=[init], denoising_strength=0.6)):
                res = tproc.process_images(teng, tproc.Processing(
                    prompt=prompt, seed=1, steps=2, width=SIZE, height=SIZE, **fields))
                assert res.images[0].shape == (SIZE, SIZE, 3)
                assert ('Lora hashes: "tiny: ' in res.infotexts[0]) == ("lora" in prompt)
        with pytest.raises(NotImplementedError, match="not ported"):
            tproc.process_images(teng, tproc.Processing(
                prompt="a cat", hr_prompt="a [cat:dog:0.5]", enable_hr=True, steps=2,
                width=SIZE, height=SIZE))

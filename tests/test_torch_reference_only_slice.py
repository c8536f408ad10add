"""Reference-only and reference-adain through both packages' process_images (CPU, f32).

The tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M Karras, 3 steps,
CFG 7) with a ControlNet unit of each reference module at weight 1.5 (the
channel gates open on the tiny UNet's 32- and 64-channel blocks) and style
fidelity 0.5 (cubed on SDXL), attached by each package's `attach_units`:
the images at the slice bar (80 dB) with equal infotexts, and each unlike
the request without the unit. Also a second-order sampler (Heun, 4 steps)
with the guidance window 0.3–0.8, whose second model call of a step lands on
the next step's index; reference-only at CFG 1 (the cond rows alone); the
tiny SD1.5; and the combinations the port refuses.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice,  # noqa: E402
                                  processing, run_both, sd15_engines, sdxl_engines)
from torch_image_prompt_cases import REF_WEIGHT, photo  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


def _unit(module, **kw):
    return {"module": module, "image": photo(80, 72, 7), "weight": REF_WEIGHT,
            "threshold_a": 0.5, **kw}


def _attach(*units):
    def attach(package, p):
        importlib.import_module(f"{package}.extensions.controlnet").attach_units(p, list(units))

    return attach


def _plain(engine, fields):
    return processing("forge_tpu_torch").process_images(
        engine, processing("forge_tpu_torch").Processing(**fields)).images


@pytest.mark.parametrize("module", ["reference_only", "reference_adain", "reference_adain+attn"])
def test_reference_request_matches_forge_tpu(engines, module):
    got, want, p = run_both(engines, SDXL_REQUEST, _attach(_unit(module)))
    print(module, assert_slice(got, want))
    assert p.reference_state.use_attn == (module != "reference_adain")
    assert p.reference_state.style_fidelity == pytest.approx(0.125)  # 0.5 cubed on SDXL
    assert "Reference: " + module in got.infotexts[0]
    assert not np.array_equal(got.images[0], _plain(engines[1], SDXL_REQUEST)[0])


def test_reference_window_on_a_second_order_sampler(engines):
    """Heun evaluates twice a step, the second time at the next step's σ.
    The window 0.3–0.8 of 4 steps holds steps 1 and 2 (index fractions 0,
    ⅓, ⅔, 1), so step 0's second call, at σ₁, takes both passes and step
    2's, at σ₃, one: the step index of each σ decides, as in the reference."""
    fields = dict(SDXL_REQUEST, sampler_name="Heun", steps=4)
    got, want, _ = run_both(engines, fields, _attach(_unit("reference_only", guidance_start=0.3,
                                                           guidance_end=0.8)))
    print("Heun, window 0.3-0.8", assert_slice(got, want))
    whole = run_both(engines, fields, _attach(_unit("reference_only")))[0]
    assert not np.array_equal(got.images[0], whole.images[0])


def test_reference_at_cfg_1_matches_forge_tpu(engines):
    """CFG 1 skips the uncond: every row attends over the joined keys."""
    got, want, _ = run_both(engines, dict(SDXL_REQUEST, cfg_scale=1.0),
                            _attach(_unit("reference_adain+attn")))
    print("CFG 1", assert_slice(got, want))


def test_reference_on_sd15_matches_forge_tpu():
    """SD1.5 keeps the unit's style fidelity (no cube)."""
    got, want, p = run_both(sd15_engines(), SD15_REQUEST, _attach(_unit("reference_only")))
    print("SD1.5", assert_slice(got, want))
    assert p.reference_state.style_fidelity == 0.5


@pytest.mark.parametrize("fields,what", [
    (dict(enable_hr=True, hr_scale=1.5), "the hires fix"),
    (dict(prompt="a cat AND a hat"), "AND or regional"),
    (dict(prompt="a [cat:dog:2]"), "prompt editing"),
    (dict(tiled_diffusion={"tile": 4, "overlap": 2}), "tiled diffusion"),
    (dict(init_images=[photo(64, 64, 1)], denoising_strength=0.5), "img2img"),
])
def test_reference_refused_combinations(engines, fields, what):
    """Each raises before the first denoise, naming ROADMAP 6 (d)."""
    proc = processing("forge_tpu_torch")
    p = proc.Processing(**dict(SDXL_REQUEST, **fields))
    _attach(_unit("reference_only"))("forge_tpu_torch", p)
    with pytest.raises(NotImplementedError, match=f"reference_state with {what}.*6 \\(d\\)"):
        proc.process_images(engines[1], p)


def test_reference_refused_with_hook_phases(engines):
    from forge_tpu_torch.extensions import kohya_hrfix

    proc = processing("forge_tpu_torch")
    p = proc.Processing(**SDXL_REQUEST)
    _attach(_unit("reference_only"))("forge_tpu_torch", p)
    kohya_hrfix.attach(p, {"block_number": 1})
    with pytest.raises(NotImplementedError, match="hook phases"):
        proc.process_images(engines[1], p)

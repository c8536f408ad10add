"""The port's hires fix end to end against forge_tpu: config 2's second pass in small.

A tiny SD1.5 (tests/fixtures.py `make_sd15_checkpoint(0)`; 64², Euler a, 3
steps, CFG 7) and the tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M
Karras, 3 steps) through `process_images` in both packages (f32 on the
CPU) with the hires fix. This file holds the latent modes ("Latent",
"Latent (bicubic)", "Latent (nearest)"), an explicit target
(`hr_resize_x/y`, a non-integer scale), `hr_second_pass_steps`,
`hr_cfg_scale`, `hr_prompt` and `hr_negative_prompt`;
tests/test_torch_hires_pixel.py the pixel mode through Lanczos and through a
tiny ESRGAN (tests/test_torch_upscalers.py's, from each package's registry),
and another checkpoint for the second pass (`_hr_engine`). The cases and
their check are tests/torch_hires_cases.py's. The uint8 images must reach
PSNR ≥ 40 dB against each other, the bar of tests/test_golden_parity.py.
tests/test_torch_hires_fields.py holds the port's own checks of the same
fields.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import pytest

torch = pytest.importorskip("torch")

from torch_hires_cases import check_hires_matches_forge_tpu, make_engines  # noqa: E402

FILE_CASES = ["sd15 latent", "sd15 latent bicubic, steps, cfg",
              "sd15 latent nearest, resize to 96x80", "sdxl latent, hr prompts"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory, ("sd15", "sdxl"))


@pytest.mark.parametrize("case", FILE_CASES)
def test_hires_matches_forge_tpu(engines, case):
    check_hires_matches_forge_tpu(engines, case)

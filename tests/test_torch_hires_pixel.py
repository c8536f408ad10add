"""The port's hires fix against forge_tpu in its pixel modes and with another
checkpoint for the second pass (split from tests/test_torch_hires.py, which
holds the latent modes; the cases and their check are
tests/torch_hires_cases.py's): Lanczos, a tiny ESRGAN (tests/test_torch_upscalers.py's,
import torch_threads  # noqa: F401  (one torch thread a test process)
from each package's registry) on the tiny SD1.5 and the tiny SDXL with an
explicit target, and `_hr_engine` with `hr_prompt` and `hr_cfg_scale`.
The uint8 images must reach PSNR ≥ 40 dB against each other.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_hires_cases import check_hires_matches_forge_tpu, make_engines  # noqa: E402

FILE_CASES = ["sd15 lanczos", "sd15 esrgan", "sd15 hr engine, hr prompt",
              "sdxl esrgan, resize to 112x96"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory, ("sd15", "sdxl", "hr"))


@pytest.mark.parametrize("case", FILE_CASES)
def test_hires_matches_forge_tpu(engines, case):
    check_hires_matches_forge_tpu(engines, case)

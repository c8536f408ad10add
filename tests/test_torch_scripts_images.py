"""The host image work of the script surface (forge_tpu_torch/pipeline/
images.py) against forge_tpu's and OpenCV's (CPU).

`rgb_to_lab` and `lab_to_rgb` give `cv2.cvtColor`'s bytes for every one of
the 2^24 inputs (COLOR_RGB2LAB, COLOR_LAB2RGB); colour correction
(`setup_color_correction`, `apply_color_correction`) equals forge_tpu's,
which converts with cv2, byte for byte on seeded images and on a full RGB
ramp; `_match_histogram_channel` and `image_grid` equal forge_tpu's.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


def _all_triples():
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


@pytest.mark.parametrize("direction", ["rgb_to_lab", "lab_to_rgb"])
def test_lab_conversion_is_opencvs_on_every_input(direction):
    from forge_tpu_torch.pipeline import images

    triples = _all_triples()
    code = cv2.COLOR_RGB2LAB if direction == "rgb_to_lab" else cv2.COLOR_LAB2RGB
    assert np.array_equal(getattr(images, direction)(triples), cv2.cvtColor(triples, code))


@pytest.mark.parametrize("case", ["seeded", "dark", "ramp"])
def test_color_correction_matches_forge_tpu(case):
    from forge_tpu.pipeline import images as jimages
    from forge_tpu_torch.pipeline import images

    rng = np.random.default_rng(7)
    if case == "ramp":
        init = _all_triples()  # the full RGB ramp
        image = np.ascontiguousarray(init[::-1, ::-1])
    else:
        init = rng.integers(0, 256, (96, 64, 3), dtype=np.uint8)
        image = rng.integers(0, 256, (96, 64, 3), dtype=np.uint8)
        if case == "dark":
            image //= 5
    want_target = jimages.setup_color_correction(init)
    target = images.setup_color_correction(init)
    assert np.array_equal(target, want_target)
    want = jimages.apply_color_correction(want_target, image)
    got = images.apply_color_correction(target, image)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_match_histogram_channel_and_grid_match_forge_tpu():
    from forge_tpu.pipeline import images as jimages
    from forge_tpu_torch.pipeline import images

    rng = np.random.default_rng(3)
    src = rng.integers(0, 200, (40, 30)).astype(np.uint8)
    tgt = rng.integers(50, 256, (20, 50)).astype(np.uint8)
    assert np.array_equal(images._match_histogram_channel(src, tgt),
                          jimages._match_histogram_channel(src, tgt))
    cells = [rng.integers(0, 256, (8, 12, 3), dtype=np.uint8) for _ in range(5)]
    for rows, margin in ((None, 0), (2, 0), (1, 3), (3, 2)):
        assert np.array_equal(images.image_grid(cells, rows=rows, margin=margin),
                              jimages.image_grid(cells, rows=rows, margin=margin))

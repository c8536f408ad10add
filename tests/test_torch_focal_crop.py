"""The port's focal crop (forge_tpu_torch/postprocessing/focal_crop.py)
against forge_tpu's on the CPU: `focal_point` and `focal_crop` on seeded
images of several sizes under several weight sets (edges, entropy, the
face weight) give forge_tpu's point and the same pixels. OpenCV's RGB2GRAY,
5×5 GaussianBlur, Laplacian and the σ blur of the score run in numpy
(preprocessors/cv2_np.py). forge_tpu's face term needs OpenCV's Haar
cascade data, which this OpenCV does not carry: both packages leave the
face term out (the port always), so the face weight moves nothing on
either side. The extras route's focal crop is in
tests/test_torch_extras_api.py.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from torch_annotator_cases import image  # noqa: E402

WEIGHTS = [(0.9, 0.15, 0.5), (0.0, 1.0, 0.0), (0.5, 0.0, 1.0), (0.9, 0.3, 0.2)]


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("seed,h,w", [(0, 96, 128), (1, 130, 90), (2, 64, 200), (3, 257, 255),
                                      (4, 40, 40)])
def test_focal_point_and_crop_match_reference(seed, h, w):
    from forge_tpu.postprocessing import focal_crop as ref
    from forge_tpu_torch.postprocessing import focal_crop

    img = image(seed, h, w)
    for weights in WEIGHTS:
        point = focal_crop.focal_point(img, *weights)
        assert point == ref.focal_point(img, *weights), weights
        for tw, th in ((w // 2, h // 2), (w, h // 3), (w + 10, h - 1)):
            got = focal_crop.focal_crop(img, tw, th, *weights)
            assert got.shape == (min(th, h), min(tw, w), 3)
            assert np.array_equal(got, ref.focal_crop(img, tw, th, *weights))


def test_face_term_is_left_out_on_both_sides():
    from forge_tpu.postprocessing import focal_crop as ref
    from forge_tpu_torch.postprocessing import focal_crop

    img = image(9, 120, 160)
    assert focal_crop._face_map(img) is None and ref._face_map(img) is None
    assert focal_crop.focal_point(img, 0.0, 0.15, 0.5) == focal_crop.focal_point(img, 5.0, 0.15, 0.5)


def test_maps_match_reference():
    from forge_tpu.postprocessing import focal_crop as ref
    from forge_tpu_torch.postprocessing import focal_crop

    gray = cv2.cvtColor(image(5, 100, 150), cv2.COLOR_RGB2GRAY)
    assert np.array_equal(focal_crop._edge_map(gray), ref._edge_map(gray))
    assert np.array_equal(focal_crop._entropy_map(gray), ref._entropy_map(gray))

"""The port's face-restoration frame (forge_tpu_torch/postprocessing/faces.py)
and its rebuild of OpenCV's INTER_LINEAR resize (pipeline/images.py
`cv2_linear_resize`), against cv2 and forge_tpu (CPU).

The card's machine has no OpenCV, and the reference resizes every face crop
with `cv2.resize(..., INTER_LINEAR)`: the rebuild is byte-equal to the
installed cv2 on seeded uint8 images up and down (1024 → 512 takes OpenCV's
fast area path, 512 → 1024 and the rest the fixed-point path), gray and
RGB, and within 1e-6 of the largest value on float32. `_square_expand` and
`_feather_mask` equal forge_tpu's; `restore_faces_in_image` with one
`restore_fn` on both sides gives forge_tpu's bytes (the truncating uint8
cast of the restored crop kept). A detector file under
models/facedetection raises NotImplementedError in the port, where the
reference would run it through OpenCV.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

RESIZES = [((64, 64), (512, 512)), ((1024, 1024), (512, 512)), ((512, 512), (1024, 1024)),
           ((37, 53), (512, 512)), ((512, 512), (37, 53)), ((100, 80), (33, 71)),
           ((7, 9), (16, 5)), ((300, 300), (512, 512)), ((512, 512), (300, 300)),
           ((33, 33), (16, 16)), ((5, 5), (3, 3)), ((512, 512), (511, 511)),
           ((640, 480), (1000, 700)), ((512, 512), (64, 64)), ((96, 96), (96, 96))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_linear_resize_is_cv2s(src, dst):
    from forge_tpu_torch.pipeline.images import cv2_linear_resize

    rng = np.random.default_rng(src[0] * 7 + dst[1])
    for shape in (src + (3,), src):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = cv2_linear_resize(img, dst[1], dst[0])
        assert got.dtype == np.uint8 and np.array_equal(got, want), shape
        imgf = rng.uniform(0, 255, shape).astype(np.float32)
        want = cv2.resize(imgf, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = cv2_linear_resize(imgf, dst[1], dst[0])
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_square_expand_and_feather_match_reference():
    from forge_tpu.postprocessing import faces as ref
    from forge_tpu_torch.postprocessing import faces as port

    for box, h, w in (((10, 20, 30, 40), 100, 80), ((0, 0, 64, 64), 64, 64),
                      ((70, 5, 20, 20), 90, 90), ((0, 0, 512, 512), 512, 768)):
        assert port._square_expand(box, h, w) == ref._square_expand(box, h, w)
    for size in (1, 7, 64, 512, 1024):
        assert np.array_equal(port._feather_mask(size), ref._feather_mask(size))


@pytest.mark.parametrize("shape", [(64, 64), (96, 64), (50, 120), (1024, 1024)])
def test_restore_faces_in_image_matches_reference(shape):
    """The full-frame box, the crop to 512², one restore_fn (a float result
    the uint8 cast truncates), the paste back: forge_tpu's bytes."""
    from forge_tpu.postprocessing import faces as ref
    from forge_tpu_torch.postprocessing import faces as port

    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    calls = []

    def restore_fn(crop):
        calls.append(crop.shape)
        return 255.0 - crop.astype(np.float32) * 0.8 + 0.7

    assert port.detect_faces(img) == ref.detect_faces(img)
    want = ref.restore_faces_in_image(img, restore_fn)
    got = port.restore_faces_in_image(img, restore_fn)
    assert calls == [(512, 512, 3)] * 2
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["face_detection_yunet_2023mar.onnx",
                                  "haarcascade_frontalface_default.xml"])
def test_detector_file_raises(tmp_path, monkeypatch, name):
    from forge_tpu_torch.postprocessing import faces

    monkeypatch.chdir(tmp_path)
    img = np.zeros((32, 32, 3), np.uint8)
    assert faces.detect_faces(img) == [(0, 0, 32, 32)]
    (tmp_path / "models" / "facedetection").mkdir(parents=True)
    (tmp_path / "models" / "facedetection" / name).write_bytes(b"\0")
    with pytest.raises(NotImplementedError, match="item 9"):
        faces.detect_faces(img)
    with pytest.raises(NotImplementedError, match=name):
        faces.restore_faces_in_image(img, lambda crop: crop)

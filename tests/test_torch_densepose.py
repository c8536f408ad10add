"""The port's DensePose (forge_tpu_torch/preprocessors/densepose.py) and
OpenCV's two colour maps (preprocessors/cv2_np.py `apply_color_map`)
against forge_tpu's and cv2's on the CPU, f32, on a small R50-FPN DeepLab
in detectron2's key space (tests/torch_spaces_cases.py).

Both colour maps equal `cv2.applyColorMap` on all 256 levels (cv2 the
oracle only). The host parts equal forge_tpu's on seeded inputs: the
anchors, the delta decode, the NMS indices, `paint_iuv` (both maps, labels
past the canvas) and `_labels_for_box`. The network's parts agree within
1e-4 of the largest reference value: the ResNet-FPN pyramid, the RPN
heads, ROIAlign on each level and across levels, the box head and the
DeepLab head. Both registry entries read their file and give forge_tpu's
hint pixel for pixel, their boxes within 1e-3 px of forge_tpu's. A missing checkpoint raises
forge_tpu's RuntimeError text.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from torch_spaces_cases import (image, nchw, nhwc, port_tree, reference_tree, rel_err,  # noqa: E402
                                tiny_sd, write)

TOL = 1e-4
CANVAS_IMAGE = (3, 120, 160)  # the seeded image (seed, h, w) the network tests feed


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("name,code", [("viridis", "COLORMAP_VIRIDIS"),
                                       ("parula", "COLORMAP_PARULA")])
def test_color_maps_equal_cv2(name, code):
    from forge_tpu_torch.preprocessors import cv2_np

    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(cv2_np.apply_color_map(levels, name),
                          cv2.applyColorMap(levels, getattr(cv2, code)))
    img = np.random.default_rng(1).integers(0, 256, (33, 47), dtype=np.uint8)
    assert np.array_equal(cv2_np.apply_color_map(img, name),
                          cv2.applyColorMap(img, getattr(cv2, code)))


@pytest.mark.parametrize("h,w,stride,size", [(5, 7, 4, 32), (13, 9, 16, 128), (1, 2, 64, 512)])
def test_anchors_equal_reference(h, w, stride, size):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    got = densepose._anchors_for(h, w, stride, size)
    assert got.shape == (h * w * 3, 4) and np.array_equal(got, ref._anchors_for(h, w, stride, size))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_nms_equal_reference(seed):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    rng = np.random.default_rng(seed)
    anchors = densepose._anchors_for(6, 6, 16, 64)
    deltas = (rng.standard_normal(anchors.shape) * 0.2).astype(np.float32)
    boxes = densepose._decode(anchors, deltas)
    assert np.array_equal(boxes, ref._decode(anchors, deltas))
    scores = rng.random(len(boxes)).astype(np.float32)
    for t in (0.3, 0.5, 0.7):
        keep = densepose._nms(boxes, scores, t)
        assert keep == ref._nms(boxes, scores, t) and 0 < len(keep) < len(boxes)


@pytest.mark.parametrize("cmap", ["viridis", "parula"])
def test_paint_iuv_equal_reference(cmap):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    rng = np.random.default_rng(4)
    for box in ((5, 7, 30, 20), (40, 30, 50, 50), (-3, 2, 10, 10)):
        labels = rng.integers(0, 25, (box[3], box[2]))
        canvas = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        want = ref.paint_iuv(canvas.copy(), labels, box, cmap=cmap)
        got = densepose.paint_iuv(canvas.copy(), labels, box, cmap=cmap)
        assert np.array_equal(got, want)


def test_labels_for_box_equal_reference():
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    rng = np.random.default_rng(5)
    coarse = rng.standard_normal((112, 112, 2)).astype(np.float32)
    fine = rng.standard_normal((112, 112, 25)).astype(np.float32)
    for h, w in ((37, 53), (112, 112), (200, 90)):
        assert np.array_equal(densepose._labels_for_box(coarse, fine, h, w),
                              ref._labels_for_box(coarse, fine, h, w))


@pytest.fixture(scope="module")
def nets():
    """(forge_tpu's params, the port's, forge_tpu's pyramid and per-level RPN
    outputs, the port's pyramid) on the seeded image's canvas."""
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    sd = tiny_sd("densepose")
    rp, pp = reference_tree(sd), port_tree(sd)
    img = image(*CANVAS_IMAGE)
    canvas = np.zeros((800, 800, 3), np.float32)
    resized = cv2.resize(img, (800, 600), interpolation=cv2.INTER_LINEAR)
    canvas[:600] = resized[..., ::-1].astype(np.float32) - densepose._PIXEL_MEAN
    det = ref.DensePoseDetector(model_dir="/nonexistent")
    det.load(params=rp)
    per_level, pyramid = det._rpn_jit(jnp.asarray(canvas[None]))
    with torch.no_grad():
        ppyr = densepose._resnet_fpn(pp, nchw(canvas[None]))
    return rp, pp, det, per_level, pyramid, ppyr


def test_resnet_fpn_and_rpn_match_reference(nets):
    from forge_tpu_torch.preprocessors import densepose

    _, pp, _, per_level, pyramid, ppyr = nets
    assert sorted(ppyr) == [2, 3, 4, 5, 6]
    assert [tuple(ppyr[lv].shape[2:]) for lv in (2, 3, 4, 5, 6)] == [
        (200, 200), (100, 100), (50, 50), (25, 25), (13, 13)]
    with torch.no_grad():
        for lv in ppyr:
            assert rel_err(nhwc(ppyr[lv]), np.asarray(pyramid[lv])) < TOL
            logits, deltas = densepose._rpn_level(pp, ppyr[lv])
            assert rel_err(nhwc(logits), np.asarray(per_level[lv][0])) < TOL
            assert rel_err(nhwc(deltas), np.asarray(per_level[lv][1])) < TOL


@pytest.fixture(scope="module")
def boxes():
    """Boxes over the canvas: small and large (every FPN level), one past the edge."""
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 600, (8, 2))
    wh = np.exp(rng.uniform(np.log(12), np.log(700), (8, 2)))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[0] = (780.0, 10.0, 830.0, 40.0)
    return b


@pytest.mark.parametrize("size,level", [(7, 2), (7, 4), (28, 3), (28, 5)])
def test_roi_align_matches_reference(nets, boxes, size, level):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    _, _, _, _, pyramid, ppyr = nets
    want = np.asarray(ref._roi_align(pyramid[level], jnp.asarray(boxes), size, 2 ** level))
    got = densepose._roi_align(ppyr[level], torch.from_numpy(boxes), size, 2 ** level)
    assert tuple(got.shape) == (8, 16, size, size)
    assert rel_err(nhwc(got), want) < 1e-5


def test_box_and_densepose_heads_match_reference(nets, boxes):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    rp, pp, det, _, pyramid, ppyr = nets
    want_probs, want_deltas = [np.asarray(t) for t in det._box_jit(pyramid, jnp.asarray(boxes))]
    with torch.no_grad():
        pooled = densepose._roi_align_multilevel(ppyr, torch.from_numpy(boxes), 7)
        want_pooled = np.asarray(ref._roi_align_multilevel(rp, pyramid, jnp.asarray(boxes), 7))
        assert rel_err(nhwc(pooled), want_pooled) < 1e-5
        probs, deltas = densepose._box_head(pp, pooled)
        assert rel_err(probs.numpy(), want_probs) < TOL
        assert rel_err(deltas.numpy(), want_deltas) < TOL
        heads = densepose._densepose_head(
            pp, densepose._roi_align_multilevel(ppyr, torch.from_numpy(boxes), 28))
    want = [np.asarray(t) for t in det._dense_jit(pyramid, jnp.asarray(boxes))]
    for got, w, c in zip(heads, want, (2, 25, 25, 25)):
        assert tuple(got.shape) == (8, c, 112, 112)
        assert rel_err(nhwc(got), w) < TOL


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    return write(root, "densepose")


@pytest.mark.parametrize("entry,seed,h,w", [
    ("densepose (pruple bg & purple torso)", 3, 120, 160),
    ("densepose_parula (black bg & blue torso)", 8, 160, 112)])
def test_entries_match_reference(models, monkeypatch, entry, seed, h, w):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu.preprocessors import get_preprocessor as ref_entry
    from forge_tpu_torch.preprocessors import PREPROCESSORS, densepose

    reference = ref.DensePoseDetector(model_dir=models)
    port = densepose.DensePoseDetector(model_dir=models, device="cpu")
    monkeypatch.setattr(ref, "_DET", reference)
    monkeypatch.setattr(densepose, "_DETECTOR", port)
    img = image(seed, h, w)
    got = PREPROCESSORS[entry](img, 112, 0, 0)
    want = ref_entry(entry)(img, 112, 0, 0)
    assert PREPROCESSORS[entry].ported and got.shape == want.shape
    assert np.array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) >= 4  # the background and parts
    # the boxes through both second stages, within 1e-3 px
    canvas, logits = np.zeros((800, 800, 3), np.float32), {}
    entry_img = importlib.import_module("forge_tpu_torch.preprocessors.cv").resize_image(img, 112)
    hh, ww = entry_img.shape[:2]
    scale = 800 / max(hh, ww)
    nh, nw = int(round(hh * scale)), int(round(ww * scale))
    canvas[:nh, :nw] = (cv2.resize(entry_img, (nw, nh), interpolation=cv2.INTER_LINEAR)[..., ::-1]
                        .astype(np.float32) - densepose._PIXEL_MEAN)
    per_level, pyramid = reference._rpn_jit(jnp.asarray(canvas[None]))
    want_boxes = reference._proposals_to_boxes(
        {lv: np.asarray(v[0]) for lv, v in per_level.items()},
        {lv: np.asarray(v[1]) for lv, v in per_level.items()}, (nh, nw), pyramid)
    with torch.no_grad():
        ppyr = densepose._resnet_fpn(port.load(), nchw(canvas[None]))
        for lv in ppyr:
            lg, dl = densepose._rpn_level(port.params, ppyr[lv])
            logits[lv] = (lg.permute(0, 2, 3, 1).numpy(), dl.permute(0, 2, 3, 1).numpy())
        got_boxes = port._proposals_to_boxes(port.params, {lv: v[0] for lv, v in logits.items()},
                                             {lv: v[1] for lv, v in logits.items()}, (nh, nw),
                                             ppyr)
    assert got_boxes.shape == want_boxes.shape and len(got_boxes) >= 2
    assert np.abs(got_boxes - want_boxes).max() < 1e-3


def test_missing_checkpoint_raises_reference_error(tmp_path):
    from forge_tpu.preprocessors import densepose as ref
    from forge_tpu_torch.preprocessors import densepose

    img = image(0, 32, 32)
    with pytest.raises(RuntimeError) as want:
        ref.DensePoseDetector(model_dir=str(tmp_path)).detect(img)
    with pytest.raises(RuntimeError) as got:
        densepose.DensePoseDetector(model_dir=str(tmp_path), device="cpu").detect(img)
    assert str(got.value) == str(want.value) == f"no DensePose checkpoint under {tmp_path}"

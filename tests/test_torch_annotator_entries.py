"""The port's model-based registry entries against forge_tpu's on the CPU:
from a uint8 image to the float map, with the tiny networks of
tests/torch_annotator_cases.py written once as files in their detectors'
directories and read by both packages' loaders.

OpenPose's maps are equal byte for byte, as are its peaks' places, the
people's part indices (their scores within 1e-4) and the hand and face
drawings on given keypoints; M-LSD's segments agree within 1e-3 px and its
drawings are equal. Every other map differs from forge_tpu's by at most one
level in at most 0.5 % of its pixels: the networks agree within float
rounding (tests/test_torch_annotator_nets.py), which the maps' min–max
normalization or threshold may carry across a level boundary. A missing
checkpoint raises the reference's RuntimeError naming the directory.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import forge_tpu.preprocessors as ref_registry  # noqa: E402
import forge_tpu_torch.preprocessors as registry  # noqa: E402
from torch_annotator_cases import image, install, write_all  # noqa: E402

SHARE = 0.005  # the most pixels a map may differ in, by one level


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = write_all(str(tmp_path_factory.mktemp("annotators")))
    with install(root):
        yield root


def _levels(m):
    return np.rint(np.asarray(m, np.float64) * 255.0).astype(np.int64)


def _close(name, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    d = np.abs(_levels(got) - _levels(want))
    share = float((d > 0).mean())
    assert d.max() <= 1 and share <= SHARE, (name, int(d.max()), share)
    return share


@pytest.mark.parametrize("name,res,a,b", [
    ("depth_midas", 96, 0, 0), ("depth_anything_v2", 64, 0, 0), ("softedge_hed", 96, 0, 0),
    ("softedge_hedsafe", 96, 0, 0), ("scribble_hed", 96, 0, 0),
    ("softedge_pidinet", 96, 0, 0), ("softedge_pidisafe", 96, 0, 0),
    ("scribble_pidinet", 96, 0, 0), ("softedge_teed", 100, 0, 0), ("softedge_teed", 96, 4, 0),
    ("lineart_realistic", 96, 0, 0), ("lineart_coarse", 96, 0, 0),
    ("lineart_anime", 96, 0, 0), ("lineart_anime_denoise", 100, 0, 0), ("normalbae", 96, 0, 0)])
def test_entry_matches_reference(models, name, res, a, b):
    img = image(1)
    want = ref_registry.PREPROCESSORS[name](img, res, a, b)
    got = registry.PREPROCESSORS[name](img, res, a, b)
    assert registry.PREPROCESSORS[name].ported
    _close(name, got, want)
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1


@pytest.mark.parametrize("name", ["openpose", "openpose_hand", "openpose_face",
                                  "openpose_faceonly", "openpose_full"])
def test_openpose_entries_equal(models, name):
    img = image(2)
    want = ref_registry.PREPROCESSORS[name](img, 96, 0, 0)
    got = registry.PREPROCESSORS[name](img, 96, 0, 0)
    assert got.any() and np.array_equal(got, want)


def test_openpose_body_postprocess_equal(models):
    from forge_tpu.preprocessors import openpose as ref
    from forge_tpu_torch.preprocessors import openpose as port

    img = image(3, 96, 128)
    paf, heat = port.get_openpose().body_maps(img)
    # forge_tpu's maps, the same way (its detect inlined up to the postprocessor)
    import cv2
    import jax.numpy as jnp

    det = ref.get_openpose()
    det.load()
    h, w = img.shape[:2]
    scale = 0.5 * 368 / h
    sh, sw = int(round(h * scale)), int(round(w * scale))
    small = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_LANCZOS4)
    padded = np.pad(small, ((0, (-sh) % 8), (0, (-sw) % 8), (0, 0)), constant_values=128)
    rpaf, rheat = det._jit(det.params, jnp.asarray(padded[None].astype(np.float32) / 256.0 - 0.5))
    rpaf = cv2.resize(np.asarray(rpaf[0], np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    rheat = cv2.resize(np.asarray(rheat[0], np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    assert np.abs(paf - rpaf).max() <= 1e-4 * np.abs(rpaf).max()
    assert np.abs(heat - rheat).max() <= 1e-4 * np.abs(rheat).max()
    peaks, rpeaks = port.find_peaks(heat), ref.find_peaks(rheat)
    assert [[p[:2] for p in part] for part in peaks] == [[p[:2] for p in part] for part in rpeaks]
    assert sum(len(p) for p in peaks) > 0
    cand, subset = port.assemble_people(peaks, port.match_limbs(paf, peaks, h))
    rcand, rsubset = ref.assemble_people(rpeaks, ref.match_limbs(rpaf, rpeaks, h))
    assert subset.shape == rsubset.shape
    assert np.array_equal(subset[:, :18], rsubset[:, :18])
    assert np.allclose(subset[:, 18:], rsubset[:, 18:], rtol=1e-4)
    assert np.array_equal(port.draw_bodypose((h, w), cand, subset),
                          ref.draw_bodypose((h, w), rcand, rsubset))


def test_openpose_synthetic_person_drawn_equal():
    """The postprocessor and the body drawing on a hand-made person (the
    peaks, limbs and canvases of both packages equal)."""
    from forge_tpu.preprocessors import openpose as ref
    from forge_tpu_torch.preprocessors import openpose as port

    h, w = 120, 100
    joints = {0: (50, 20), 1: (50, 40), 2: (35, 40), 3: (30, 60), 4: (28, 80), 5: (65, 40),
              6: (70, 60), 7: (72, 80), 8: (42, 80), 9: (40, 100), 11: (58, 80), 12: (60, 100)}
    heat = np.zeros((h, w, 19), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for part, (x, y) in joints.items():
        heat[:, :, part] = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0)
    paf = np.zeros((h, w, 38), np.float32)
    for (a, b), (mx, my) in zip(port.LIMB_SEQ, port.MAP_IDX):
        if a - 1 in joints and b - 1 in joints:
            (xa, ya), (xb, yb) = joints[a - 1], joints[b - 1]
            v = np.array([xb - xa, yb - ya], np.float32)
            v /= np.linalg.norm(v)
            for t in np.linspace(0, 1, 50):
                x, y = int(round(xa + t * (xb - xa))), int(round(ya + t * (yb - ya)))
                paf[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3, mx - 19] = v[0]
                paf[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3, my - 19] = v[1]
    peaks, rpeaks = port.find_peaks(heat), ref.find_peaks(heat)
    assert peaks == rpeaks
    cand, subset = port.assemble_people(peaks, port.match_limbs(paf, peaks, h))
    rcand, rsubset = ref.assemble_people(rpeaks, ref.match_limbs(paf, rpeaks, h))
    assert len(subset) == 1 and np.array_equal(subset, rsubset)
    canvas = port.draw_bodypose((h, w), cand, subset)
    assert canvas.any() and np.array_equal(canvas, ref.draw_bodypose((h, w), rcand, rsubset))


def test_openpose_hand_and_face_drawn_equal(models):
    """The hand and face nets on boxes from given keypoints: canvases equal."""
    from forge_tpu.preprocessors import openpose as ref
    from forge_tpu_torch.preprocessors import openpose as port

    img = image(4, 160, 160)
    kps = [None] * 18
    kps[0], kps[14], kps[15], kps[16], kps[17] = (80.0, 40.0), (74.0, 34.0), (86.0, 34.0), \
        (66.0, 38.0), (94.0, 38.0)
    kps[2], kps[3], kps[4] = (60.0, 70.0), (50.0, 100.0), (45.0, 125.0)
    kps[5], kps[6], kps[7] = (100.0, 70.0), (110.0, 100.0), (112.0, 128.0)
    det, rdet = port.get_openpose(), ref.get_openpose()
    assert det.hand.available and rdet.hand_available and rdet.face_available
    for fn in ("_detect_hands", "_detect_face"):
        got, want = np.zeros_like(img), np.zeros_like(img)
        getattr(det, fn)(img, kps, got)
        getattr(rdet, fn)(img, kps, want)
        assert got.any() and np.array_equal(got, want), fn


def test_mlsd_segments_and_drawing(models):
    import cv2
    import jax.numpy as jnp

    from forge_tpu.preprocessors import mlsd as ref
    from forge_tpu_torch.preprocessors import mlsd as port

    img = image(5, 96, 128)
    for a, b in ((0, 0), (0.05, 0.02)):
        got = port.get_mlsd().segments(img, a or 0.1, b or 0.1)
        det = ref.get_mlsd()
        det.load()
        if det._jit is None:
            import jax

            det._jit = jax.jit(ref.mlsd_apply)
        resized = cv2.resize(img, (512, 512), interpolation=cv2.INTER_AREA)
        feed = np.concatenate([resized, np.ones((512, 512, 1))], axis=-1).astype(np.float32)
        tp = np.asarray(det._jit(det.params, jnp.asarray(feed[None] / 127.5 - 1.0)))[0]
        want = 2 * ref.decode_lines(tp, 200, 3, float(a or 0.1), float(b or 0.1))
        assert got.shape == want.shape and len(got) > 0
        assert np.abs(got - want).max() < 1e-3
        assert np.array_equal(registry.PREPROCESSORS["mlsd"](img, 96, a, b),
                              ref_registry.PREPROCESSORS["mlsd"](img, 96, a, b))


def test_missing_checkpoint_raises_like_reference(tmp_path):
    from forge_tpu.preprocessors.hed import HedDetector as RefHed
    from forge_tpu_torch.preprocessors.depth_anything import DepthAnythingDetector
    from forge_tpu_torch.preprocessors.hed import HedDetector
    from forge_tpu_torch.preprocessors.pidinet import PidiDetector

    img = image(6, 32, 32)
    empty = str(tmp_path / "none")
    for det, text in ((HedDetector(model_dir=empty, device="cpu"), "no ControlNetHED checkpoint"),
                      (PidiDetector(model_dir=empty, device="cpu"), "no table5_pidinet.pth"),
                      (DepthAnythingDetector(model_dir=empty, device="cpu"),
                       "no depth_anything_v2 checkpoint")):
        assert not det.available
        with pytest.raises(RuntimeError, match=f"{text} under {empty}"):
            det.detect(img)
    with pytest.raises(RuntimeError, match=f"no ControlNetHED checkpoint under {empty}"):
        RefHed(model_dir=empty).detect(img)


def test_registry_ports_forty_entries():
    names = registry.preprocessor_names()
    assert names == ref_registry.preprocessor_names()
    ported = [n for n in names if registry.PREPROCESSORS[n].ported]
    assert len(names) == 52 and len(ported) == 51
    assert sorted(set(names) - set(ported)) == ["dw_openpose_full"]
    for name in set(names) - set(ported):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 9"):
            registry.PREPROCESSORS[name](np.zeros((8, 8, 3), np.uint8), 8, 0, 0)

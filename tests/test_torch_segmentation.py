"""The port's UniFormer and anime-face segmenters and its mediapipe_face
entry (forge_tpu_torch/preprocessors/uniformer.py, anime_face.py,
mediapipe_face.py) against forge_tpu's on the CPU, f32.

UniFormer's four stage maps and the UPerHead logits agree within 1e-4 of
the largest reference value on a small UniFormer (tests/
torch_interrogate_cases.py), the anime face's softmax likewise at its
published widths; through the registry (`seg_ufade20k`, `seg_anime_face`)
each detector reads its file and gives forge_tpu's palette map, equal
pixel for pixel. `mediapipe_face` raises forge_tpu's RuntimeError (mediapipe
cannot be imported here; the port never imports it).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from torch_interrogate_cases import (image, nchw, nhwc, port_tree, reference_tree,  # noqa: E402
                                     rel_err, tiny_sd, write)

TOL = 1e-4


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_uniformer_matches_reference(h, w):
    from forge_tpu.preprocessors import uniformer as ref
    from forge_tpu_torch.preprocessors import uniformer

    sd = tiny_sd("uniformer")
    rp, pp = reference_tree(sd), port_tree(sd)
    x = np.random.default_rng(h).standard_normal((1, h, w, 3)).astype(np.float32)
    want = ref.uniformer_features(rp["backbone"], jnp.asarray(x))
    got = uniformer.uniformer_features(pp["backbone"], nchw(x))
    for g, r in zip(got, want):
        assert rel_err(nhwc(g), np.asarray(r)) < TOL
    logits = uniformer.upernet_apply(pp["decode_head"], got)
    assert logits.shape == (1, 150, h // 4, w // 4)
    assert rel_err(nhwc(logits), np.asarray(ref.upernet_apply(rp["decode_head"], want))) < TOL
    assert np.array_equal(uniformer.segment(pp, nchw(x)).numpy(),
                          np.asarray(ref.segment(rp, jnp.asarray(x))))
    assert np.array_equal(uniformer.ADE20K_PALETTE, ref.ADE20K_PALETTE)


def test_anime_face_matches_reference():
    from forge_tpu.preprocessors import anime_face as ref
    from forge_tpu_torch.preprocessors import anime_face

    sd = tiny_sd("anime_face")
    x = np.random.default_rng(1).random((1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(ref.anime_face_apply(reference_tree(sd), jnp.asarray(x)))
    got = nhwc(anime_face.anime_face_apply(port_tree(sd), nchw(x)))
    assert got.shape == want.shape == (1, 64, 96, 7)
    assert rel_err(got, want) < TOL
    assert np.array_equal(anime_face.PALETTE, ref.PALETTE)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    write(root, "uniformer")
    write(root, "anime_face")
    return root


@pytest.mark.parametrize("entry,module,cls,sub", [
    ("seg_ufade20k", "uniformer", "UniformerDetector", "uniformer"),
    ("seg_anime_face", "anime_face", "AnimeFaceSegmenter", "anime_face_segment")])
def test_entries_match_reference(models, monkeypatch, entry, module, cls, sub):
    from forge_tpu.preprocessors import get_preprocessor as ref
    from forge_tpu_torch.preprocessors import PREPROCESSORS

    for pkg, extra in (("forge_tpu", {}), ("forge_tpu_torch", {"device": "cpu"})):
        m = importlib.import_module(f"{pkg}.preprocessors.{module}")
        monkeypatch.setattr(m, "_DETECTOR", getattr(m, cls)(model_dir=os.path.join(models, sub),
                                                             **extra))
    img = image(6, 72, 96)
    got = PREPROCESSORS[entry](img, 64, 0, 0)
    assert PREPROCESSORS[entry].ported and got.shape == (64, 88, 3)
    assert np.array_equal(got, ref(entry)(img, 64, 0, 0))
    assert len(np.unique(got.reshape(-1, 3), axis=0)) >= 2


def test_mediapipe_face_raises_the_reference_error():
    from forge_tpu.preprocessors import get_preprocessor as ref
    from forge_tpu_torch.preprocessors import PREPROCESSORS

    img = image(0, 32, 32)
    with pytest.raises(RuntimeError) as want:
        ref("mediapipe_face")(img, 32, 1, 0.5)
    with pytest.raises(RuntimeError) as got:
        PREPROCESSORS["mediapipe_face"](img, 32, 1, 0.5)
    assert str(got.value) == str(want.value) and "mediapipe" in str(got.value)


def test_registry_runs_the_slice_and_names_item_9_for_the_rest():
    from forge_tpu_torch.preprocessors import PREPROCESSORS

    for name in ("inpaint_only+lama", "depth_leres", "seg_anime_face", "mediapipe_face",
                 "seg_ufade20k", "depth_zoe", "depth_marigold",
                 "densepose (pruple bg & purple torso)",
                 "densepose_parula (black bg & blue torso)", "seg_ofade20k", "seg_ofcoco"):
        assert PREPROCESSORS[name].ported, name
    for name in ("dw_openpose_full",):
        assert not PREPROCESSORS[name].ported
        with pytest.raises(NotImplementedError, match="item 9"):
            PREPROCESSORS[name](image(0, 16, 16), 16, 0, 0)

"""The port's OneFormer (forge_tpu_torch/preprocessors/oneformer.py)
against forge_tpu's on the CPU, f32, on small OneFormers in the detectron2
key space (tests/torch_spaces_cases.py).

The index table, shift mask, sine embedding and reference points equal
forge_tpu's; each Swin block (plain, shifted, on a map the window does not
divide) and the backbone's four maps, the pixel decoder, the predictor and
the whole forward agree within 1e-4 of the largest reference value, and
`ms_deform_sample` (locations inside, on the edges of and outside the
maps) within 1e-5. The task ids equal forge_tpu's on the port's own CLIP
BPE, the two palettes are equal, and `seg_ofade20k` and `seg_ofcoco`
through the registry read their files and give forge_tpu's palette maps
on 99.5 % of the pixels or more, the rest on class edges (two classes'
scores within float error of each other). A missing checkpoint raises forge_tpu's RuntimeError
text; a detectron2 file that keeps the weights under `model` is read by
the port. OneFormer Swin-L at its published widths runs on the meta device
at the detector's 640² feed and calls no kernel.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from torch_spaces_cases import (image, nchw, nhwc, port_tree, reference_tree, rel_err,  # noqa: E402
                                tiny_sd, write)

TOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    """(forge_tpu's tree, the port's) of the small ADE20K OneFormer, as the loaders drop keys."""
    from forge_tpu_torch.preprocessors.oneformer import _convert

    sd = _convert(tiny_sd("oneformer_ade20k"))
    return reference_tree(sd), port_tree(sd)


@pytest.fixture(scope="module")
def reference_features(trees):
    """forge_tpu's backbone maps, pixel decoder and predictor (each jitted
    once) on a seeded 64×96 image with the semantic task's ids."""
    import jax

    from forge_tpu.preprocessors import oneformer as ref

    rp = trees[0]
    x = np.random.default_rng(0).standard_normal((1, 64, 96, 3)).astype(np.float32)
    feats = jax.jit(ref.swin_features)(rp["backbone"], jnp.asarray(x))
    maskf, ms = jax.jit(ref.pixel_decoder_apply)(rp["sem_seg_head"]["pixel_decoder"], feats)
    tokens = jnp.asarray(ref.task_token_ids()[None]).astype(jnp.float32)
    task = ref._mlp(rp["task_mlp"], tokens)[:, None]
    cls, masks = jax.jit(ref.predictor_apply)(rp["sem_seg_head"]["predictor"], ms, maskf, task)
    return x, feats, maskf, ms, np.asarray(task), cls, masks


@pytest.mark.parametrize("args", [(4,), (7,), (12,)])
def test_rel_pos_index(args):
    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    assert np.array_equal(oneformer._rel_pos_index(*args), ref._rel_pos_index(*args))


@pytest.mark.parametrize("fn,args", [("_shift_mask", (8, 12, 4, 2)),
                                     ("_shift_mask", (24, 36, 12, 6)),
                                     ("_sine_pos_embed", (5, 7, 32)),
                                     ("_sine_pos_embed", (20, 20, 256)),
                                     ("_encoder_ref_points", (((2, 3), (4, 6), (8, 12)),))])
def test_constants_equal_reference(fn, args):
    """The shifted windows' mask is models/swinir.py's (`shift_mask`)."""
    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    port = oneformer.shift_mask if fn == "_shift_mask" else getattr(oneformer, fn)
    assert np.array_equal(port(*args), getattr(ref, fn)(*args))


@pytest.mark.parametrize("hw,shift", [((8, 8), 0), ((8, 8), 2), ((6, 10), 2), ((5, 7), 0)])
def test_swin_block_matches_reference(trees, hw, shift):
    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    blocks = ("layers", "1", "blocks", "1")
    rp, pp = trees[0]["backbone"], trees[1]["backbone"]
    for k in blocks:
        rp, pp = rp[k], pp[k]
    x = np.random.default_rng(hw[0]).standard_normal((1, hw[0] * hw[1], 32)).astype(np.float32)
    want = ref._swin_block(rp, jnp.asarray(x), hw, 4, shift)
    got = oneformer._swin_block(pp, torch.from_numpy(x), hw, 4, shift)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL


def test_swin_features_match_reference(trees, reference_features):
    from forge_tpu_torch.preprocessors import oneformer

    x, want = reference_features[:2]
    got = oneformer.swin_features(trees[1]["backbone"], nchw(x))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    for k in want:
        assert got[k].shape[2:] == want[k].shape[1:3]
        assert rel_err(nhwc(got[k]), np.asarray(want[k])) < TOL


@pytest.mark.parametrize("spread", [0.2, 1.5])
def test_ms_deform_sample_matches_reference(spread):
    """Locations in [0, 1] (`spread` 0.2 around the centre) and well past the
    maps' edges (1.5): the corners outside are dropped as zeros."""
    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    rng = np.random.default_rng(int(spread * 10))
    shapes = [(3, 4), (6, 8), (12, 16)]
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((2, s, 8, 4)).astype(np.float32)
    loc = (0.5 + spread * rng.standard_normal((2, 5, 8, 3, 4, 2))).astype(np.float32)
    loc[0, 0, 0, 0, 0] = (0.0, 1.0)  # on the edges
    aw = rng.random((2, 5, 8, 3, 4)).astype(np.float32)
    want = np.asarray(ref.ms_deform_sample(jnp.asarray(value), shapes, jnp.asarray(loc),
                                           jnp.asarray(aw)))
    got = oneformer.ms_deform_sample(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                     torch.from_numpy(aw)).numpy()
    assert got.shape == want.shape == (2, 5, 32)
    assert rel_err(got, want) < 1e-5


def test_pixel_decoder_matches_reference(trees, reference_features):
    from forge_tpu_torch.preprocessors import oneformer

    _, feats, maskf, ms = reference_features[:4]
    got_f = {k: nchw(np.asarray(v)) for k, v in feats.items()}
    got_m, got_ms = oneformer.pixel_decoder_apply(trees[1]["sem_seg_head"]["pixel_decoder"],
                                                  got_f)
    assert got_m.shape == (1, 32, 16, 24)
    assert rel_err(nhwc(got_m), np.asarray(maskf)) < TOL
    assert [tuple(t.shape[2:]) for t in got_ms] == [(2, 3), (4, 6), (8, 12)]
    for g, w in zip(got_ms, ms):
        assert rel_err(nhwc(g), np.asarray(w)) < TOL


def test_predictor_matches_reference(trees, reference_features):
    from forge_tpu_torch.preprocessors import oneformer

    _, _, maskf, ms, task, cls_r, masks_r = reference_features
    pp = trees[1]["sem_seg_head"]["predictor"]
    cls_p, masks_p = oneformer.predictor_apply(pp, [nchw(np.asarray(m)) for m in ms],
                                               nchw(np.asarray(maskf)), torch.from_numpy(task))
    assert cls_p.shape == (1, 10, 151) and masks_p.shape == (1, 10, 16, 24)
    assert rel_err(cls_p.numpy(), np.asarray(cls_r)) < TOL
    assert rel_err(masks_p.numpy(), np.asarray(masks_r)) < TOL


@pytest.mark.parametrize("task", ["semantic", "panoptic", "instance"])
def test_task_token_ids_equal_reference(task):
    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    got = oneformer.task_token_ids(task)
    assert got.dtype == np.int64 and got.shape == (77,)
    assert np.array_equal(got, ref.task_token_ids(task))
    assert got[0] == 49406 and 49407 in got


def test_oneformer_apply_and_palettes_match_reference(trees, reference_features):
    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    x, cls_r, masks_r = reference_features[0], *reference_features[5:]
    tokens = oneformer.task_token_ids()[None]
    cls_p, masks_p = oneformer.oneformer_apply(trees[1], nchw(x), torch.from_numpy(tokens))
    assert rel_err(cls_p.numpy(), np.asarray(cls_r)) < TOL
    assert rel_err(masks_p.numpy(), np.asarray(masks_r)) < TOL
    assert np.array_equal(oneformer.COCO_PANOPTIC_PALETTE, ref.COCO_PANOPTIC_PALETTE)
    assert oneformer.COCO_PANOPTIC_PALETTE.shape == (133, 3)
    for kind in ("ade20k", "coco"):
        assert np.array_equal(oneformer._CONFIGS[kind]["palette"], ref._CONFIGS[kind]["palette"])
        assert oneformer._CONFIGS[kind]["ckpt"] == ref._CONFIGS[kind]["ckpt"]
    assert (oneformer.OneformerDetector.MIN_TEST, oneformer.OneformerDetector.MAX_TEST) == (
        ref.OneformerDetector.MIN_TEST, ref.OneformerDetector.MAX_TEST)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Both small OneFormers with the decoder's attention projections ×8 and
    the class embedding ×4: at the synth's scale every query's attention is
    near uniform and all take one class; sharpened, they take several."""
    root = str(tmp_path_factory.mktemp("models"))
    pred = "sem_seg_head.predictor."
    for name in ("oneformer_ade20k", "oneformer_coco"):
        sd = tiny_sd(name)
        for key in sd:
            if key.startswith(pred) and key.endswith("in_proj_weight"):
                sd[key] = sd[key] * 8
        sd[pred + "class_embed.weight"] = sd[pred + "class_embed.weight"] * 4
        write(root, name, sd)
    return root


def boundary_only(got, want):
    """Whether every pixel where two palette maps differ borders (8-neighbourhood)
    a pixel of `want` holding `got`'s colour: a class edge, where two classes'
    scores tie within float error."""
    diff = np.argwhere((got != want).any(-1))
    h, w = want.shape[:2]
    for y, x in diff:
        near = want[max(y - 1, 0):min(y + 2, h), max(x - 1, 0):min(x + 2, w)].reshape(-1, 3)
        if not (near == got[y, x]).all(-1).any():
            return False
    return True


@pytest.mark.parametrize("entry,kind,seed,h,w", [("seg_ofade20k", "ade20k", 2, 96, 128),
                                                 ("seg_ofcoco", "coco", 3, 128, 96)])
def test_entries_match_reference(models, monkeypatch, entry, kind, seed, h, w):
    """Each entry through the registry at 96 (ResizeShortestEdge to 640, the
    pad to 32, the masks back at the image's size, the palette paint): the
    palette map equal to forge_tpu's on 99.5 % of the pixels or more, every
    other pixel on a class edge."""
    from forge_tpu.preprocessors import get_preprocessor as ref
    from forge_tpu_torch.preprocessors import PREPROCESSORS

    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for pkg, extra in (("forge_tpu", {}), ("forge_tpu_torch", {"device": "cpu"})):
            m = importlib.import_module(f"{pkg}.preprocessors.oneformer")
            det = m.OneformerDetector(kind, model_dir=os.path.join(models, "oneformer"), **extra)
            monkeypatch.setitem(m._DETECTORS, kind, det)
        img = image(seed, h, w)
        got = PREPROCESSORS[entry](img, 96, 0, 0)
        want = ref(entry)(img, 96, 0, 0)
    finally:
        cv2.ipp.setUseIPP(was)
    assert PREPROCESSORS[entry].ported and got.shape == want.shape == (h, w, 3)
    assert (got != want).any(-1).mean() <= 0.005 and boundary_only(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) >= 2


def test_missing_checkpoint_and_model_entry(tmp_path):
    """No file: forge_tpu's RuntimeError text. A detectron2 `.pth` holding
    the weights under `model`: the port reads it and segments as from the
    flat file (forge_tpu's torch reader keeps top-level tensors only and
    finds no weights there)."""
    import torch as _torch

    from forge_tpu.preprocessors import oneformer as ref
    from forge_tpu_torch.preprocessors import oneformer

    img = image(2, 40, 48)
    with pytest.raises(RuntimeError) as want:
        ref.OneformerDetector("ade20k", model_dir=str(tmp_path)).detect(img)
    with pytest.raises(RuntimeError) as got:
        oneformer.OneformerDetector("ade20k", model_dir=str(tmp_path), device="cpu").detect(img)
    assert str(got.value) == str(want.value) and "250_16_swin_l" in str(got.value)
    sd = tiny_sd("oneformer_ade20k")
    flat = write(str(tmp_path / "flat"), "oneformer_ade20k", sd)
    nested = tmp_path / "nested"
    nested.mkdir()
    _torch.save({"model": {k: _torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                 "iteration": 160000}, nested / "oneformer_ade20k_custom.pth")
    a = oneformer.OneformerDetector("ade20k", model_dir=flat, device="cpu").detect(img)
    b = oneformer.OneformerDetector("ade20k", model_dir=str(nested), device="cpu").detect(img)
    assert np.array_equal(a, b)
    reference = ref.OneformerDetector("ade20k", model_dir=str(nested))
    reference.load()
    assert not reference.params


def test_oneformer_swin_l_at_published_width_on_meta(monkeypatch):
    from test_torch_extras_trace import meta_tree

    from forge_tpu_torch.core.synth_annotators import synth_oneformer_sd
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.preprocessors import oneformer

    calls = []
    monkeypatch.setattr(attention_mod, "flash_attention", lambda *a, **k: calls.append(a))
    for queries, classes in ((250, 150), (150, 133)):
        tree = meta_tree(oneformer._convert(synth_oneformer_sd(queries=queries, classes=classes,
                                                               fill="zeros")))
        x = torch.empty((1, 3, 640, 640), device="meta", dtype=torch.bfloat16)
        tokens = torch.zeros((1, 77), device="meta", dtype=torch.int64)
        with torch.no_grad():
            cls, masks = oneformer.oneformer_apply(tree, x, tokens)
        assert tuple(cls.shape) == (1, queries, classes + 1)
        assert tuple(masks.shape) == (1, queries, 160, 160)
    assert calls == []

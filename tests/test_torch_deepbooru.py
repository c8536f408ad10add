"""The port's DeepDanbooru tagger (forge_tpu_torch/postprocessing/deepbooru.py)
against forge_tpu's on the CPU, f32.

`build_plan` gives forge_tpu's plan on a tiny network (a projection-last
block mid-stage) and on resnet_custom_v3 at its published widths (shapes
only: 179 convs, 59 plan entries, the stride-2 block of convs 97-100);
`deepbooru_apply` agrees within 1e-4 of the largest reference value; `tag`
gives forge_tpu's string under each option (threshold, alphabetical sort,
spaces, escapes, ranks, filtered tags) with the rating tags left out. The
tag names live in the checkpoint beside the tensors
(model-resnet_custom_v3.pt): the port reads them; forge_tpu's loader keeps
tensors only and reads none, so its `tag` answers "" on the same file
(shown from both sides, then forge_tpu given the port's list by hand).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_interrogate_cases import (image, nchw, port_tree, reference_tree, rel_err,  # noqa: E402
                                     tiny_sd, write)

TOL = 1e-4


@pytest.fixture(scope="module")
def tagger(tmp_path_factory):
    """Both packages' DeepDanbooru on one tiny .pt with its 40 tag names."""
    from forge_tpu.postprocessing import deepbooru as ref
    from forge_tpu_torch.core.synth_annotators import synth_deepbooru_tags
    from forge_tpu_torch.postprocessing.deepbooru import DeepDanbooru

    d = tmp_path_factory.mktemp("models")
    tags = synth_deepbooru_tags(40)
    sd = tiny_sd("deepbooru")
    write(str(d), "deepbooru", sd, tags=tags)
    mdir = str(d / "torch_deepdanbooru")
    port = DeepDanbooru(model_dir=mdir, device="cpu")
    reference = ref.DeepDanbooru(model_dir=mdir)
    reference.load()
    return port, reference, tags


def _shape_tree(sd, hwio):
    """Shape-only leaves (no memory): the port's OIHW, or forge_tpu's HWIO."""
    from forge_tpu_torch.core.convert import nest

    return nest({k: types.SimpleNamespace(shape=(tuple(v.shape[i] for i in (2, 3, 1, 0))
                                                 if hwio and len(v.shape) == 4
                                                 else tuple(v.shape)))
                 for k, v in sd.items()})


def test_build_plan_matches_reference():
    from forge_tpu.postprocessing.deepbooru import build_plan as ref
    from forge_tpu_torch.core.synth import DeviceFill
    from forge_tpu_torch.core.synth_annotators import synth_deepbooru_sd
    from forge_tpu_torch.postprocessing.deepbooru import build_plan

    sd = tiny_sd("deepbooru")
    assert build_plan(port_tree(sd)) == ref(reference_tree(sd))
    assert ("block", 15, 12, 13, 14, 2) in build_plan(port_tree(sd))
    full = synth_deepbooru_sd(fill=DeviceFill("cpu"))  # lazy: shapes, no weights
    plan = build_plan(_shape_tree(full, False))
    assert plan == ref(_shape_tree(full, True))
    assert len(full) == 2 * 179 and len(plan) == 59
    assert ("block", 100, 97, 98, 99, 2) in plan and plan[-1] == ("head", 178)


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 96)])
def test_forward_matches_reference(seed, size):
    from forge_tpu.postprocessing.deepbooru import deepbooru_apply as ref
    from forge_tpu_torch.postprocessing.deepbooru import deepbooru_apply

    sd = tiny_sd("deepbooru", seed=seed)
    x = np.random.default_rng(seed).random((2, size, size, 3)).astype(np.float32)
    want = np.asarray(ref(reference_tree(sd), jnp.asarray(x)))
    got = deepbooru_apply(port_tree(sd), nchw(x)).numpy()
    assert got.shape == want.shape == (2, 40)
    assert rel_err(got, want) < TOL


def test_loader_reads_the_tag_list_from_both_sides(tagger):
    port, reference, tags = tagger
    img = image(3, 72, 90)
    assert port.available and port.tags == tags and tags[0].startswith("rating:")
    assert reference.tags == []  # forge_tpu's reader keeps tensors only
    assert reference.tag(img, threshold=0.0) == ""
    assert port.tag(img, threshold=0.0) != ""
    assert rel_err(port.probabilities(img), reference.probabilities(img)) < TOL


@pytest.mark.parametrize("kw", [
    dict(),
    dict(threshold=0.0),
    dict(threshold=0.3, alpha_sort=True),
    dict(threshold=0.3, use_spaces=False, use_escape=False),
    dict(threshold=0.2, include_ranks=True),
    dict(threshold=0.0, filter_tags="X, {first} ,{second}"),
])
def test_tag_matches_reference(tagger, kw):
    port, reference, tags = tagger
    img = image(5, 100, 80)
    probs = port.probabilities(img)
    kw = dict(kw)
    if "filter_tags" in kw:  # two of the picked tags, spaces for underscores in one
        picked = [t for t, p in zip(tags, probs) if not t.startswith("rating:")]
        kw["filter_tags"] = kw["filter_tags"].format(first=picked[0].replace("_", " "),
                                                     second=picked[1])
    reference.tags = list(tags)
    try:
        want = reference.tag(img, **kw)
    finally:
        reference.tags = []
    got = port.tag(img, **kw)
    assert got == want
    assert "rating:" not in got
    if kw.get("threshold", 0.5) == 0.0:
        assert got.count(", ") >= 20


def test_missing_checkpoint(tmp_path):
    from forge_tpu_torch.postprocessing.deepbooru import DeepDanbooru

    db = DeepDanbooru(model_dir=str(tmp_path / "none"), device="cpu")
    assert not db.available
    with pytest.raises(RuntimeError, match="no deepbooru checkpoint"):
        db.probabilities(image(0, 16, 16))

"""The port's LeReS and ZoeDepth (forge_tpu_torch/preprocessors/leres.py,
zoe.py) against forge_tpu's on the CPU, f32, at small widths
(tests/torch_interrogate_cases.py).

The networks agree within 1e-4 of the largest reference value: LeReS's
ResNeXt and FTB/FFM/AO decoder, the ZoeDepth BEiT core (its relative
position tables resized to windows other than the trained one, as
forge_tpu resizes them) with the metric-bins head, and ZoeDepth's head
alone on seeded taps. Through the registry (`depth_leres` with its two
sliders, `depth_zoe`), each detector reads its file from a models
directory and gives forge_tpu's uint8 map within one level on at most
0.5 % of the pixels: float32 noise meets a rounding boundary after the
percentile normalization (the count is asserted).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from torch_interrogate_cases import (image, nchw, port_tree, reference_tree, rel_err,  # noqa: E402
                                     tiny_sd, write)

TOL = 1e-4
ONE_LEVEL_SHARE = 0.005


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("seed,h,w", [(0, 64, 96), (1, 96, 64)])
def test_leres_apply_matches_reference(seed, h, w):
    from forge_tpu.preprocessors.leres import leres_apply as ref
    from forge_tpu_torch.preprocessors.leres import leres_apply

    sd = tiny_sd("leres", seed=seed)
    x = np.random.default_rng(seed).standard_normal((1, h, w, 3)).astype(np.float32)
    want = np.asarray(ref(reference_tree(sd), jnp.asarray(x)))
    got = leres_apply(port_tree(sd), nchw(x)).numpy()
    assert got.shape == want.shape == (1, h, w)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("h,w", [(64, 96), (32, 32)])
def test_zoe_apply_matches_reference(h, w):
    """Windows of 4×6 and 2×2 patches against the 4×4 trained table."""
    from forge_tpu.preprocessors.zoe import zoe_apply as ref
    from forge_tpu_torch.preprocessors.zoe import zoe_apply

    sd = tiny_sd("zoe")
    x = np.random.default_rng(h).standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(ref(reference_tree(sd), jnp.asarray(x)))
    got = zoe_apply(port_tree(sd), nchw(x)).numpy()
    assert got.shape == want.shape == (2, h, w)
    assert rel_err(got, want) < TOL


def test_zoe_head_matches_reference():
    from forge_tpu.preprocessors.zoe import zoe_head as ref
    from forge_tpu_torch.preprocessors.zoe import zoe_head

    sd = tiny_sd("zoe", seed=3)
    rng = np.random.default_rng(5)
    taps = {"l4_rn": (2, 16), "r4": (4, 16), "r3": (8, 16), "r2": (16, 16), "r1": (32, 16),
            "out_conv": (64, 32)}
    taps = {k: rng.standard_normal((1, s, s, c)).astype(np.float32) for k, (s, c) in taps.items()}
    rel = rng.random((1, 64, 64)).astype(np.float32)
    want = np.asarray(ref(reference_tree(sd), jnp.asarray(rel),
                          {k: jnp.asarray(v) for k, v in taps.items()}))
    got = zoe_head(port_tree(sd), torch.from_numpy(rel), {k: nchw(v) for k, v in taps.items()})
    assert rel_err(got.numpy(), want) < TOL


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    write(root, "leres")
    write(root, "zoe")
    return root


def _install(monkeypatch, root, module, cls, sub, **kw):
    for pkg, extra in (("forge_tpu", {}), ("forge_tpu_torch", {"device": "cpu"})):
        m = importlib.import_module(f"{pkg}.preprocessors.{module}")
        monkeypatch.setattr(m, "_DETECTOR", getattr(m, cls)(model_dir=os.path.join(root, sub),
                                                             **kw, **extra))


def _close_maps(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    diff = np.abs(np.rint(got * 255) - np.rint(want * 255))
    assert diff.max() <= 1 and (diff > 0).mean() <= ONE_LEVEL_SHARE, (diff.max(), (diff > 0).mean())
    return diff


@pytest.mark.parametrize("a,b", [(0, 0), (30, 0), (0, 20), (10, 40)])
def test_depth_leres_entry_matches_reference(models, monkeypatch, a, b):
    from forge_tpu.preprocessors import get_preprocessor as ref
    from forge_tpu_torch.preprocessors import PREPROCESSORS

    _install(monkeypatch, models, "leres", "LeresDetector", "leres")
    entry = PREPROCESSORS["depth_leres"]
    assert entry.ported and entry.slider_a == ("Remove Near %", 0, 100, 0)
    img = image(2, 90, 120)
    got = entry(img, 64, a, b)
    _close_maps(got, ref("depth_leres")(img, 64, a, b))
    assert got.shape == (64, 88, 3) and got.std() > 0


@pytest.mark.parametrize("seed,h,w", [(3, 72, 96), (4, 100, 64)])
def test_depth_zoe_entry_matches_reference(models, monkeypatch, seed, h, w):
    from forge_tpu.preprocessors import get_preprocessor as ref
    from forge_tpu_torch.preprocessors import PREPROCESSORS

    _install(monkeypatch, models, "zoe", "ZoeDetector", "zoedepth", net_h=64, net_w=64)
    img = image(seed, h, w)
    got = PREPROCESSORS["depth_zoe"](img, 64, 0, 0)
    _close_maps(got, ref("depth_zoe")(img, 64, 0, 0))
    assert got.std() > 0 and np.array_equal(got[..., 0], got[..., 2])


def test_detectors_without_checkpoints(tmp_path):
    from forge_tpu_torch.preprocessors.leres import LeresDetector
    from forge_tpu_torch.preprocessors.zoe import ZoeDetector

    for det, text in ((LeresDetector, "no res101.pth"), (ZoeDetector, "no ZoeDepth checkpoint")):
        d = det(model_dir=str(tmp_path), device="cpu")
        assert not d.available
        with pytest.raises(RuntimeError, match=text):
            d.detect(image(0, 32, 32))

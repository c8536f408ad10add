"""The port's edge and line annotator networks against forge_tpu's apply
functions on the CPU, f32, at small widths: TEED, both lineart generators,
the anime UNet, manga line, M-LSD and NormalBAE (the depth, pose, HED and
PiDiNet nets are in tests/test_torch_annotator_nets.py, with the helpers
this file repeats). Outputs within 1e-4 of the largest reference value.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_annotator_cases import port_tree, reference_tree, rel_err, tiny_sd  # noqa: E402

TOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _run(name, ref_fn, port_fn, x_nhwc, sd=None):
    sd = tiny_sd(name) if sd is None else sd
    want = ref_fn(reference_tree(sd), jnp.asarray(x_nhwc))
    with torch.no_grad():
        got = port_fn(port_tree(sd), _nchw(x_nhwc))
    return got, want


def _x(shape, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def test_teed_matches_reference():
    from forge_tpu.preprocessors.teed import teed_apply as ref
    from forge_tpu_torch.preprocessors.teed import teed_apply as port

    got, want = _run("teed", ref, port, _x((1, 40, 56, 3), seed=3, lo=0, hi=255))
    assert rel_err(got.numpy(), np.asarray(want)) < TOL


@pytest.mark.parametrize("name", ["lineart", "lineart_coarse"])
def test_lineart_generator_matches_reference(name):
    from forge_tpu.preprocessors.lineart import lineart_apply as ref
    from forge_tpu_torch.preprocessors.lineart import lineart_apply as port

    got, want = _run(name, ref, port, _x((1, 36, 44, 3), seed=4))
    want = np.asarray(want)
    assert _nhwc(got).shape == want.shape and want.std() > 0
    assert rel_err(_nhwc(got), want) < TOL


def test_lineart_anime_matches_reference():
    from forge_tpu.preprocessors.lineart import lineart_anime_apply as ref
    from forge_tpu_torch.preprocessors.lineart import lineart_anime_apply as port

    got, want = _run("lineart_anime", ref, port, _x((1, 256, 256, 3), seed=5, lo=-1, hi=1))
    want = np.asarray(want)
    assert _nhwc(got).shape == want.shape and want.std() > 0
    assert rel_err(_nhwc(got), want) < TOL


def test_manga_line_matches_reference():
    from forge_tpu.preprocessors.manga_line import manga_line_apply as ref
    from forge_tpu_torch.preprocessors.manga_line import manga_line_apply as port

    got, want = _run("manga_line", ref, port, _x((1, 48, 64, 1), seed=6, lo=0, hi=255))
    want = np.asarray(want)
    assert _nhwc(got).shape == want.shape and want.std() > 0
    assert rel_err(_nhwc(got), want) < TOL


def test_mlsd_matches_reference():
    from forge_tpu.preprocessors.mlsd import mlsd_apply as ref
    from forge_tpu_torch.preprocessors.mlsd import mlsd_apply as port

    got, want = _run("mlsd", ref, port, _x((1, 32, 64, 4), seed=7, lo=-1, hi=1))
    want = np.asarray(want)
    assert _nhwc(got).shape == want.shape == (1, 16, 32, 9) and want.std() > 0
    assert rel_err(_nhwc(got), want) < TOL


def test_normalbae_matches_reference():
    from forge_tpu.preprocessors.normalbae import normalbae_apply as ref
    from forge_tpu_torch.preprocessors.normalbae import normalbae_apply as port

    got, want = _run("normalbae", ref, port, _x((1, 32, 64, 3), seed=8, lo=-2, hi=2))
    want = np.asarray(want)
    assert _nhwc(got).shape == want.shape == (1, 32, 64, 4) and want.std() > 0
    assert rel_err(_nhwc(got), want) < TOL


def test_normalbae_synth_is_b5_geometry():
    """The published synth at tf_efficientnet_b5_ap's widths and depths (shapes only)."""
    from forge_tpu_torch.core.synth_annotators import synth_normalbae_sd

    sd = synth_normalbae_sd(fill="zeros")
    e = "encoder.original_model."
    assert sd[e + "conv_stem.weight"].shape == (48, 3, 3, 3)
    assert sd[e + "conv_head.weight"].shape == (2048, 512, 1, 1)
    stages = {}
    for k in sd:
        if k.startswith(e + "blocks.") and k.endswith("bn2.weight"):
            s, i = k[len(e + "blocks."):].split(".")[:2]
            stages[int(s)] = max(stages.get(int(s), 0), int(i) + 1)
    assert [stages[s] for s in range(7)] == [3, 5, 5, 7, 7, 9, 3]
    assert sd["decoder.up1._net.0.weight"].shape == (1024, 2048 + 176, 3, 3)

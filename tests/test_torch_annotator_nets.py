"""The port's depth, pose, HED and PiDiNet networks
(forge_tpu_torch/preprocessors/) against forge_tpu's apply functions on
the CPU, f32, at small widths (the edge and line nets are in
tests/test_torch_annotator_nets_lines.py).

Each network is a `core/synth_annotators.py` state dict in its released
file's key space (tests/torch_annotator_cases.py); forge_tpu reads it as
its loaders do (OIHW → HWIO, nested), the port as its loaders do (OIHW,
nested). The same seeded numpy input goes through both, NCHW for the port
and NHWC for forge_tpu; the outputs agree within 1e-4 of the largest
reference value. `ops/nn.py` `conv2d_transpose` is held to forge_tpu's on
odd sizes, strides 2 and 4 and output padding 1; where the output padding
passes the padding (no annotator's case) the reference drops a row and a
column that torch's ConvTranspose2d keeps, shown from both sides.
`annotator.inference()`, every detector's forward, turns cuDNN's and the
matmuls' TF32 off while a forward runs on any thread, and puts back the
settings it found after the last one.
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


@pytest.mark.parametrize("h,w,k,stride,padding,output_padding", [
    (5, 7, 4, 4, 0, 0), (6, 3, 2, 2, 0, 0), (9, 4, 3, 2, 1, 1), (4, 5, 4, 2, 1, 0),
    (7, 7, 4, 2, 3, 1), (3, 6, 3, 2, 1, 1)])
def test_conv2d_transpose_matches_reference(h, w, k, stride, padding, output_padding):
    from forge_tpu.ops import nn as ref_nn
    from forge_tpu_torch.ops import nn

    rng = np.random.default_rng(h * 100 + w)
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    sd = {"t.weight": rng.standard_normal((5, 3, k, k)).astype(np.float32),
          "t.bias": rng.standard_normal(3).astype(np.float32)}
    want = np.asarray(ref_nn.conv2d_transpose(jnp.asarray(x), reference_tree(sd)["t"],
                                              stride=stride, padding=padding,
                                              output_padding=output_padding))
    got = _nhwc(nn.conv2d_transpose(_nchw(x), port_tree(sd)["t"], stride=stride,
                                    padding=padding, output_padding=output_padding))
    assert got.shape == want.shape == (2, (h - 1) * stride - 2 * padding + k + output_padding,
                                       (w - 1) * stride - 2 * padding + k + output_padding, 3)
    assert rel_err(got, want) < 1e-5


def test_conv2d_transpose_output_padding_past_padding_both_sides():
    """With output_padding > padding the reference has no row to keep (it
    crops p − op < 0 rows): its output lacks the last row and column that
    torch's ConvTranspose2d, and the port, give. No annotator takes it."""
    from forge_tpu.ops import nn as ref_nn
    from forge_tpu_torch.ops import nn

    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 3, 6, 5)).astype(np.float32)
    sd = {"t.weight": rng.standard_normal((5, 3, 2, 2)).astype(np.float32)}
    want = np.asarray(ref_nn.conv2d_transpose(jnp.asarray(x), reference_tree(sd)["t"], stride=2,
                                              padding=0, output_padding=1))
    got = _nhwc(nn.conv2d_transpose(_nchw(x), port_tree(sd)["t"], stride=2, output_padding=1))
    upstream = torch.nn.functional.conv_transpose2d(_nchw(x), torch.from_numpy(sd["t.weight"]),
                                                    stride=2, output_padding=1)
    assert want.shape == (1, 6, 12, 3) and got.shape == (1, 7, 13, 3)
    assert np.array_equal(got, _nhwc(upstream))
    assert rel_err(got[:, :6, :12], want) < 1e-5


def _run(name, ref_fn, port_fn, x_nhwc, sd=None):
    sd = tiny_sd(name) if sd is None else sd
    want = ref_fn(reference_tree(sd), jnp.asarray(x_nhwc))
    with torch.no_grad():
        got = port_fn(port_tree(sd), _nchw(x_nhwc))
    return got, want


def _x(shape, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def test_depth_anything_matches_reference():
    from forge_tpu.preprocessors.depth_anything import depth_anything_apply as ref
    from forge_tpu_torch.preprocessors.depth_anything import depth_anything_apply as port

    got, want = _run("depth_anything", ref, port, _x((1, 56, 70, 3), lo=-2, hi=2))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 56, 70) and want.std() > 0
    assert rel_err(got.numpy(), want) < TOL


def test_midas_dpt_matches_reference():
    from forge_tpu.preprocessors.depth import dpt_apply as ref
    from forge_tpu_torch.preprocessors.depth import dpt_apply as port

    got, want = _run("midas", ref, port, _x((1, 64, 96, 3), lo=-1, hi=1))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 64, 96) and want.std() > 0
    assert rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("net", ["body", "hand", "face"])
def test_openpose_nets_match_reference(net):
    from forge_tpu.preprocessors import openpose as ref
    from forge_tpu_torch.preprocessors import openpose as port

    fn = {"body": "body_apply", "hand": "hand_apply", "face": "face_apply"}[net]
    x = _x((1, 64, 48, 3), seed=1, lo=-0.5, hi=0.5)
    got, want = _run(net, getattr(ref, fn), getattr(port, fn), x)
    pairs = list(zip(got, want)) if net == "body" else [(got, want)]
    for g, wnt in pairs:
        wnt = np.asarray(wnt)
        assert _nhwc(g).shape == wnt.shape and wnt.std() > 0
        assert rel_err(_nhwc(g), wnt) < TOL


def test_hed_matches_reference():
    from forge_tpu.preprocessors.hed import hed_apply as ref
    from forge_tpu_torch.preprocessors.hed import hed_apply as port

    got, want = _run("hed", ref, port, _x((1, 44, 62, 3), lo=0, hi=255))
    assert len(got) == len(want) == 5
    for g, wnt in zip(got, want):
        assert rel_err(_nhwc(g), np.asarray(wnt)) < TOL


def test_pidinet_matches_reference():
    from forge_tpu.preprocessors.pidinet import convert_pidinet_sd as ref_convert
    from forge_tpu.preprocessors.pidinet import pidinet_apply as ref
    from forge_tpu_torch.preprocessors.pidinet import convert_pidinet_sd, pidinet_apply

    sd = tiny_sd("pidinet")
    ported = convert_pidinet_sd(sd)
    reference = ref_convert(sd)
    assert ported.keys() == reference.keys()
    assert all(np.array_equal(ported[k], reference[k]) for k in ported)
    assert ported["block1_2.conv1.weight"].shape[-1] == 5  # rd → 5×5
    x = _x((1, 48, 40, 3), seed=2)
    want = np.asarray(ref(reference_tree(reference), jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(pidinet_apply(port_tree(ported), _nchw(x)))
    assert got.shape == want.shape and rel_err(got, want) < TOL


def test_inference_turns_tf32_off_across_threads():
    import threading

    from forge_tpu_torch.preprocessors.annotator import inference

    def flags():
        c = torch.backends.cudnn
        return c.benchmark, c.deterministic, c.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    found = flags()
    forward = (False, True, False, False)
    entered, leave = threading.Event(), threading.Event()
    seen = []

    def other():
        with inference():
            entered.set()
            leave.wait(10)
            seen.append(flags())

    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        t = threading.Thread(target=other)
        t.start()
        assert entered.wait(10)
        with inference():
            assert flags() == forward and not torch.is_grad_enabled()
        assert flags() == forward  # the other thread's forward still runs
        leave.set()
        t.join(10)
        assert seen == [forward] and flags() == (found[0], found[1], True, True)
    finally:
        c = torch.backends.cudnn
        c.benchmark, c.deterministic, c.allow_tf32 = found[:3]
        torch.backends.cuda.matmul.allow_tf32 = found[3]

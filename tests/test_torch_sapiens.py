"""The port's Sapiens and U²-Net (forge_tpu_torch/models/sapiens.py,
models/u2net.py) against forge_tpu's on the CPU, f32, on small networks in
the Spaces' key layouts (tests/torch_spaces_cases.py).

`sapiens_apply` at the Space's 1024×768 feed and `u2net_apply` (on sizes
the pools halve with a remainder) agree within 1e-4 of the largest
reference value; the U²-Net mask within 1e-4, and the cutouts (RGBA and a
flat background) and the normal map (with and without the U²-Net mask)
within one level, on 2 % of the values or fewer (the uint8 conversion
truncates). Missing checkpoints raise forge_tpu's RuntimeError texts.
Sapiens-1B at its published widths on the meta device makes exactly 40
flash calls at q(1,24,3072,64) on the tensor-core body, and its head gives
the 256×192 normals.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_spaces_cases import (image, nchw, nhwc, port_tree, reference_tree, rel_err,  # noqa: E402
                                tiny_sd, write)

TOL = 1e-4


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def near(got, want, share=0.02):
    """Within one level, on `share` of the values or fewer: the mask's f32
    difference from forge_tpu's (≤ 1e-4 of its range) times 255 moves a value
    across an integer where the uint8 conversion truncates it."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return got.shape == want.shape and diff.max() <= 1 and (diff > 0).mean() <= share


def test_sapiens_apply_matches_reference():
    from forge_tpu.models import sapiens as ref
    from forge_tpu_torch.models import sapiens

    sd = tiny_sd("sapiens")
    x = np.random.default_rng(1).standard_normal((1, 1024, 768, 3)).astype(np.float32)
    want = np.asarray(ref.sapiens_apply(reference_tree(sd), jnp.asarray(x)))
    got = nhwc(sapiens.sapiens_apply(port_tree(sd), nchw(x)))
    assert got.shape == want.shape == (1, 256, 192, 3)
    assert rel_err(got, want) < TOL
    assert (sapiens.INPUT_H, sapiens.INPUT_W) == (ref.INPUT_H, ref.INPUT_W)
    assert np.array_equal(sapiens.MEAN, ref.MEAN) and np.array_equal(sapiens.STD, ref.STD)


@pytest.mark.parametrize("h,w", [(64, 48), (50, 70)])
def test_u2net_apply_matches_reference(h, w):
    from forge_tpu.models import u2net as ref
    from forge_tpu_torch.models import u2net

    sd = tiny_sd("u2net")
    x = np.random.default_rng(h).standard_normal((1, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ref.u2net_apply)(reference_tree(sd), jnp.asarray(x)))
    got = nhwc(u2net.u2net_apply(port_tree(sd), nchw(x)))
    assert got.shape == want.shape == (1, h, w, 1)
    assert rel_err(got, want) < TOL


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    return write(root, "sapiens"), write(root, "u2net")


@pytest.mark.parametrize("size", [320, 64])
def test_matter_matches_reference(models, size):
    from forge_tpu.models import u2net as ref
    from forge_tpu_torch.models import u2net

    reference = ref.U2NetMatter(models[1])
    port = u2net.U2NetMatter(models[1], device="cpu")
    img = image(11, 90, 120)
    assert rel_err(port.mask(img, size=size), reference.mask(img, size=size)) < TOL
    for flat in (None, (30, 200, 90)):
        want = reference.cutout(img, flat_bg=flat, size=size)
        got = port.cutout(img, flat_bg=flat, size=size)
        assert got.shape == (90, 120, 4 if flat is None else 3) and near(got, want)


@pytest.mark.parametrize("mask", [True, False])
def test_normals_match_reference(models, mask):
    from forge_tpu.models import sapiens as ref
    from forge_tpu_torch.models import sapiens

    img = image(12, 150, 100)
    reference = ref.SapiensNormal(model_dir=models[0], mask_model_dir=models[1])
    port = sapiens.SapiensNormal(model_dir=models[0], mask_model_dir=models[1], device="cpu")
    want = reference.normals(img, mask_background=mask)
    got = port.normals(img, mask_background=mask)
    assert got.dtype == np.uint8 and near(got, want)
    # the masked background (−1, −1, −1): (1 − 1/√3) / 2 · 255 → 53 on each channel
    assert (got == 53).all(-1).any() == mask


def test_missing_checkpoints_raise_reference_errors(tmp_path):
    from forge_tpu.models import sapiens as ref_sapiens
    from forge_tpu.models import u2net as ref_u2net
    from forge_tpu_torch.models import sapiens, u2net

    img = image(0, 32, 32)
    for ref_obj, obj, call in ((ref_sapiens.SapiensNormal(str(tmp_path)),
                                sapiens.SapiensNormal(str(tmp_path), device="cpu"), "normals"),
                               (ref_u2net.U2NetMatter(str(tmp_path)),
                                u2net.U2NetMatter(str(tmp_path), device="cpu"), "mask")):
        with pytest.raises(RuntimeError) as want:
            getattr(ref_obj, call)(img)
        with pytest.raises(RuntimeError) as got:
            getattr(obj, call)(img)
        assert str(got.value) == str(want.value) and not obj.available


def test_sapiens_1b_at_published_width_on_meta(monkeypatch):
    from test_torch_extras_trace import meta_tree

    from forge_tpu_torch.core.synth_annotators import synth_sapiens_sd
    from forge_tpu_torch.models import sapiens
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops.flash_attention import flash_body

    calls = []

    def flash(q, k, v, scale=None, body=None):
        calls.append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    monkeypatch.setattr(attention_mod, "flash_attention", flash)
    tree = meta_tree(synth_sapiens_sd(fill="zeros"))
    assert tree["blocks"]["0"]["attn"]["qkv"]["weight"].shape == (3 * 1536, 1536)
    x = torch.empty((1, 3, sapiens.INPUT_H, sapiens.INPUT_W), device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        out = sapiens.sapiens_apply(tree, x)
    assert tuple(out.shape) == (1, 3, 256, 192)
    assert calls == [((1, 24, 3072, 64), 3072, "wgmma")] * 40


def test_phase_24_counts():
    """chip_smoke's phase 24: the Sapiens row in phase 2, a forward's flash launches, and the
    unit's request counted as phase 21's ControlNet request (OneFormer launches no kernel)."""
    import chip_smoke

    assert ((1, 24, 3072, 64), 3072, True) in chip_smoke.FLASH_SHAPES
    assert chip_smoke.SAPIENS_FLASH == 40 and chip_smoke.SAPIENS_CUT == 8
    for steps in (4, 20):
        counts = chip_smoke.spaces_counts(steps, 40)
        surface = chip_smoke.surface_counts(steps)
        assert counts["witness"] == surface["witness"]
        assert counts["ControlNetScript"] == surface["ControlNetScript"]
        assert counts["sapiens"]["flash_attention"] == 40
        assert counts["detect"] == dict.fromkeys(("flash_attention", "gn_silu_conv3x3",
                                                  "dequant_matmul"), 0)
    assert set(chip_smoke.ONEFORMER_ENTRIES) | set(chip_smoke.DENSEPOSE_ENTRIES) == {
        "seg_ofade20k", "seg_ofcoco", "densepose (pruple bg & purple torso)",
        "densepose_parula (black bg & blue torso)"}
    from forge_tpu_torch.runtime.spaces import PORT_APPS

    # phase 24 launches the four Spaces on networks of their own, phase 25 the six on
    # diffusion engines
    assert set(chip_smoke.SPACE_NAMES) | set(chip_smoke.DIFFUSION_SPACE_NAMES) == set(PORT_APPS)
    assert not set(chip_smoke.SPACE_NAMES) & set(chip_smoke.DIFFUSION_SPACE_NAMES)

"""The port's LaMa (forge_tpu_torch/preprocessors/lama.py) and the
inpaint_only+lama unit against forge_tpu's on the CPU, f32.

`lama_apply` (the FFC generator: rfft2 and irfft2 in f32, the spectral
transform on interleaved real and imaginary channels, the transpose-conv
upsamples) agrees with forge_tpu's `lama_apply` within 1e-4 of the largest
reference value on a small big-lama (tests/torch_interrogate_cases.py);
the detector's `inpaint` (the 256 short side, the binarized mask, the
paste and the soft blend) gives forge_tpu's uint8 image within one level
on at most 0.5 % of the pixels. The unit goes through both packages'
`process_images` on the tiny SDXL with a tiny ControlNet and without a
model (tests/torch_controls_cases.py), forge_tpu's pre-fill handed the
port's so that the request alone is compared: the hint on the pre-fill,
both composites and the start latent moved toward the pre-fill's latent,
at ≥ 80 dB with the reference's infotexts. Without the checkpoint the
registry's entry and the unit raise forge_tpu's RuntimeError.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
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


@pytest.mark.parametrize("seed,h,w", [(0, 64, 96), (1, 40, 32)])
def test_lama_apply_matches_reference(seed, h, w):
    from forge_tpu.preprocessors.lama import lama_apply as ref
    from forge_tpu_torch.preprocessors.lama import lama_apply

    sd = tiny_sd("lama", seed=seed)
    x = np.random.default_rng(seed).random((1, h, w, 4)).astype(np.float32)
    want = np.asarray(ref(reference_tree(sd), jnp.asarray(x)))
    got = nhwc(lama_apply(port_tree(sd), nchw(x)))
    assert got.shape == want.shape == (1, h, w, 3)
    assert rel_err(got, want) < TOL


@pytest.fixture(scope="module")
def lama_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    write(root, "lama")
    return os.path.join(root, "lama")


def _mask(h, w, soft=False):
    m = np.zeros((h, w), np.float32)
    m[h // 4:3 * h // 4, w // 3:5 * w // 6] = 1.0
    if soft:
        m = cv2.GaussianBlur(m, (0, 0), 3)
    return m


@pytest.mark.parametrize("h,w,soft", [(80, 96, False), (100, 70, True)])
def test_inpaint_matches_reference(lama_dir, h, w, soft):
    from forge_tpu.preprocessors.lama import LamaDetector as Ref
    from forge_tpu_torch.preprocessors.lama import LamaDetector

    img, mask = image(4, h, w), _mask(h, w, soft)
    got = LamaDetector(model_dir=lama_dir, device="cpu").inpaint(img, mask)
    want = Ref(model_dir=lama_dir).inpaint(img, mask)
    diff = np.abs(got.astype(np.int16) - want)
    assert got.shape == img.shape and got.dtype == np.uint8
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    keep = mask == 0
    assert np.array_equal(got[keep], img[keep]) and not np.array_equal(got, img)


@pytest.fixture(scope="module")
def engines():
    from torch_controls_cases import sdxl_engines

    return sdxl_engines()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from test_torch_control_units import _save
    from test_torch_controlnet import tiny_controlnet_sd

    d = tmp_path_factory.mktemp("ControlNet")
    _save(tiny_controlnet_sd(seed=23), d / "cldm_tiny_xl.safetensors")
    return str(d)


@pytest.mark.parametrize("model", ["cldm_tiny_xl", None])
def test_unit_request_matches_forge_tpu(engines, model_dir, lama_dir, monkeypatch, model):
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu.preprocessors import lama as jlama
    from forge_tpu_torch.extensions import controlnet as tcn
    from forge_tpu_torch.pipeline.cn_inpaint import feather_mask
    from forge_tpu_torch.preprocessors import lama
    from torch_controls_cases import SDXL_REQUEST, assert_slice, processing, run_both

    monkeypatch.setattr(lama, "_DETECTOR", lama.LamaDetector(model_dir=lama_dir, device="cpu"))
    monkeypatch.setattr(jlama, "lama_prefill", lama.lama_prefill)  # the same pre-fill
    img = image(8, 64, 64)
    mask = (_mask(64, 64) * 255).astype(np.uint8)
    unit = dict(module="inpaint_only+lama", image=img, mask=mask)
    if model:
        unit["model"] = model

    def attach(package, p):
        ext = jcn if package == "forge_tpu" else tcn
        ext.set_model_dirs([model_dir])
        kw = {} if package == "forge_tpu" else {"device": "cpu"}
        assert ext.attach_units(p, [unit], **kw) == 1

    try:
        got, want, tp = run_both(engines, dict(SDXL_REQUEST), attach)
    finally:
        for ext in (jcn, tcn):
            ext.set_model_dirs(["models/ControlNet", "models/controlnet"])
            ext._MODEL_CACHE.clear()
    print(model, assert_slice(got, want))
    assert tp._cn_inpaint["lama_shift"] is True
    prefill = lama.lama_prefill(img, mask / 255.0)
    assert np.allclose(tp._cn_inpaint["image"] * 255.0, prefill, atol=1e-3)
    tproc = processing("forge_tpu_torch")
    plain = tproc.process_images(engines[1], tproc.Processing(**SDXL_REQUEST))
    assert not np.array_equal(got.images[0], plain.images[0])
    keep = feather_mask(tp._cn_inpaint["mask"]) == 0  # the source outside the feathered mask
    src = np.clip(tp._cn_inpaint["image"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert keep.any() and np.array_equal(got.images[0][keep], src[keep])


def test_missing_checkpoint_raises_the_reference_error(monkeypatch, tmp_path):
    from forge_tpu.preprocessors import get_preprocessor as ref
    from forge_tpu.preprocessors import lama as jlama
    from forge_tpu_torch.extensions.controlnet import build_unit_state
    from forge_tpu_torch.preprocessors import PREPROCESSORS
    from forge_tpu_torch.preprocessors import lama

    monkeypatch.setattr(lama, "_DETECTOR", lama.LamaDetector(model_dir=str(tmp_path),
                                                             device="cpu"))
    monkeypatch.setattr(jlama, "_DET", jlama.LamaDetector(model_dir=str(tmp_path)))
    img = image(0, 32, 32)
    with pytest.raises(RuntimeError) as want:
        ref("inpaint_only+lama")(img, 32)
    with pytest.raises(RuntimeError) as got:
        PREPROCESSORS["inpaint_only+lama"](img, 32, 0, 0)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="ControlNetLama.pth"):
        build_unit_state(dict(module="inpaint_only+lama", image=img), 32, 32, device="cpu")

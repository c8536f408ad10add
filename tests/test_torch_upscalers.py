"""The port's `pipeline/upscalers.py` against forge_tpu's (CPU, f32).

RRDBNet at a small width (8 features, 2 RRDBs, growth 4; ×4 and ×2) from
one numpy state dict through both packages within 1e-5 of the output's
scale; the old `model.N` key layout; the tiled upscale with its feathered
seams on a 40² image in 16² tiles at overlap 4 within 1e-5; Lanczos and
Nearest bit-equal to Pillow's through forge_tpu; the registry's discovery
of a `.safetensors` and a `.pth` file (the other architectures it runs:
tests/test_torch_swinir.py, tests/test_torch_upscalers_extra.py). Two faults on the reference's side are shown from both sides:
its key conversion raises IndexError on an old-layout conv_body, and its
`.pth` reader loads a `params_ema`-wrapped file (RealESRGAN's own layout)
empty.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest  # noqa: E402

TINY = dict(num_feat=8, num_block=2, num_grow=4)


def tiny_esrgan_sd(scale=4, old_layout=False):
    """A tiny RRDBNet with weights large enough that every layer moves the output."""
    from forge_tpu_torch.core.synth import synth_esrgan_sd

    sd = synth_esrgan_sd(scale=scale, old_layout=old_layout, fill="random", seed=21, **TINY)
    return {k: (v * 12.0 if k.endswith("weight") else v + 0.01).astype(np.float32)
            for k, v in sd.items()}


def _jax_fn(sd, scale):
    from forge_tpu.pipeline.upscalers import rrdbnet_apply as japply

    params = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})
    return lambda x: japply(params, x, scale)


def _port_fn(sd, scale):
    from forge_tpu_torch.pipeline.upscalers import rrdbnet_apply

    params = nest({k: torch.from_numpy(v) for k, v in sd.items()})
    return lambda x: rrdbnet_apply(params, x, scale)


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_matches_forge_tpu(scale):
    sd = tiny_esrgan_sd(scale)
    x = np.random.default_rng(1).uniform(size=(2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(_jax_fn(sd, scale)(jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = _port_fn(sd, scale)(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == (2, 3, 12 * scale, 10 * scale) == want.shape
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_params_from_jax_carries_the_rrdbnet_tree():
    """forge_tpu's RRDBNet tree (HWIO kernels) back to the port's flat OIHW state dict."""
    from forge_tpu_torch.core.convert import params_from_jax

    sd = tiny_esrgan_sd()
    got = params_from_jax(jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()}))
    assert sorted(got) == sorted(sd)
    for key, value in sd.items():
        assert np.array_equal(got[key].numpy(), value), key


def test_convert_esrgan_keys_old_layout():
    """The old `model.N` keys map to the new names with the same arrays; the
    reference agrees on every key but conv_body's, where it raises
    IndexError (fault on its side: `model.1.sub.{nb}.weight` has 5 parts)."""
    from forge_tpu.pipeline.upscalers import convert_esrgan_keys as jconvert
    from forge_tpu_torch.pipeline.upscalers import convert_esrgan_keys

    old, new = tiny_esrgan_sd(old_layout=True), tiny_esrgan_sd()
    got = convert_esrgan_keys(old)
    assert sorted(got) == sorted(new)
    for key, value in new.items():
        assert np.array_equal(got[key], value), key
    assert convert_esrgan_keys(new) == new
    body_key = f"model.1.sub.{TINY['num_block']}.weight"
    without_body = {k: v for k, v in old.items() if not k.startswith(body_key[:-len("weight")])}
    want = jconvert(without_body)
    assert want.keys() == {k: v for k, v in got.items() if not k.startswith("conv_body")}.keys()
    for key, value in want.items():
        assert np.array_equal(got[key], value), key
    with pytest.raises(IndexError):
        jconvert(old)


def test_tiled_upscale_matches_forge_tpu():
    from forge_tpu.pipeline.upscalers import tiled_upscale as jtiled
    from forge_tpu_torch.pipeline.upscalers import tiled_upscale

    sd = tiny_esrgan_sd()
    img = np.random.default_rng(2).uniform(size=(40, 40, 3)).astype(np.float32)
    want = jtiled(img, _jax_fn(sd, 4), 4, tile_size=16, overlap=4)
    port = _port_fn(sd, 4)
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        with torch.no_grad():
            return port(x)

    got = tiled_upscale(img, fn, 4, tile_size=16, overlap=4)
    assert got.shape == want.shape == (160, 160, 3) and got.dtype == np.float32
    assert len(calls) == 9 and set(calls) == {(1, 3, 16, 16)}  # 3 × 3 tiles, the last ones flush
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["Lanczos", "Nearest"])
@pytest.mark.parametrize("shape,scale", [((24, 20), 2.0), ((24, 20), 1.5), ((33, 17), 0.5),
                                         ((16, 16), 4.0), ((40, 30), 0.37)])
def test_upscale_pil_bit_equal_to_pillow(mode, shape, scale):
    """Pillow's LANCZOS and NEAREST (through forge_tpu's `upscale_pil`), bit for bit."""
    from forge_tpu.pipeline.upscalers import upscale_pil as jupscale
    from forge_tpu_torch.pipeline.upscalers import upscale_pil

    img = np.random.default_rng(3).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    want = jupscale(img, scale, mode)
    got = upscale_pil(img, scale, mode)
    assert got.shape == want.shape == (int(shape[0] * scale), int(shape[1] * scale), 3)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from forge_tpu_torch.core.save import save_safetensors

    d = tmp_path_factory.mktemp("ESRGAN")
    sd = tiny_esrgan_sd()
    save_safetensors(sd, str(d / "tiny_x4.safetensors"))
    torch.save({"params_ema": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(d / "tiny_ema.pth"))
    return d


def test_registry_discovers_and_upscales(model_dir):
    """Both files are found under their names; the `.safetensors` upscales
    as forge_tpu's registry does (within 1 of 255: the last step truncates
    to uint8), ×4 and ×2 (the model's ×4, then Lanczos ½)."""
    from forge_tpu.pipeline.upscalers import UpscalerRegistry as JRegistry
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry

    reg = UpscalerRegistry(model_dirs={"ESRGAN": str(model_dir)}, device="cpu")
    jreg = JRegistry(model_dirs={"ESRGAN": str(model_dir)})
    names = {"None", "Lanczos", "Nearest", "tiny_x4", "tiny_ema"}
    assert set(reg.upscalers) == set(jreg.upscalers) == names
    img = np.random.default_rng(4).integers(0, 256, size=(24, 20, 3), dtype=np.uint8)
    for scale in (4.0, 2.0):
        want = jreg.get("tiny_x4").upscale(img, scale)
        got = reg.get("TINY_X4").upscale(img, scale)
        assert got.shape == want.shape == (int(24 * scale), int(20 * scale), 3)
        assert got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())
        assert got.std() > 10
    assert reg.get("None").upscale(img, 2.0) is img
    with pytest.raises(KeyError, match="unknown upscaler"):
        reg.get("SwinIR_4x")


def test_registry_reads_a_params_ema_pth(model_dir):
    """RealESRGAN's `.pth` layout ({"params_ema": {...}}) upscales with the
    weights of the same model's `.safetensors`. Fault on the reference's
    side, shown from both sides: its reader drops the nested dict and
    returns no keys, so its registry cannot build the model."""
    from forge_tpu.core.state_dict import load_state_dict as jload
    from forge_tpu_torch.core.state_dict import load_state_dict
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry

    path = str(model_dir / "tiny_ema.pth")
    assert jload(path) == {}
    got = load_state_dict(path)
    assert list(got) == ["params_ema"]
    sd = tiny_esrgan_sd()
    assert all(np.array_equal(got["params_ema"][k], v) for k, v in sd.items())
    reg = UpscalerRegistry(model_dirs={"ESRGAN": str(model_dir)}, device="cpu")
    img = np.random.default_rng(5).integers(0, 256, size=(20, 20, 3), dtype=np.uint8)
    assert np.array_equal(reg.get("tiny_ema").upscale(img, 4.0),
                          reg.get("tiny_x4").upscale(img, 4.0))

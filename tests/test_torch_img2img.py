"""The port's img2img modules against forge_tpu (CPU, f32): the VAE encoder,
the resizes, the inpaint mask geometry, Canny, the safetensors writer.

Each test feeds the same numpy inputs, made from a seed, through both
packages. The VAE encoder agrees to 1e-4 of its output's scale (f32 on both
sides; only summation order differs); Lanczos resizes to 1 uint8 level of
Pillow's (the reference's resizer); the crop regions and Canny exactly; the
latent mask to 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.synth import synth_vae_sd  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest  # noqa: E402


def _assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


# -- models/vae.py, pipeline/engine.py ----------------------------------------------


@pytest.fixture(scope="module")
def vae_sd():
    return synth_vae_sd(ch=32, fill="random", seed=21, prefix="")


@pytest.mark.parametrize("with_noise", [False, True])
def test_vae_encode_matches(vae_sd, with_noise):
    """The encoder stack (two levels of asymmetric-pad downsampling here:
    ch_mult (1, 2, 4, 4)), quant_conv and the posterior's mean, or
    mean + std·noise."""
    from forge_tpu.models.vae import vae_encode as jencode
    from forge_tpu_torch.models.vae import vae_encode

    r = np.random.default_rng(3)
    x = r.uniform(-1, 1, size=(2, 3, 40, 24)).astype(np.float32)
    noise = r.standard_normal((2, 4, 5, 3)).astype(np.float32) if with_noise else None
    jtree = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(vae_sd).items()})
    want = jencode(jtree, jnp.asarray(x.transpose(0, 2, 3, 1)),
                   noise=None if noise is None else jnp.asarray(noise.transpose(0, 2, 3, 1)))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    tree = nest({k: torch.from_numpy(v) for k, v in vae_sd.items()})
    with torch.no_grad():
        got = vae_encode(tree, torch.from_numpy(x),
                         noise=None if noise is None else torch.from_numpy(noise)).numpy()
    assert got.shape == (2, 4, 5, 3)
    _assert_close(got, want)
    if with_noise:
        assert np.abs(got - vae_encode(tree, torch.from_numpy(x)).numpy()).max() > 1e-3


def test_encode_first_stage_matches():
    """images in [-1, 1] → the regulated (× 0.13025) f32 latent, both engines
    loading the same tiny SDXL checkpoint."""
    from test_torch_sdxl import _jax_engine, _port_engine, _tiny_sdxl_checkpoint

    sd = _tiny_sdxl_checkpoint()
    jeng, teng = _jax_engine(sd), _port_engine(sd)
    x = np.random.default_rng(4).uniform(-1, 1, size=(1, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jeng.encode_first_stage(jnp.asarray(x))).transpose(0, 3, 1, 2)
    got = teng.encode_first_stage(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert got.dtype == torch.float32 and got.shape == (1, 4, 8, 6)
    _assert_close(got.numpy(), want)


# -- pipeline/images.py, pipeline/masking.py, ops/resize.py --------------------------


RESIZES = [((64, 64), (48, 80)), ((100, 37), (64, 64)), ((256, 256), (64, 64)),
           ((30, 50), (97, 13)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_init_image_matches(mode, src, dst):
    from forge_tpu.pipeline.images import resize_init_image as jresize
    from forge_tpu_torch.pipeline.images import resize_init_image

    img = np.random.default_rng(5).integers(0, 256, size=src + (3,)).astype(np.uint8)
    h, w = dst
    want = jresize(img, w, h, mode=mode)
    got = resize_init_image(img, w, h, mode=mode)
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_masking_resize_image_matches(channels, src, dst):
    from forge_tpu.pipeline.masking import resize_image as jresize
    from forge_tpu_torch.pipeline.masking import resize_image

    shape = src if channels is None else src + (channels,)
    img = np.random.default_rng(6).uniform(-20, 280, size=shape).astype(np.float32)
    h, w = dst
    want, got = jresize(img, w, h), resize_image(img, w, h)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("box,pad,size", [
    ((10, 20, 30, 25), 0, (64, 64)), ((10, 20, 30, 25), 8, (64, 32)),
    ((0, 0, 5, 60), 32, (48, 64)), ((50, 40, 64, 64), 4, (64, 64)), (None, 4, (64, 64))])
def test_crop_regions_match_exactly(box, pad, size):
    from forge_tpu.pipeline.masking import expand_crop_region as jexpand
    from forge_tpu.pipeline.masking import get_crop_region as jcrop
    from forge_tpu_torch.pipeline.masking import expand_crop_region, get_crop_region

    mask = np.zeros((64, 64), np.float32)
    if box is not None:
        x1, y1, x2, y2 = box
        mask[y1:y2, x1:x2] = 1.0
    want, got = jcrop(mask, pad), get_crop_region(mask, pad)
    assert got == want
    if want is not None:
        w, h = size
        assert expand_crop_region(got, w, h, 64, 64) == jexpand(want, w, h, 64, 64)


@pytest.mark.parametrize("src,dst,antialias", [
    ((64, 64), (8, 8), True), ((1024, 1024), (128, 128), True), ((40, 24), (5, 3), True),
    ((8, 8), (16, 12), False), ((8, 6), (3, 5), False), ((33, 17), (8, 40), True)])
def test_latent_mask_resize_matches(src, dst, antialias):
    """The reference takes the blurred mask to latent size with
    jax.image.resize, antialiased; "latent" resize mode without."""
    import jax

    from forge_tpu_torch.ops.resize import resize_bilinear

    m = np.random.default_rng(7).uniform(size=src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), dst, "bilinear", antialias=antialias))
    got = resize_bilinear(m, dst, antialias=antialias)
    assert np.abs(got - want).max() <= 1e-5
    lat = np.random.default_rng(8).standard_normal((1, 4) + src).astype(np.float32)
    want4 = np.asarray(jax.image.resize(jnp.asarray(lat), (1, 4) + dst, "bilinear",
                                        antialias=antialias))
    got4 = resize_bilinear(torch.from_numpy(lat), dst, antialias=antialias).numpy()
    assert np.abs(got4 - want4).max() <= 1e-5 * max(np.abs(want4).max(), 1.0)


# -- preprocessors/cv.py, core/save.py -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_canny_matches_exactly(seed):
    from forge_tpu.preprocessors.cv import canny as jcanny
    from forge_tpu_torch.preprocessors.cv import canny

    r = np.random.default_rng(seed)
    img = r.integers(0, 256, size=(96, 80, 3)).astype(np.uint8)
    img[20:60, 16:50] = 230  # a square whose outline is an edge
    want, got = jcanny(img), canny(img)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert 0.0 < got.mean() < 1.0


def test_save_safetensors_round_trip(tmp_path):
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.state_dict import load_safetensors

    r = np.random.default_rng(9)
    sd = {"b.lora_up.weight": r.standard_normal((8, 2)).astype(np.float32),
          "a.alpha": np.asarray(2.0, np.float32),
          "c.half": r.standard_normal((3, 5, 1, 1)).astype(np.float16),
          "d.ints": r.integers(-5, 5, size=(7,)).astype(np.int64),
          "e.bytes": r.integers(0, 255, size=(2, 3)).astype(np.uint8)}
    path = str(tmp_path / "x.safetensors")
    save_safetensors(sd, path)
    back = load_safetensors(path)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    st = pytest.importorskip("safetensors.numpy")
    other = st.load_file(path)  # the safetensors package reads what the port wrote
    for k, v in sd.items():
        assert np.array_equal(other[k], v), k
    ref_path = str(tmp_path / "ref.safetensors")
    st.save_file(sd, ref_path, metadata={"format": "pt"})
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()  # byte for byte what the package writes

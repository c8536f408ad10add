"""The port's MultiDiffusion tiling against forge_tpu (CPU, f32).

`split_bboxes` and the Gaussian blend weights equal the reference's;
`make_tiled_apply` equals the reference's wrapper on a local model (1e-6 of
its scale) and the untiled model where the model is pointwise
(tests/test_extensions.py's case); the tiny SDXL img2img slice with
`tiled_diffusion` (64×96, 2 tiles of 8 latent pixels, Euler, 8 steps at
strength 0.5, CFG 7) matches forge_tpu at PSNR ≥ 80 dB. With an IP-Adapter
every tile's forward applies the adapter in the port; in forge_tpu only the
first tile's does (its layer counter runs on past the first forward).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_ipadapter import _ip_hooks, ip_trees, unet_trees  # noqa: E402,F401
from test_torch_sdxl import _jax_engine, _port_engine, _psnr, _tiny_sdxl_checkpoint  # noqa: E402

W, H = 64, 96
TILES = {"tile": 8, "overlap": 4}  # a 12×8 latent: tiles start at rows 0 and 4
REQUEST = dict(prompt="a castle on a hill", negative_prompt="blurry", seed=1, steps=8,
               width=W, height=H, sampler_name="Euler", cfg_scale=7.0,
               denoising_strength=0.5)


@pytest.mark.parametrize("size,tile,overlap", [(64, 96, 32), (128, 96, 32), (256, 96, 16),
                                               (12, 8, 4), (100, 96, 32), (300, 64, 16)])
def test_split_bboxes_matches(size, tile, overlap):
    from forge_tpu.sampling.tiled import split_bboxes as jsplit
    from forge_tpu_torch.sampling.tiled import split_bboxes

    assert split_bboxes(size, tile, overlap) == jsplit(size, tile, overlap)
    assert split_bboxes(256, 96, 16) == [0, 80, 160]  # config 5's 2048² canvas: 3 × 3 tiles


@pytest.mark.parametrize("h,w", [(96, 96), (8, 8), (7, 12)])
def test_gaussian_weights_match(h, w):
    from forge_tpu.sampling.tiled import _gaussian_weights as jweights
    from forge_tpu_torch.sampling.tiled import _gaussian_weights

    got = _gaussian_weights(h, w)
    assert got.shape == (h, w) and got.dtype == np.float32
    assert np.array_equal(got, jweights(h, w)[..., 0])


def test_tiled_apply_equals_untiled_for_a_pointwise_model():
    from forge_tpu_torch.sampling.tiled import make_tiled_apply

    tiled = make_tiled_apply(lambda x, sigma, cond: x * 0.5, 16, 16, tile=8, overlap=4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 16, 16)).astype(np.float32))
    torch.testing.assert_close(tiled(x, 1.0, {}), x * 0.5, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,tile,overlap", [((2, 4, 12, 12), 8, 4), ((4, 4, 20, 13), 8, 2),
                                                ((2, 4, 6, 6), 8, 4)])
def test_tiled_apply_matches(shape, tile, overlap):
    """A model that mixes neighbours (a 3×3 box blur, so tiles see their own
    borders) and reads σ and the cond: the port's wrapper against the
    reference's, 1e-6 of the output's scale."""
    import torch.nn.functional as F

    from forge_tpu.sampling.tiled import make_tiled_apply as jmake
    from forge_tpu_torch.sampling.tiled import make_tiled_apply

    def tmodel(x, sigma, cond):
        box = F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), 3, stride=1)
        return torch.tanh(box) * sigma + cond["c"][:, :, None, None]

    def jmodel(x, sigma, cond):
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        box = sum(xp[:, i:i + x.shape[1], j:j + x.shape[2]] for i in range(3) for j in range(3)) / 9
        return jnp.tanh(box) * sigma + cond["c"][:, None, None, :]

    r = np.random.default_rng(2)
    x = r.standard_normal(shape).astype(np.float32)
    c = r.standard_normal(shape[:2]).astype(np.float32)
    b, ch, h, w = shape
    want = jmake(jmodel, h, w, tile=tile, overlap=overlap)(
        jnp.asarray(x.transpose(0, 2, 3, 1)), 0.7, {"c": jnp.asarray(c)})
    got = make_tiled_apply(tmodel, h, w, tile=tile, overlap=overlap)(
        torch.from_numpy(x), 0.7, {"c": torch.from_numpy(c)})
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.fixture(scope="module")
def engines():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


def _init_image():
    init = np.random.default_rng(0).uniform(0, 255, size=(H, W, 3)).astype(np.uint8)
    init[16:60, 20:50] //= 3
    return init


def test_tiled_img2img_matches_forge_tpu(engines):
    """img2img over a canvas denoised tile by tile, each tile's forward on
    the CFG batch, through `process_images` in both packages."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    jeng, teng = engines
    init = _init_image()
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST, init_images=[init],
                                                       tiled_diffusion=dict(TILES))).images[0]
    got = tproc.process_images(teng, tproc.Processing(**REQUEST, init_images=[init],
                                                      tiled_diffusion=dict(TILES))).images[0]
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
    value = _psnr(got, want)
    print(f"tiled img2img: PSNR {value:.2f} dB")
    assert value >= 80.0, value
    whole = tproc.process_images(teng, tproc.Processing(**REQUEST, init_images=[init])).images[0]
    assert _psnr(got, whole) < 60  # the tiles took part


def test_each_tile_forward_sees_the_cfg_batch(engines, monkeypatch):
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.sampling import tiled as tiled_mod

    teng = engines[1]
    shapes = []
    real = tiled_mod.make_tiled_apply

    def spy_make(apply_model, *args, **kwargs):
        def spy(x, sigma, cond):
            shapes.append((tuple(x.shape), cond["context"].shape[0]))
            return apply_model(x, sigma, cond)

        return real(spy, *args, **kwargs)

    monkeypatch.setattr(tproc, "make_tiled_apply", spy_make)
    tproc.process_images(teng, tproc.Processing(**REQUEST, init_images=[_init_image()],
                                                batch_size=2, tiled_diffusion=dict(TILES)))
    calls = min(int(0.5 * 8), 7) + 1  # the schedule's tail: 5 model calls
    assert shapes == [((4, 4, 8, 8), 4)] * (calls * 2)


def test_unported_tiled_diffusion_keys_raise(engines):
    from forge_tpu_torch.pipeline import processing as tproc

    p = tproc.Processing(**REQUEST, init_images=[_init_image()],
                         tiled_diffusion={"tile": 8, "method": "Mixture of Diffusers"})
    with pytest.raises(NotImplementedError, match="method"):
        tproc.process_images(engines[1], p)


def test_every_tile_applies_the_ip_adapter(unet_trees, ip_trees):  # noqa: F811
    """Tiles and an IP-Adapter together (a 12×8 latent: 2 tiles of 8): in
    the port each tile's forward runs the adapter at all 4 cross-attentions;
    in forge_tpu the second tile's calls find no layer under the counter and
    return the plain attention (under jit the tiles' forwards are one trace:
    the same)."""
    from forge_tpu.models.unet import unet_apply as junet
    from forge_tpu.ops.attention import attention as jattention
    from forge_tpu.sampling.tiled import make_tiled_apply as jmake
    from forge_tpu_torch.models.unet import unet_apply
    from forge_tpu_torch.ops.attention import attention
    from forge_tpu_torch.sampling.tiled import make_tiled_apply
    from test_torch_controlnet import jcfg, tcfg
    from test_torch_ipadapter import _unet_inputs

    jhooks, thooks = _ip_hooks(ip_trees, batch_size=1)
    moved = {"port": [], "reference": []}

    def spying(hooks, attend, log):
        inner = hooks["attn2_replace_all"]

        def spy(q, k, v, extra):
            out = inner(q, k, v, extra)
            log.append(bool(np.abs(np.asarray(out) - np.asarray(attend(q, k, v, heads=extra["n_heads"]))).max() > 0))
            return out

        return {"attn2_replace_all": spy}

    jtree, tree = unet_trees
    x, t, ctx, y = _unet_inputs()
    x = np.random.default_rng(6).standard_normal((2, 4, 12, 8)).astype(np.float32)
    jh = spying(jhooks, jattention, moved["reference"])
    th = spying(thooks, attention, moved["port"])
    jmake(lambda xi, s, c: junet(jtree, xi, jnp.asarray(t), jnp.asarray(ctx), y=jnp.asarray(y),
                                 cfg=jcfg(), hooks=jh), 12, 8, tile=8, overlap=4)(
        jnp.asarray(x.transpose(0, 2, 3, 1)), 1.0, {})
    with torch.no_grad():
        make_tiled_apply(lambda xi, s, c: unet_apply(tree, xi, torch.from_numpy(t),
                                                     torch.from_numpy(ctx), y=torch.from_numpy(y),
                                                     cfg=tcfg(), hooks=th), 12, 8, tile=8,
                         overlap=4)(torch.from_numpy(x), 1.0, {})
    assert moved["port"] == [True] * 8
    assert moved["reference"] == [True] * 4 + [False] * 4

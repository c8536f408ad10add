"""The T2I-Adapter (models/t2i_adapter.py) against forge_tpu (CPU, f32):
the pixel unshuffle's channel order on NCHW, `detect_adapter_config` and
`adapter_apply` at the SD layout (unshuffle 8, features on input slots
3i + 2) and the XL layout (unshuffle 16, 3·16² = 768 channels in,
features on slots 3, 5, 8 and the middle block), `skep` reading the x
`block1` saw, `run_controlnets` with an adapter state (gate, strength,
block weights, the CFG batch), one UNet forward with its features, and a
"canny" T2I-Adapter unit through both `process_images` on the tiny SDXL and
SD1.5 (PSNR ≥ 80 dB)."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest  # noqa: E402
from test_torch_block_patches import _unet_sd  # noqa: E402
from test_torch_controlnet import jcfg, tcfg  # noqa: E402
from test_torch_ipadapter import _unet_inputs  # noqa: E402
from test_torch_sdxl import _assert_close  # noqa: E402
from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice,  # noqa: E402
                                  processing, run_both, sd15_engines, sdxl_engines)


def t2i_sd(cin, channels, nums_rb=1, downs=(), in_k=1, block2_k=3, skep_k=None, seed=11):
    """A T2I-Adapter state dict in the checkpoints' layout: conv_in, then
    `nums_rb` resblocks a stage, `down_opt` on the first block of each stage
    in `downs`, `in_conv` where the channels change, `skep` beside it when
    `skep_k` is given."""
    r = np.random.default_rng(seed)
    sd = {}

    def conv(key, o, i, k=3):
        sd[key + ".weight"] = (r.standard_normal((o, i, k, k)) * (0.5 / np.sqrt(i * k * k))
                               ).astype(np.float32)
        sd[key + ".bias"] = (0.05 * r.standard_normal(o)).astype(np.float32)

    conv("conv_in", channels[0], cin)
    prev = channels[0]
    for stage, ch in enumerate(channels):
        for j in range(nums_rb):
            idx = stage * nums_rb + j
            if j == 0 and stage in downs:
                conv(f"body.{idx}.down_opt.op", prev, prev)
            if ch != prev:
                conv(f"body.{idx}.in_conv", ch, prev, in_k)
                if skep_k:
                    conv(f"body.{idx}.skep", ch, ch, skep_k)
            conv(f"body.{idx}.block1", ch, ch)
            conv(f"body.{idx}.block2", ch, ch, block2_k)
            prev = ch
    return sd


SD_LAYOUT = dict(cin=192, channels=(8, 16, 32, 32), nums_rb=2, downs=(1, 2, 3))
XL_LAYOUT = dict(cin=768, channels=(8, 16, 32, 32), nums_rb=2, downs=(2,), block2_k=1,
                 skep_k=3)


def _trees(sd):
    return (jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()}),
            nest({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}))


def _hint(size=64, seed=3):
    return np.random.default_rng(seed).uniform(size=(1, 3, size, size)).astype(np.float32)


def test_pixel_unshuffle_matches():
    """torch's PixelUnshuffle, which the port's adapter takes, on NCHW is the
    reference's NHWC unshuffle transposed."""
    from forge_tpu.models.t2i_adapter import pixel_unshuffle as junshuffle
    from torch.nn.functional import pixel_unshuffle

    x = np.random.default_rng(0).standard_normal((2, 3, 32, 48)).astype(np.float32)
    for r in (2, 8, 16):
        got = pixel_unshuffle(torch.from_numpy(x), r).numpy()
        want = np.asarray(junshuffle(jnp.asarray(x.transpose(0, 2, 3, 1)), r)).transpose(0, 3, 1, 2)
        assert np.array_equal(got, want)
    # channel c·r² + i·r + j takes channel c at row offset i, column offset j
    got = pixel_unshuffle(torch.from_numpy(x), 2).numpy()
    assert np.array_equal(got[:, 1 * 4 + 1 * 2 + 0], x[:, 1, 1::2, 0::2])


@pytest.mark.parametrize("layout", ["SD", "XL"])
def test_adapter_apply_matches(layout):
    from forge_tpu.models.t2i_adapter import adapter_apply as japply
    from forge_tpu.models.t2i_adapter import detect_adapter_config as jdetect
    from forge_tpu_torch.models.t2i_adapter import adapter_apply, detect_adapter_config

    jtree, tree = _trees(t2i_sd(**(SD_LAYOUT if layout == "SD" else XL_LAYOUT)))
    cfg, jc = detect_adapter_config(tree), jdetect(jtree)
    assert (cfg.channels, cfg.nums_rb, cfg.xl, cfg.unshuffle) == (jc.channels, jc.nums_rb,
                                                                  jc.xl, jc.unshuffle)
    hint = _hint(64 if layout == "SD" else 128)
    with torch.no_grad():
        got = adapter_apply(tree, torch.from_numpy(hint))
    want = japply(jtree, jnp.asarray(hint.transpose(0, 2, 3, 1)))
    slots = [i for i, f in enumerate(got["input"]) if f is not None]
    assert slots == ([2, 5, 8, 11] if layout == "SD" else [3, 5, 8])
    assert len(got["middle"]) == (0 if layout == "SD" else 1)
    for kind in ("input", "middle"):
        assert len(got[kind]) == len(want[kind])
        for g, w in zip(got[kind], want[kind]):
            assert (g is None) == (w is None)
            if g is not None:
                _assert_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rel=1e-5)


TINY_XL = dict(cin=768, channels=(64, 64, 64, 64))  # the tiny SDXL's slot 3 and middle: 64 @ 4²


@pytest.mark.parametrize("kw,frac", [
    (dict(strength=1.0), 0.3),
    (dict(strength=0.6, block_weights=[1.0, 0.5, 0.0, 2.0]), 0.3),
    (dict(strength=1.0, start_percent=0.5), 0.3),
])
def test_run_controlnets_and_unet_with_adapter_match(kw, frac):
    from forge_tpu.models.controlnet import run_controlnets as jrun
    from forge_tpu.models.t2i_adapter import T2IAdapterState as JState
    from forge_tpu.models.unet import unet_apply as junet
    from forge_tpu_torch.models.controlnet import run_controlnets
    from forge_tpu_torch.models.t2i_adapter import T2IAdapterState
    from forge_tpu_torch.models.unet import unet_apply

    jtree, tree = _trees(t2i_sd(**TINY_XL))
    hint = _hint(64)
    x, t, ctx, y = _unet_inputs()
    jst = JState(params=jtree, hint=jnp.asarray(hint.transpose(0, 2, 3, 1)), **kw)
    st = T2IAdapterState(params=tree, hint=torch.from_numpy(hint), **kw)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = jrun([jst], jx, jnp.asarray(t), jnp.float32(frac), jnp.asarray(ctx))
    with torch.no_grad():
        got = run_controlnets([st], torch.from_numpy(x), torch.from_numpy(t), frac,
                              torch.from_numpy(ctx))
    if kw.get("start_percent", 0.0) > frac:
        assert got is None  # outside its window the adapter adds nothing
        return
    for kind in ("input", "middle"):
        for g, w in zip(got[kind], want[kind]):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.shape[0] == 2  # broadcast to the CFG batch
                _assert_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rel=1e-5)
    assert st._features is not None  # computed once, kept
    jutree, utree = _unet_sd()
    want_eps = junet(jutree, jx, jnp.asarray(t), jnp.asarray(ctx), y=jnp.asarray(y), cfg=jcfg(),
                     control=want)
    with torch.no_grad():
        got_eps = unet_apply(utree, torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(ctx), y=torch.from_numpy(y), cfg=tcfg(), control=got)
    _assert_close(got_eps.numpy(), np.asarray(want_eps).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def engines():
    return {"sdxl": sdxl_engines(), "sd15": sd15_engines()}


def _edges_image(size=64):
    img = np.zeros((size, size, 3), np.uint8)
    img[size // 4:3 * size // 4, size // 3:2 * size // 3] = 255
    img[5:9, :] = 180
    return img


@pytest.mark.parametrize("model", ["sdxl", "sd15"])
def test_t2i_adapter_unit_matches_forge_tpu(engines, model, tmp_path):
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.extensions import controlnet as tcn

    sd = (t2i_sd(**TINY_XL, seed=4) if model == "sdxl"
          else t2i_sd(cin=192, channels=(32, 64), downs=(0,), seed=5))
    save_safetensors(sd, str(tmp_path / "t2i_tiny.safetensors"))
    unit = {"module": "canny", "model": "t2i_tiny", "image": _edges_image(), "weight": 1.5,
            "threshold_a": 50, "threshold_b": 120}

    def attach(package, p):
        ext = jcn if package == "forge_tpu" else tcn
        ext.set_model_dirs([str(tmp_path)])
        ext._MODEL_CACHE.clear()
        kw = {} if package == "forge_tpu" else {"device": "cpu"}
        assert ext.attach_units(p, [unit], **kw) == 1

    try:
        request = SDXL_REQUEST if model == "sdxl" else SD15_REQUEST
        got, want, tp = run_both(engines[model], request, attach)
    finally:
        for ext in (jcn, tcn):
            ext.set_model_dirs(["models/ControlNet", "models/controlnet"])
            ext._MODEL_CACHE.clear()
    print(model, assert_slice(got, want))
    from forge_tpu_torch.models.t2i_adapter import T2IAdapterState

    assert len(tp.controlnets) == 1 and isinstance(tp.controlnets[0], T2IAdapterState)
    tproc = processing("forge_tpu_torch")
    plain = tproc.process_images(engines[model][1], tproc.Processing(**request))
    assert not np.array_equal(got.images[0], plain.images[0])

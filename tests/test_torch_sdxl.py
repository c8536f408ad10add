"""The port's SDXL base slice against forge_tpu (CPU, f32).

A tiny SDXL checkpoint (the layout of tests/test_sdxl.py's: a 32-channel
UNet with label embedding and linear projections, a CLIP-L tower in HF
layout and a CLIP-G tower in open_clip layout, a 32-channel VAE) goes
through each ported module and through the whole txt2img slice in both
packages. Module outputs agree to 1e-4 of their scale (f32 on both sides;
only summation order differs); σ-space sampler outputs to 1e-5; the images
(64², DPM++ 2M, Karras, 3 steps, CFG 7, seed 1) to PSNR ≥ 40 dB, the bar of
tests/test_golden_parity.py. The positional embeddings carry an offset of
0.5, so that the "Original" emphasis mode's mean renormalisation divides by
a mean far from 0.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.synth import _Fill, synth_clip_sd, synth_unet_sd, synth_vae_sd  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest, params_from_jax  # noqa: E402

GW = 64  # tiny CLIP-G width
LW = 64  # tiny CLIP-L width
CTX = LW + GW
ADM = GW + 6 * 256
G = "conditioner.embedders.1.model."
L = "conditioner.embedders.0.transformer."
PROMPTS = ["an astronaut riding a (horse:1.3) on the moon", "blurry, [ugly]"]
REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
               seed=1, steps=3, width=64, height=64, sampler_name="DPM++ 2M",
               scheduler="karras", cfg_scale=7.0)


def _open_clip_g(f, width, layers):
    sd = {G + "positional_embedding": f.w(77, width),
          G + "token_embedding.weight": f.w(49408, width),
          G + "ln_final.weight": f.ones(width),
          G + "ln_final.bias": f.zeros(width),
          G + "text_projection": f.w(width, width)}
    for i in range(layers):
        base = f"{G}transformer.resblocks.{i}."
        sd[base + "attn.in_proj_weight"] = f.w(width * 3, width)
        sd[base + "attn.in_proj_bias"] = f.w(width * 3)
        sd[base + "attn.out_proj.weight"] = f.w(width, width)
        sd[base + "attn.out_proj.bias"] = f.zeros(width)
        for ln in ("ln_1", "ln_2"):
            sd[base + ln + ".weight"] = f.ones(width)
            sd[base + ln + ".bias"] = f.zeros(width)
        sd[base + "mlp.c_fc.weight"] = f.w(width * 4, width)
        sd[base + "mlp.c_fc.bias"] = f.zeros(width * 4)
        sd[base + "mlp.c_proj.weight"] = f.w(width, width * 4)
        sd[base + "mlp.c_proj.bias"] = f.zeros(width)
    return sd


def _tiny_sdxl_checkpoint():
    sd = {}
    sd.update(synth_unet_sd(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                            transformer_depth=(0, 1), context_dim=CTX, adm_in_channels=ADM,
                            middle_depth=1, fill="random", seed=11))
    for key in [k for k in sd if k.endswith(("proj_in.weight", "proj_out.weight"))]:
        sd[key] = sd[key][:, :, 0, 0]  # SDXL's linear projections (the synth picks convs below 1024)
    sd.update(synth_vae_sd(ch=32, fill="random", seed=12))
    sd.update(synth_clip_sd(width=LW, layers=2, fill="random", seed=13, prefix=L))
    sd[L + "text_model.embeddings.position_embedding.weight"] += 0.5
    sd.update(_open_clip_g(_Fill("random", 14), GW, 2))
    sd[G + "positional_embedding"] += 0.5
    sd[G + "ln_final.bias"] += 0.1
    return sd


@pytest.fixture(scope="module")
def ckpt():
    return _tiny_sdxl_checkpoint()


def _assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _jax_engine(sd):
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload

    eng = jload(dict(sd), dtype=jnp.float32)
    eng.unet_cfg = JCfg(context_dim=CTX, num_heads=4, use_linear_projection=True,
                        adm_in_channels=ADM)
    return eng


def _port_engine(sd):
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    eng = load_engine(dict(sd), device="cpu")
    eng.unet_cfg = UNetConfig(context_dim=CTX, num_heads=4)
    return eng


@pytest.fixture(scope="module")
def engines(ckpt):
    return _jax_engine(ckpt), _port_engine(ckpt)


# -- core/loader.py, core/synth.py ---------------------------------------------


def _open_clip_part(sd):
    return {k[len(G):]: v for k, v in sd.items() if k.startswith(G)}


def test_convert_open_clip_matches_forge_tpu(ckpt):
    from forge_tpu.core.loader import convert_open_clip as jconvert
    from forge_tpu_torch.core.loader import convert_open_clip

    want = jconvert(_open_clip_part(ckpt))
    got = convert_open_clip(_open_clip_part(ckpt))
    assert list(got) == list(want)
    assert len(got) == 4 + 2 * 16 + 1
    for key, value in want.items():
        assert np.array_equal(np.asarray(got[key]), value), key


def test_convert_open_clip_keeps_device_weights_lazy():
    """With `DeviceFill` every weight is a LazyTensor: the q/k/v split and the
    projection's transpose are made when the loader makes the weight, on its
    device, equal to the split and transpose of the made tensor."""
    from forge_tpu_torch.core.loader import convert_open_clip
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor

    lazy = _open_clip_g(DeviceFill("cpu", seed=5), 16, 1)
    got = convert_open_clip(_open_clip_part(lazy))
    assert all(isinstance(v, LazyTensor) for v in got.values())
    made = {k: v.materialize().numpy() for k, v in _open_clip_part(lazy).items()}
    want = convert_open_clip(made)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        assert np.array_equal(got[key].materialize().numpy(), value), key
    w = made["transformer.resblocks.0.attn.in_proj_weight"]
    sa = "text_model.encoder.layers.0.self_attn."
    assert np.array_equal(want[sa + "k_proj.weight"], w[16:32])
    assert np.array_equal(want["text_projection.weight"], made["text_projection"].T)


def test_full_width_checkpoint_is_sdxl_base():
    """The full-width key set, shapes only (nothing is made): SDXL base's
    family, context and adm widths, 70 transformer blocks, the CLIP-G tower
    reached by `DeviceFill`, and its converted shapes."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.loader import convert_open_clip
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor, synth_sdxl_checkpoint

    sd = synth_sdxl_checkpoint(fill=DeviceFill("cpu"))
    assert all(isinstance(v, LazyTensor) for v in sd.values())
    g = guess.guess(sd)
    assert (g.family, g.context_dim, g.prediction) == ("sdxl", 2048, "eps")
    assert set(g.text_encoders) == {"clip_l", "open_clip_g"}
    assert g.unet["label_emb.0.0.weight"].shape == (1280, 2816)
    assert sum(k.endswith("attn1.to_q.weight") for k in g.unet) == 70
    assert 2.5e9 < sum(v.size for v in g.unet.values()) < 2.6e9
    te = convert_open_clip(g.text_encoders["open_clip_g"])
    assert te["text_model.encoder.layers.31.self_attn.v_proj.weight"].shape == (1280, 1280)
    assert te["text_model.encoder.layers.0.self_attn.q_proj.bias"].shape == (1280,)
    assert te["text_projection.weight"].shape == (1280, 1280)
    assert 6.9e8 < sum(v.size for v in te.values()) < 7.0e8


def test_fused_conv_weights_channels_last_only_on_cuda(ckpt):
    """The loader's channels_last rule picks exactly the fused convs of an
    SDXL checkpoint (every ResBlock's two and every VAE resnet's two) and
    leaves them OIHW-contiguous on the CPU; on CUDA it stores them
    channels_last (the GPU tests and chip_smoke run that side)."""
    from forge_tpu_torch.core.loader import FUSED_CONV_WEIGHTS, load_checkpoint_parts
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_checkpoint

    full = synth_sdxl_checkpoint(fill=DeviceFill("cpu"))
    fused = [k for k, v in full.items() if len(v.shape) == 4 and k.endswith(FUSED_CONV_WEIGHTS)]
    unet = [k for k in fused if k.startswith("model.diffusion_model.")]
    assert len(unet) == 2 * (6 + 2 + 9)
    assert all(".in_layers.2." in k or ".out_layers.3." in k for k in unet)
    decoder = [k for k in fused if k.startswith("first_stage_model.decoder.")]
    assert len(decoder) == 2 * (2 + 4 * 3)
    assert all(full[k].shape[2:] == (3, 3) for k in fused)

    loaded = load_checkpoint_parts(dict(ckpt), dtype=torch.float32, device="cpu")
    for tree, key in ((loaded.unet, "input_blocks.1.0.in_layers.2.weight"),
                      (loaded.unet, "output_blocks.0.0.out_layers.3.weight"),
                      (loaded.vae, "decoder.mid.block_1.conv1.weight")):
        w = tree
        for part in key.split("."):
            w = w[part]
        assert w.dim() == 4 and w.is_contiguous()
        assert not w.is_contiguous(memory_format=torch.channels_last)


# -- models/clip.py, text/engine.py ---------------------------------------------


@pytest.mark.parametrize("width", [768, 1024, 1280, 64, 100, 32])
def test_clip_config_for_width_matches(width):
    from forge_tpu.models.clip import ClipConfig as JCfg
    from forge_tpu_torch.models.clip import ClipConfig

    want, got = JCfg.for_width(width), ClipConfig.for_width(width)
    assert (got.num_heads, got.act) == (want.num_heads, want.act)


def test_clip_g_tower_matches(ckpt):
    """The gelu tower: final and penultimate hidden states, the pooled output
    and its text projection, on the converted weights."""
    from forge_tpu.core.loader import convert_open_clip as jconvert
    from forge_tpu.models.clip import ClipConfig as JCfg
    from forge_tpu.models.clip import clip_pooled_projection as jproject
    from forge_tpu.models.clip import clip_text_apply as jclip
    from forge_tpu_torch.models.clip import ClipConfig, clip_pooled_projection, clip_text_apply

    sd = jconvert(_open_clip_part(ckpt))
    toks = np.random.default_rng(3).integers(0, 49406, size=(2, 77)).astype(np.int32)
    toks[:, 0], toks[0, 20], toks[1, 76] = 49406, 49407, 49407
    jtree = jax_nest({k: jnp.asarray(v) for k, v in sd.items()})
    jfinal, jhid, jpooled = jclip(jtree, jnp.asarray(toks), cfg=JCfg(num_heads=4, act="gelu"))
    tree = nest({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        final, hiddens, pooled = clip_text_apply(tree, torch.from_numpy(toks.astype(np.int64)),
                                                 cfg=ClipConfig(num_heads=4, act="gelu"))
        projected = clip_pooled_projection(tree, pooled)
    _assert_close(final.numpy(), jfinal)
    _assert_close(hiddens[-2].numpy(), jhid[-2])
    _assert_close(pooled.numpy(), jpooled)
    _assert_close(projected.numpy(), jproject(jtree, jpooled))
    assert np.abs(projected.numpy() - pooled.numpy()).max() > 1e-3  # the projection took part
    del tree["text_projection"]
    with pytest.raises(KeyError, match="text_projection"):
        clip_pooled_projection(tree, pooled)  # the reference returns pooled unprojected here


@pytest.mark.parametrize("name", ["clip_l", "clip_g"])
def test_sdxl_text_engines_match(engines, name):
    """Penultimate hidden states with no final LayerNorm and the emphasis
    applied; the pooled output from the true final layer (projected for G);
    two chunks and a shorter prompt padded to them."""
    jeng, teng = engines[0].text_engines[name], engines[1].text_engines[name]
    assert teng.opts.layer == "hidden"
    assert teng.opts.pooled_projection == (name == "clip_g")
    long = PROMPTS[0] + ", " + ", ".join(f"detail {i}" for i in range(25))
    _, n = teng.tokenize_batch([long])
    assert n == 2
    for batch in ([long, PROMPTS[1]], PROMPTS):
        want, want_pooled = jeng(batch, max_chunks=n)
        got, pooled = teng(batch, max_chunks=n)
        _assert_close(got.numpy(), want)
        _assert_close(pooled.numpy(), want_pooled)


def test_clip_skip_moves_only_last_layer_engines(engines):
    eng = engines[1]
    eng.set_clip_skip(2)
    try:
        assert all(e.opts.clip_skip == 1 for e in eng.text_engines.values())
    finally:
        eng.set_clip_skip(1)


# -- pipeline/engine.py -------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(width=64, height=64),
    dict(width=96, height=64, crop=(8, 16), original_size=(128, 192), target_size=(64, 80)),
])
def test_get_learned_conditioning_matches(engines, kwargs):
    """context = CLIP-L ‖ CLIP-G hidden states; y = pooled G ‖ the six
    256-wide embeddings of (original h, w, crop h, w, target h, w)."""
    jeng, teng = engines
    w, h = kwargs.pop("width"), kwargs.pop("height")
    want = jeng.get_learned_conditioning(PROMPTS, w, h, max_chunks=1, **kwargs)
    got = teng.get_learned_conditioning(PROMPTS, w, h, max_chunks=1, **kwargs)
    assert set(got) == {"context", "y"}
    assert got["context"].shape == (2, 77, CTX) and got["y"].shape == (2, ADM)
    _assert_close(got["context"].numpy(), want["context"])
    _assert_close(got["y"].numpy(), want["y"])


def test_engine_is_sdxl(engines):
    from forge_tpu_torch.models.unet import UNetConfig

    eng = engines[1]
    assert eng.family == "sdxl" and set(eng.text_engines) == {"clip_l", "clip_g"}
    assert eng.latent_format.scale_factor == 0.13025
    assert UNetConfig.for_family("sdxl") == UNetConfig(context_dim=2048, head_dim=64)


# -- models/unet.py -------------------------------------------------------------------


@pytest.mark.parametrize("config", ["heads4", "head_dim64"])
def test_sdxl_unet_forward_matches(ckpt, config):
    """One forward with `label_emb` and linear proj_in/proj_out, the weights
    forge_tpu computed with carried across by `params_from_jax`; heads fixed
    at 4, or SDXL's rule (C // 64)."""
    from forge_tpu.models.unet import UNetConfig as JCfg, unet_apply as junet
    from forge_tpu_torch.models.unet import UNetConfig, unet_apply

    prefix = "model.diffusion_model."
    sd = {k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)}
    kw = (dict(num_heads=4) if config == "heads4" else dict(head_dim=64))
    jtree = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})
    tree = nest(params_from_jax(jtree))
    assert tree["input_blocks"]["3"]["1"]["proj_in"]["weight"].dim() == 2
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = np.array([999.0, 321.0], np.float32)
    ctx = r.standard_normal((2, 77, CTX)).astype(np.float32)
    y = r.standard_normal((2, ADM)).astype(np.float32)
    want = junet(jtree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx),
                 y=jnp.asarray(y), cfg=JCfg(context_dim=CTX, use_linear_projection=True,
                                            adm_in_channels=ADM, **kw))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    cfg = UNetConfig(context_dim=CTX, **kw)
    args = (tree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        got = unet_apply(*args, y=torch.from_numpy(y), cfg=cfg).numpy()
        other_y = unet_apply(*args, y=torch.from_numpy(2 * y), cfg=cfg).numpy()
    _assert_close(got, want)
    assert np.abs(got - other_y).max() > 1e-4  # label_emb took part
    with pytest.raises(ValueError, match="label embedding"):
        unet_apply(*args, cfg=cfg)  # the reference leaves the embedding out here


# -- sampling/samplers.py -------------------------------------------------------------


def _toy(x, sigma):
    return x * (1.0 / (1.0 + sigma * sigma)) + 0.1


@pytest.mark.parametrize("steps", [1, 2, 3, 30])
def test_dpmpp_2m_matches(steps):
    """Over Karras σ: the first step and the last (σ_next = 0) take denoised
    as it is, the steps between extrapolate (steps 1 and 2 have no step
    between)."""
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu.sampling import samplers as jsamp
    from forge_tpu.sampling.schedules import get_sigmas as jget_sigmas
    from forge_tpu_torch.sampling import samplers as tsamp

    sigmas = jget_sigmas("karras", steps, jpred.DiscretePrediction())
    assert sigmas[-1] == 0
    x0 = (np.random.default_rng(7).standard_normal((2, 4, 8, 8)) * sigmas[0]).astype(np.float32)
    want = np.asarray(jsamp.get_sampler("DPM++ 2M").fn(_toy, jnp.asarray(x0), sigmas))
    info = tsamp.get_sampler("DPM++ 2M")
    assert info.noise_draws == 0 and not info.uses_ensd
    got = info.fn(_toy, torch.from_numpy(x0), sigmas).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_dpmpp_2m_first_step_is_unextrapolated():
    """A one-step schedule ends at σ = 0: the result is `denoised` itself,
    scaled by −expm1(−h) = 1 − 1e-10/σ."""
    from forge_tpu_torch.sampling.samplers import sample_dpmpp_2m

    x = torch.full((1, 4, 2, 2), 3.0)
    got = sample_dpmpp_2m(lambda x, s: torch.full_like(x, 0.25), x,
                          np.array([2.0, 0.0], np.float32))
    torch.testing.assert_close(got, torch.full_like(x, 0.25), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["DPM++ 2M", "k_dpmpp_2m", "dpmpp_2m", "dpm++ 2m", "k_euler_a",
                                  "euler", "EULER A"])
def test_sampler_aliases_match(name):
    from forge_tpu.sampling import samplers as jsamp
    from forge_tpu_torch.sampling import samplers as tsamp

    want = next(k for k, v in jsamp.SAMPLERS.items() if v is jsamp.get_sampler(name))
    assert tsamp.get_sampler(name) is tsamp.SAMPLERS[want]


# -- the whole slice ---------------------------------------------------------------------


def test_sdxl_txt2img_matches_forge_tpu(engines):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
    assert teng.compute_dtype == torch.float32
    res = process_images(teng, Processing(**REQUEST))
    got = res.images[0]
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    assert res.seeds == [1]
    assert float(want.std()) > 1.0  # not a flat image
    assert _psnr(got, want) >= 40.0, _psnr(got, want)
    assert np.array_equal(got, process_images(teng, Processing(**REQUEST)).images[0])

"""The port's SD2 slice against forge_tpu (CPU, f32).

A tiny SD2 checkpoint: SD1.5's UNet topology at 32 channels with linear
projections and context 64, an open_clip text tower (64 wide, 3 layers)
under `cond_stage_model.model.` that both loaders rename `clip_h`, a
32-channel VAE; with the `v_pred` marker key for the 768-v objective, or
without it for eps. Both packages run it end to end (3 Euler a steps at
32², CFG 7) to PSNR ≥ 70 dB (measured 83.01 dB eps, 79.99 dB v), and a tiny
img2img. The text layer is the reference's (the last layer and the final
LayerNorm), not SD2's own inference config's penultimate layer: both sides
are shown. The last test traces SD2.1-768-v at full width on the meta
device: the kernels' launches a 768² request.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.synth import _Fill, synth_unet_sd, synth_vae_sd  # noqa: E402
from test_torch_sd3 import meta_engine, trace_calls  # noqa: E402
from test_torch_serving import _count, _meta  # noqa: E402

W = 64  # the tiny tower's width: the UNet's context
H = "cond_stage_model.model."
PROMPTS = ["a photograph of an (astronaut:1.2) riding a horse", "blurry"]
REQUEST = dict(prompt="a photograph of an astronaut", negative_prompt="blurry", seed=1, steps=3,
               width=32, height=32, sampler_name="Euler a", cfg_scale=7.0)
SD2_STEPS = 20  # the 768-v request: 768², DPM++ 2M Karras, 20 steps, CFG 7


def _open_clip(f, width, layers):
    sd = {H + "positional_embedding": f.w(77, width) + 0.5,
          H + "token_embedding.weight": f.w(49408, width),
          H + "ln_final.weight": f.ones(width),
          H + "ln_final.bias": f.zeros(width) + 0.1,
          H + "text_projection": f.w(width, width)}
    for i in range(layers):
        b = f"{H}transformer.resblocks.{i}."
        sd[b + "attn.in_proj_weight"] = f.w(width * 3, width)
        sd[b + "attn.in_proj_bias"] = f.w(width * 3)
        sd[b + "attn.out_proj.weight"] = f.w(width, width)
        sd[b + "attn.out_proj.bias"] = f.zeros(width)
        for ln in ("ln_1", "ln_2"):
            sd[b + ln + ".weight"] = f.ones(width)
            sd[b + ln + ".bias"] = f.zeros(width)
        sd[b + "mlp.c_fc.weight"] = f.w(width * 4, width)
        sd[b + "mlp.c_fc.bias"] = f.zeros(width * 4)
        sd[b + "mlp.c_proj.weight"] = f.w(width, width * 4)
        sd[b + "mlp.c_proj.bias"] = f.zeros(width)
    return sd


def _tiny_sd2_checkpoint(v_prediction: bool):
    sd = synth_unet_sd(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                       transformer_depth=(1, 1), context_dim=W, middle_depth=1, fill="random",
                       seed=41)
    for key in [k for k in sd if k.endswith(("proj_in.weight", "proj_out.weight"))]:
        sd[key] = sd[key][:, :, 0, 0]  # SD2's linear projections (the synth picks convs below 1024)
    sd.update(synth_vae_sd(ch=32, fill="random", seed=42))
    sd.update(_open_clip(_Fill("random", 43), W, 3))
    if v_prediction:
        sd["v_pred"] = np.zeros((), np.float32)
    return sd


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _engines(v_prediction: bool):
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    sd = _tiny_sd2_checkpoint(v_prediction)
    jeng = jload(dict(sd), dtype=jnp.float32)
    jeng.unet_cfg = JCfg(context_dim=W, num_heads=4, use_linear_projection=True)
    teng = load_engine(dict(sd), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=W, num_heads=4)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return {"eps": _engines(False), "v": _engines(True)}


# -- core/loader.py, core/guess.py, core/synth.py ---------------------------------------


def test_open_clip_h_loads_as_clip_h(engines):
    """The open_clip tower under `cond_stage_model.model.` is renamed `clip_h`
    by both loaders, its keys converted to the HF space, the same weights."""
    from forge_tpu_torch.core.convert import flatten

    jeng, teng = engines["eps"]
    assert set(teng.loaded.text_encoders) == set(jeng.loaded.text_encoders) == {"clip_h"}
    got = flatten(teng.loaded.text_encoders["clip_h"])
    want = flatten(jeng.loaded.text_encoders["clip_h"])
    assert set(got) == set(want)
    assert "text_model.encoder.layers.2.self_attn.v_proj.weight" in got
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value)), key


def test_sd2_guess_and_prediction(engines):
    """Family sd20 from the tower's prefix; v from the `v_pred` marker key;
    the two objectives give two x0 from one output."""
    for pred, (jeng, teng) in engines.items():
        assert (teng.family, teng.loaded.prediction) == (jeng.family, jeng.loaded.prediction)
        assert (teng.family, teng.loaded.prediction, teng.loaded.context_dim) == (
            "sd20", pred, 1024)
        assert teng.predictor.prediction_type == pred and teng.predictor.family == "sd20"
    x, out = torch.ones(1, 4, 2, 2), torch.full((1, 4, 2, 2), 0.5)
    eps, v = (engines[p][1].predictor.calculate_denoised(3.0, out, x) for p in ("eps", "v"))
    assert (eps - v).abs().min() > 0.1


def test_full_width_checkpoint_is_sd21_768_v():
    """The published key set, shapes only (nothing is made): 16 transformer
    blocks, context 1024, linear projections, ~866 M UNet parameters;
    OpenCLIP ViT-H/14's text tower, 1024 × 24; the v marker."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.loader import convert_open_clip
    from forge_tpu_torch.core.synth import DeviceFill, synth_sd2_checkpoint

    g = guess.guess(synth_sd2_checkpoint(fill=DeviceFill("cpu")))
    assert (g.family, g.prediction, g.context_dim) == ("sd20", "v", 1024)
    u = g.unet
    assert sum(k.endswith("attn1.to_q.weight") for k in u) == 16
    assert u["input_blocks.1.1.proj_in.weight"].shape == (320, 320)
    assert u["middle_block.1.transformer_blocks.0.attn2.to_k.weight"].shape == (1280, 1024)
    assert 8.6e8 < sum(v.size for v in u.values()) < 8.7e8
    te = convert_open_clip(g.text_encoders["open_clip_h"])
    assert te["text_model.encoder.layers.23.self_attn.q_proj.weight"].shape == (1024, 1024)
    assert "text_model.encoder.layers.24.self_attn.q_proj.weight" not in te
    assert 3.3e8 < sum(v.size for v in te.values()) < 3.6e8


def test_sd2_unet_config():
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu_torch.models.unet import UNetConfig

    want = JCfg.for_family("sd20")
    got = UNetConfig.for_family("sd20")
    assert got == UNetConfig(context_dim=1024, head_dim=64)
    assert (got.context_dim, got.head_dim) == (want.context_dim, want.head_dim)
    assert want.use_linear_projection  # the port finds the projections' kind in the tree


def test_params_from_jax_carries_the_sd2_trees(engines):
    """forge_tpu's loaded UNet and VAE trees (conv kernels HWIO) come back
    through `params_from_jax` as the port's loader holds them: every key,
    the linear projections 2-D, every value equal."""
    from forge_tpu_torch.core.convert import flatten, params_from_jax

    jeng, teng = engines["v"]
    for jtree, tree in ((jeng.loaded.unet, teng.loaded.unet), (jeng.loaded.vae, teng.loaded.vae)):
        got, want = params_from_jax(jtree), flatten(tree)
        assert set(got) == set(want)
        for key, value in want.items():
            assert tuple(got[key].shape) == tuple(value.shape), key
            assert np.array_equal(got[key].numpy(), value.numpy()), key
    assert teng.loaded.unet["input_blocks"]["1"]["1"]["proj_in"]["weight"].dim() == 2


# -- the text layer --------------------------------------------------------------------


def test_sd2_text_layer_is_the_references(engines):
    """The reference encodes SD2 with the tower's last layer and its final
    LayerNorm (`TextEncoderOptions()`); SD2's v2-inference-v.yaml takes the
    penultimate layer (with the final LayerNorm). The port keeps the
    reference's answer; the penultimate variant, the same on both sides
    (and what clip skip 2 gives), differs from it."""
    from forge_tpu.text.engine import ClassicTextEngine as JEngine
    from forge_tpu.text.engine import TextEncoderOptions as JOpts
    from forge_tpu_torch.text.engine import ClassicTextEngine, TextEncoderOptions

    jeng, teng = engines["v"]
    got = teng.get_learned_conditioning(PROMPTS)["context"]
    want = jeng.get_learned_conditioning(PROMPTS)["context"]
    assert got.shape == (2, 77, W)
    _assert_close(got.numpy(), want)
    assert teng.text_engines["clip_h"].opts.layer == "last"

    jpen = JEngine(jeng.loaded.text_encoders["clip_h"], jeng.tokenizer,
                   JOpts(layer="hidden", layer_idx=-2, final_layer_norm=True))
    tpen = ClassicTextEngine(teng.loaded.text_encoders["clip_h"],
                             teng.text_engines["clip_h"].tokenizer,
                             TextEncoderOptions(layer="hidden", layer_idx=-2,
                                                final_layer_norm=True))
    pen_want, _ = jpen(PROMPTS)
    pen_got, _ = tpen(PROMPTS)
    _assert_close(pen_got.numpy(), pen_want)
    gap = np.abs(np.asarray(pen_want) - np.asarray(want)).max()
    assert gap > 0.05 * np.abs(np.asarray(want)).max(), gap  # the two layers differ
    teng.set_clip_skip(2)
    try:
        skip2 = teng.get_learned_conditioning(PROMPTS)["context"]
    finally:
        teng.set_clip_skip(1)
    _assert_close(skip2.numpy(), pen_got.numpy())


def test_v_prediction_matches_forge_tpu():
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu_torch.sampling.prediction import DiscretePrediction

    want, got = jpred.DiscretePrediction(prediction_type="v"), DiscretePrediction(prediction_type="v")
    r = np.random.default_rng(2)
    x, out = (r.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    for sigma in (14.6146, 3.0, 0.5, 0.0292):
        s = np.float32(sigma)
        np.testing.assert_allclose(
            got.calculate_denoised(float(s), torch.from_numpy(out), torch.from_numpy(x)).numpy(),
            np.asarray(want.calculate_denoised(s, out, x)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.calculate_input(float(s), torch.from_numpy(x)).numpy(),
                                   np.asarray(want.calculate_input(s, x)), rtol=1e-6)


# -- the whole slice ------------------------------------------------------------------


@pytest.mark.parametrize("pred", ["eps", "v"])
def test_sd2_txt2img_matches_forge_tpu(engines, pred):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines[pred]
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
    got = process_images(teng, Processing(**REQUEST)).images[0]
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8
    assert float(want.std()) > 1.0
    assert _psnr(got, want) >= 70.0, _psnr(got, want)


def test_sd2_img2img_matches_forge_tpu(engines):
    """Strength 0.6 of 5 DPM++ 2M Karras steps over a smooth init image (v)."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines["v"]
    yy, xx = np.mgrid[0:32, 0:32]
    init = np.stack([yy * 8, xx * 8, (yy + xx) * 4], -1).astype(np.uint8)
    req = dict(REQUEST, steps=5, sampler_name="DPM++ 2M", scheduler="karras",
               denoising_strength=0.6)
    want = jproc.process_images(jeng, jproc.Processing(**req, init_images=[init])).images[0]
    got = process_images(teng, Processing(**req, init_images=[init])).images[0]
    assert got.shape == want.shape == (32, 32, 3)
    assert _psnr(got, want) >= 70.0, _psnr(got, want)


@pytest.mark.parametrize("fields", [dict(enable_hr=True), dict(controlnets=[object()]),
                                    dict(prompt="a fox <lora:tiny:1>")])
def test_sd2_refuses_unported_request_features(engines, fields):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    with pytest.raises(NotImplementedError, match="sd20"):
        process_images(engines["eps"][1], Processing(**dict(REQUEST, **fields)))


# -- SD2.1-768-v at full width, traced on the meta device ---------------------------------


def test_sd2_full_width_launch_counts_and_bodies():
    """A 768² request (96² latents): 20 DPM++ 2M model calls at CFG batch 2,
    each 15 self-attentions (5 of 9216 tokens, 5 heads; 5 of 2304, 10 heads;
    5 of 576, 20 heads; the middle block's 144 tokens and every 77-key
    cross-attention stay below the kernel's 512 cut) and 44 convs (22
    ResBlocks); then the 768² decode (one head of 512 over 9216 tokens, 28
    convs): 301 flash, 908 conv, every call on the tensor-core body."""
    from forge_tpu_torch.core.synth import DeviceFill, synth_sd2_checkpoint
    from forge_tpu_torch.sampling.prediction import DiscretePrediction
    from forge_tpu_torch.sampling.schedules import get_sigmas

    calls = len(get_sigmas("karras", SD2_STEPS, DiscretePrediction(prediction_type="v"))) - 1
    assert calls == 20
    engine = meta_engine(synth_sd2_checkpoint(fill=DeviceFill("cpu")))
    assert engine.family == "sd20" and engine.predictor.prediction_type == "v"
    cond = {"context": _meta((1, 77, 1024))}
    c = trace_calls(engine, {"x": (1, 4, 96, 96), "cond": cond}, (1, 4, 96, 96))
    assert all(body == "wgmma" for part in c.values() for kind in part.values()
               for *_, body in kind)
    assert _count(c["call"]["flash"]) == {((2, 5, 9216, 64), 9216): 5,
                                          ((2, 10, 2304, 64), 2304): 5,
                                          ((2, 20, 576, 64), 576): 5}
    assert len(c["call"]["conv"]) == 44
    assert sorted({(x[1], o, x[2]) for x, o, _ in c["call"]["conv"]}) == [
        (320, 320, 96), (320, 640, 48), (640, 320, 96), (640, 640, 48), (640, 1280, 24),
        (960, 320, 96), (960, 640, 48), (1280, 640, 48), (1280, 1280, 12), (1280, 1280, 24),
        (1920, 640, 48), (1920, 1280, 24), (2560, 1280, 12), (2560, 1280, 24)]
    assert c["decode"]["flash"] == [((1, 1, 9216, 512), 9216, "wgmma")]
    assert len(c["decode"]["conv"]) == 28
    total = {k: calls * len(c["call"][k]) + len(c["decode"][k]) for k in ("flash", "conv")}
    assert total == {"flash": 301, "conv": 908}

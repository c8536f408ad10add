"""The port's SD3 slice against forge_tpu (CPU, f32).

A tiny SD3 single-file checkpoint: a 2-block MMDiT (hidden 64) under
`model.diffusion_model.`, CLIP-L (64 wide) and CLIP-G (32 wide, with its
text projection) in HF layout and T5 (128 wide, 2 heads) under
`text_encoders.*.transformer.`, and a four-level 16-channel VAE (a 32²
request decodes to 32²). SD3's context width is fixed at 4096 by the
reference's guess (`forge_tpu/core/guess.py:84`), so both packages' engines
get the tiny T5's width, 128, as `loaded.context_dim`: CLIP-L ‖ CLIP-G (96)
is zero-padded to it. Conditioning agrees to 1e-4 of its scale; the
3-step Euler "simple" txt2img and a tiny img2img to PSNR ≥ 80 dB (measured:
bit-equal). The last tests trace SD3-medium at full width on the meta
device (no memory): the kernels' launches a request.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.synth import synth_clip_sd, synth_mmdit_sd, synth_t5_sd, synth_vae_sd  # noqa: E402
from test_torch_serving import _count, _meta  # noqa: E402

CTX = 128  # the tiny T5's width: the context width both engines are given
POOLED = 64 + 32
PROMPTS = ["a red fox in the (snow:1.2)", "blurry"]
REQUEST = dict(prompt="a red fox in the snow", negative_prompt="blurry", seed=1, steps=3,
               width=32, height=32, sampler_name="Euler", scheduler="simple", cfg_scale=7.0)
SD3_STEPS = 28  # the model card's request: 1024², Euler, "simple", 28 steps, CFG 7, shift 3.0


def _tiny_sd3_checkpoint():
    sd = {}
    sd.update(synth_mmdit_sd(hidden=64, depth=2, context_dim=CTX, pooled_dim=POOLED, pos_max=16,
                             fill="random", seed=31))
    sd.update(synth_vae_sd(ch=32, ch_mult=(1, 2, 4, 4), z_channels=16, fill="random", seed=32))
    sd.update(synth_clip_sd(width=64, layers=2, fill="random", seed=33,
                            prefix="text_encoders.clip_l.transformer."))
    sd.update(synth_clip_sd(width=32, layers=2, fill="random", seed=34,
                            prefix="text_encoders.clip_g.transformer.", text_projection=True))
    sd.update(synth_t5_sd(width=CTX, layers=2, heads=2, ff=256, fill="random", seed=35))
    for name in ("clip_l", "clip_g"):  # the emphasis renormalisation divides by a mean far from 0
        sd[f"text_encoders.{name}.transformer.text_model.embeddings.position_embedding.weight"] += 0.5
    return sd


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


@pytest.fixture(scope="module")
def ckpt():
    return _tiny_sd3_checkpoint()


@pytest.fixture(scope="module")
def engines(ckpt):
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.pipeline.engine import load_engine

    jeng = jload(dict(ckpt), dtype=jnp.float32)
    teng = load_engine(dict(ckpt), device="cpu")
    jeng.loaded.context_dim = teng.loaded.context_dim = CTX
    return jeng, teng


# -- core/guess.py, core/loader.py, core/synth.py ---------------------------------------


def test_sd3_guess_and_loader(ckpt, engines):
    """The single-file layout: the MMDiT under `joint_blocks`, the patchify
    conv kept OIHW, CLIP-L, CLIP-G (HF layout with its projection) and T5 by
    their names, a 16-channel VAE; the guess as forge_tpu's."""
    from forge_tpu.core.guess import guess as jguess
    from forge_tpu_torch.core.guess import guess

    g, want = guess(dict(ckpt)), jguess(dict(ckpt))
    assert (g.family, g.prediction, g.context_dim) == (want.family, want.prediction,
                                                       want.context_dim) == ("sd3", "flow", 4096)
    assert set(g.text_encoders) == set(want.text_encoders) == {"clip_l", "clip_g", "t5xxl"}
    loaded = engines[1].loaded
    assert loaded.unet["x_embedder"]["proj"]["weight"].shape == (64, 16, 2, 2)
    assert loaded.vae["decoder"]["conv_in"]["weight"].shape[1] == 16
    assert set(loaded.text_encoders) == {"clip_l", "clip_g", "t5xxl"}
    assert loaded.text_encoders["clip_g"]["text_projection"]["weight"].shape == (32, 32)
    assert "text_model" in loaded.text_encoders["clip_l"]


def test_full_width_checkpoint_is_sd3_medium():
    """The published key set, shapes only (nothing is made): 24 joint blocks,
    hidden 1536, a 192² positional grid, context 4096, pooled 2048, ~2.08 B
    MMDiT parameters; CLIP-G 1280 × 32 with its projection; T5-XXL."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor, synth_sd3_checkpoint

    sd = synth_sd3_checkpoint(fill=DeviceFill("cpu"))
    assert all(isinstance(v, LazyTensor) for v in sd.values())
    g = guess.guess(sd)
    assert (g.family, g.context_dim) == ("sd3", 4096)
    u = g.unet
    assert u["pos_embed"].shape == (1, 192 * 192, 1536)
    assert u["context_embedder.weight"].shape == (1536, 4096)
    assert u["y_embedder.mlp.0.weight"].shape == (1536, 2048)
    assert sum(k.endswith("x_block.attn.qkv.weight") for k in u) == 24
    assert "joint_blocks.23.context_block.attn.proj.weight" not in u  # the last is pre-only
    assert 2.0e9 < sum(v.size for v in u.values()) < 2.1e9
    te = g.text_encoders
    assert te["clip_g"]["text_projection.weight"].shape == (1280, 1280)
    assert sum(k.endswith("self_attn.q_proj.weight") for k in te["clip_g"]) == 32
    assert te["t5xxl"]["shared.weight"].shape == (32128, 4096)
    assert g.vae["decoder.conv_in.weight"].shape == (512, 16, 3, 3)


# -- pipeline/engine.py, sampling/prediction.py, the text engines ------------------------


def test_sd3_engine(engines):
    from forge_tpu_torch.sampling.prediction import PredictionFlow

    jeng, eng = engines
    assert eng.family == "sd3" and set(eng.text_engines) == {"clip_l", "clip_g", "t5xxl"}
    assert eng.mmdit_cfg == eng.mmdit_cfg.__class__(num_heads=1, pos_embed_max_size=16)
    assert (jeng.mmdit_cfg.num_heads, jeng.mmdit_cfg.pos_embed_max_size) == (1, 16)
    assert isinstance(eng.predictor, PredictionFlow) and eng.predictor.shift == 3.0
    assert eng.predictor.family == jeng.predictor.family == "sd3"
    assert eng.text_engines["t5xxl"].max_length == jeng.text_engines["t5xxl"].max_length == 77
    for name in ("clip_l", "clip_g"):
        o = eng.text_engines[name].opts
        assert (o.layer, o.layer_idx, o.final_layer_norm) == ("hidden", -2, False)
        assert o.pooled_projection == (name == "clip_g")
    assert eng.latent_format.latent_channels == 16
    assert (eng.latent_format.scale_factor, eng.latent_format.shift_factor) == (1.5305, 0.0609)


def test_prediction_flow_matches_forge_tpu():
    """SD3's σ table (shift 3.0), its timestep σ·1000, the "simple" schedule
    at 28 steps, `noise_scaling`, `calculate_input` and `calculate_denoised`."""
    from forge_tpu.sampling import prediction as jpred
    from forge_tpu.sampling.schedules import get_sigmas as jget
    from forge_tpu_torch.sampling.prediction import PredictionFlow
    from forge_tpu_torch.sampling.schedules import get_sigmas

    want, got = jpred.PredictionFlow(shift=3.0), PredictionFlow(shift=3.0)
    assert np.array_equal(got.sigmas, want.sigmas)
    assert (got.sigma_min, got.sigma_max) == (want.sigma_min, want.sigma_max)
    for sched in ("simple", "normal", "sgm_uniform", "karras"):
        assert np.array_equal(get_sigmas(sched, SD3_STEPS, got), jget(sched, SD3_STEPS, want)), sched
    sig = get_sigmas("simple", SD3_STEPS, got)
    assert len(sig) == SD3_STEPS + 1 and sig[0] == 1.0
    r = np.random.default_rng(3)
    x, noise = r.standard_normal((2, 16, 4, 4)).astype(np.float32), r.standard_normal(
        (2, 16, 4, 4)).astype(np.float32)
    for s in sig[:-1:5]:
        s = np.float32(s)
        assert got.timestep(s) == want.timestep(s)
        np.testing.assert_allclose(got.noise_scaling(s, noise, x),
                                   np.asarray(want.noise_scaling(s, noise, x)), rtol=1e-6)
        np.testing.assert_array_equal(got.calculate_input(float(s), torch.from_numpy(x)).numpy(), x)
        np.testing.assert_allclose(got.calculate_denoised(float(s), torch.from_numpy(noise),
                                                          torch.from_numpy(x)).numpy(),
                                   np.asarray(want.calculate_denoised(s, noise, x)), rtol=1e-5,
                                   atol=1e-6)


def test_sd3_conditioning_matches_forge_tpu(engines):
    """context: CLIP-L ‖ CLIP-G penultimate states (77 tokens a chunk)
    zero-padded to the context width, then T5's 77 tokens; y: pooled L ‖
    projected pooled G. A prompt past one CLIP chunk takes three here (the
    reference asks for one chunk at least, not at most), and T5 cuts it at
    its 77-token window."""
    jeng, teng = engines
    long = "a red fox, " + ", ".join(f"detail {i}" for i in range(40))
    for prompts, chunks in ((PROMPTS, 1), ([long, "blurry"], 3)):
        want = jeng.get_learned_conditioning(prompts)
        got = teng.get_learned_conditioning(prompts)
        assert set(got) == {"context", "y"}
        assert got["context"].shape == (2, 77 * chunks + 77, CTX)
        assert got["y"].shape == (2, POOLED)
        _assert_close(got["context"].numpy(), want["context"])
        _assert_close(got["y"].numpy(), want["y"])
        ctx = got["context"].numpy()
        n = 77 * chunks  # the pad, then T5
        assert not ctx[:, :n, 96:].any() and np.abs(ctx[:, n:]).max() > 0


# -- the whole slice ------------------------------------------------------------------


def test_sd3_txt2img_matches_forge_tpu(engines):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
    res = process_images(teng, Processing(**REQUEST))
    got = res.images[0]
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8
    assert float(want.std()) > 1.0
    assert _psnr(got, want) >= 80.0, _psnr(got, want)
    assert np.array_equal(got, process_images(teng, Processing(**REQUEST)).images[0])
    assert "distilled" not in res.infotexts[0].lower()  # real CFG, no Flux guidance


def test_sd3_img2img_matches_forge_tpu(engines):
    """Strength 0.6 of 5 Euler steps over a smooth init image, through the
    port's VAE encoder and the flow noising σ·noise + (1 − σ)·latent."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    yy, xx = np.mgrid[0:32, 0:32]
    init = np.stack([yy * 8, xx * 8, (yy + xx) * 4], -1).astype(np.uint8)
    req = dict(REQUEST, steps=5, denoising_strength=0.6)
    want = jproc.process_images(jeng, jproc.Processing(**req, init_images=[init])).images[0]
    got = process_images(teng, Processing(**req, init_images=[init])).images[0]
    assert got.shape == want.shape == (32, 32, 3)
    assert _psnr(got, want) >= 80.0, _psnr(got, want)


@pytest.mark.parametrize("field", ["lora", "controlnets", "ip_adapter", "tiled_diffusion",
                                   "enable_hr", "refiner", "regional_prompts", "inpaint_mask"])
def test_sd3_refuses_unported_request_features(engines, field):
    """LoRA, ControlNets, the IP-Adapter (UNet hooks) and the request
    features no test holds on SD3 raise before any work is done."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    teng = engines[1]
    fields = {
        "lora": dict(prompt="a fox <lora:tiny:0.8>"),
        "controlnets": dict(controlnets=[object()]),
        "ip_adapter": dict(unet_hooks={"attn2_patch": [lambda q, k, v, extra: (q, k, v)]}),
        "tiled_diffusion": dict(tiled_diffusion={"tile": 8, "overlap": 2}),
        "enable_hr": dict(enable_hr=True),
        "refiner": dict(refiner_checkpoint="refiner", refiner_switch_at=0.8),
        "regional_prompts": dict(regional_prompts=[dict(prompt="an owl",
                                                        area=(0, 0, 0.5, 1))]),
        "inpaint_mask": dict(init_images=[np.zeros((32, 32, 3), np.uint8)],
                             inpaint_mask=np.ones((32, 32), np.float32)),
    }[field]
    with pytest.raises(NotImplementedError, match="sd3"):
        process_images(teng, Processing(**dict(REQUEST, **fields)))


def test_sd3_net_refuses_hooks_and_controlnets(engines):
    teng = engines[1]
    with pytest.raises(NotImplementedError, match="sd3"):
        teng.unet_apply_fn(hooks={"attn1_patch": [lambda q, k, v, e: (q, k, v)]})
    with pytest.raises(NotImplementedError, match="sd3"):
        teng.unet_apply_fn(controlnets=[object()])


# -- SD3-medium at full width, traced on the meta device ----------------------------------


def meta_engine(checkpoint):
    """The engine of a full-width checkpoint (`core/synth.py`, made with
    `DeviceFill`) whose every weight is a meta tensor: nothing is made."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.loader import OPEN_CLIP_NAMES, LoadedCheckpoint, convert_open_clip
    from forge_tpu_torch.pipeline.engine import DiffusionEngine

    g = guess.guess(checkpoint)

    def tree(sd):
        return nest({k: _meta(v.shape) for k, v in sd.items()})

    tes = {OPEN_CLIP_NAMES.get(name, name):
           tree(convert_open_clip(sd) if name in OPEN_CLIP_NAMES else sd)
           for name, sd in g.text_encoders.items()}
    loaded = LoadedCheckpoint(g.family, g.prediction, g.context_dim, tree(g.unet), tree(g.vae),
                              tes)
    return DiffusionEngine(loaded, "meta", torch.bfloat16)


def trace_calls(engine, model_call, latent):
    """Every flash and fused-conv call of one model call (`processing.denoise`
    over one σ) and of the decode of `latent` → {part: {kernel: [call]}}, a
    flash call as (q shape, Lk, body), a conv call as (x shape, O, body)."""
    from forge_tpu_torch.models import mmdit as mmdit_mod
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.pipeline import processing as proc

    calls = {}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    def one_call():
        p = proc.Processing(width=1024, height=1024, cfg_scale=7.0, sampler_name="Euler")
        job = proc.Job(p, _meta(model_call["x"], torch.float32), np.array([0.9, 0.0]), None,
                       model_call["cond"], model_call["cond"], engine.loaded.unet)
        return proc.denoise(engine, job)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (attention_mod, mmdit_mod):
            mp.setattr(mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        for name, run in (("call", one_call),
                          ("decode", lambda: engine.decode_dispatch(_meta(latent, torch.float32)))):
            calls.update(flash=[], conv=[])
            run()
            out[name] = dict(calls)
    return out


def test_sd3_full_width_launch_counts_and_bodies():
    """A 1024² request: 28 Euler model calls at CFG batch 2, each 24 joint
    attentions of 77 + 77 text and 4096 image tokens (q(2,24,4250,64), a
    ragged tail of 26 rows past 4224) and no fused conv (the MMDiT has no
    ResBlock); then the 16-channel VAE's 1024² decode (one head of 512 over
    16384 tokens; 28 convs): 673 flash, 28 conv, every call on the
    tensor-core body."""
    from forge_tpu_torch.sampling.prediction import PredictionFlow
    from forge_tpu_torch.sampling.schedules import get_sigmas

    calls = len(get_sigmas("simple", SD3_STEPS, PredictionFlow(shift=3.0))) - 1
    assert calls == 28
    from forge_tpu_torch.core.synth import DeviceFill, synth_sd3_checkpoint

    engine = meta_engine(synth_sd3_checkpoint(fill=DeviceFill("cpu")))
    assert engine.family == "sd3" and engine.mmdit_cfg.num_heads == 24
    cond = {"context": _meta((1, 154, 4096)), "y": _meta((1, 2048))}
    c = trace_calls(engine, {"x": (1, 16, 128, 128), "cond": cond}, (1, 16, 128, 128))
    assert all(body == "wgmma" for part in c.values() for kind in part.values()
               for *_, body in kind)
    assert _count(c["call"]["flash"]) == {((2, 24, 4250, 64), 4250): 24}
    assert c["call"]["conv"] == []
    assert c["decode"]["flash"] == [((1, 1, 16384, 512), 16384, "wgmma")]
    assert len(c["decode"]["conv"]) == 28
    total = {k: calls * len(c["call"][k]) + len(c["decode"][k]) for k in ("flash", "conv")}
    assert total == {"flash": 673, "conv": 28}

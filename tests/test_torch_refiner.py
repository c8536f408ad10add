"""The port's SDXL refiner against forge_tpu (CPU, f32), and config 2's launches at full width.

A tiny refiner checkpoint in the published layout: a 32-channel UNet with
linear projections, context 64 and adm 2560; its only text tower, an
OpenCLIP-bigG of width 64 whose text projection reaches 1280 (so the
pooled output plus five 256-wide embeddings is 2560, the width the guess
reads as a refiner), under `conditioner.embedders.0.model.`; a 32-channel
VAE. forge_tpu reads OpenCLIP-G only under `conditioner.embedders.1.model.`
and drops this tower (a fault on its side, shown from both sides), so it is
given the same weights under the prefix it reads. Against it: the guess,
the conditioning (context, and `y` with the aesthetic scores 6.0 and 2.5),
and the two-pass txt2img (the tiny SDXL of tests/test_torch_sdxl.py, then
the refiner; 64², DPM++ 2M Karras, 5 steps) at switch 0.5 and 0.8, and
with the hires fix after it, each at PSNR ≥ 40 dB.

The last tests trace config 2 at full width on the meta device (no memory):
the flash and fused-conv calls of a hires request in latent and in pixel
mode, and of a refiner request, each call on its body, as chip_smoke.py
counts them on the card.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.synth import _Fill, synth_unet_sd, synth_vae_sd  # noqa: E402
from test_torch_sdxl import _jax_engine, _port_engine, _psnr, _tiny_sdxl_checkpoint  # noqa: E402
from test_torch_serving import _count, _meta, meta_sdxl_engine  # noqa: E402

GW = 64  # tiny CLIP-G width
POOLED = 1280  # its projection's width: adm = 1280 + 5·256 = 2560
ADM = POOLED + 5 * 256
REFINER_G = "conditioner.embedders.0.model."  # the published refiner layout
BASE_G = "conditioner.embedders.1.model."  # where forge_tpu reads OpenCLIP-G
REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
               seed=1, steps=5, width=64, height=64, sampler_name="DPM++ 2M",
               scheduler="karras", cfg_scale=7.0)


def _tiny_refiner_checkpoint(g_prefix=REFINER_G):
    from test_torch_sdxl import _open_clip_g

    sd = synth_unet_sd(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                       transformer_depth=(0, 1), context_dim=GW, adm_in_channels=ADM,
                       middle_depth=1, fill="random", seed=31)
    for key in [k for k in sd if k.endswith(("proj_in.weight", "proj_out.weight"))]:
        sd[key] = sd[key][:, :, 0, 0]  # the refiner's linear projections
    sd.update(synth_vae_sd(ch=32, fill="random", seed=32))
    g = _open_clip_g(_Fill("random", 33), GW, 2)
    g["conditioner.embedders.1.model.text_projection"] = (
        np.random.default_rng(34).standard_normal((GW, POOLED)) * 0.1).astype(np.float32)
    g["conditioner.embedders.1.model.positional_embedding"] += 0.5
    sd.update({g_prefix + k[len(BASE_G):]: v for k, v in g.items()})
    return sd


@pytest.fixture(scope="module")
def refiners():
    """(forge_tpu's engine fed CLIP-G under embedders.1, the port's from the published layout)."""
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    jeng = jload(_tiny_refiner_checkpoint(BASE_G), dtype=jnp.float32)
    jeng.unet_cfg = JCfg(context_dim=GW, num_heads=4, use_linear_projection=True,
                         adm_in_channels=ADM)
    teng = load_engine(_tiny_refiner_checkpoint(), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=GW, num_heads=4)
    return jeng, teng


@pytest.fixture(scope="module")
def bases():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


def test_refiner_guess_keeps_its_text_encoder():
    """Fault on the reference's side, shown from both sides: the published
    layout guesses as `sdxl_refiner` in both, but forge_tpu collects no text
    encoder (and its engine then cannot be built); the port collects
    OpenCLIP-G and loads it as `clip_g`."""
    from forge_tpu.core.guess import guess as jguess
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.core.guess import guess
    from forge_tpu_torch.pipeline.engine import load_engine

    sd = _tiny_refiner_checkpoint()
    want, got = jguess(sd), guess(sd)
    assert (want.family, want.context_dim) == (got.family, got.context_dim) == ("sdxl_refiner", 1280)
    assert want.text_encoders == {}
    assert list(got.text_encoders) == ["open_clip_g"]
    assert len(got.text_encoders["open_clip_g"]) == 5 + 2 * 12
    with pytest.raises(KeyError, match="clip_g"):
        jload(sd, dtype=jnp.float32)
    eng = load_engine(sd, device="cpu")
    assert eng.family == "sdxl_refiner" and list(eng.text_engines) == ["clip_g"]
    assert jguess(_tiny_refiner_checkpoint(BASE_G)).text_encoders.keys() == {"open_clip_g"}


def test_params_from_jax_carries_the_refiner(refiners):
    """forge_tpu's refiner UNet and CLIP-G trees, turned into the port's
    layout, equal the port's own load of the published layout."""
    from forge_tpu_torch.core.convert import flatten, params_from_jax

    jeng, teng = refiners
    for jtree, ttree in ((jeng.loaded.unet, teng.loaded.unet),
                         (jeng.loaded.text_encoders["clip_g"], teng.loaded.text_encoders["clip_g"])):
        got, want = params_from_jax(jtree), flatten(ttree)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert torch.equal(got[key], value), key


def test_refiner_unet_config():
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu_torch.models.unet import UNetConfig

    got, want = UNetConfig.for_family("sdxl_refiner"), JCfg.for_family("sdxl_refiner")
    assert (got.context_dim, got.head_dim) == (want.context_dim, want.head_dim) == (1280, 64)


def test_refiner_conditioning_matches_forge_tpu(refiners):
    """context = CLIP-G's penultimate hidden states; y = its pooled
    projection ‖ embeddings of (orig h, orig w, crop top, crop left, the
    aesthetic score): 6.0 for a prompt, 2.5 for a negative one."""
    from forge_tpu_torch.ops import nn

    jeng, teng = refiners
    prompts = ["an astronaut riding a (horse:1.3) on the moon", "blurry, [ugly]"]
    for kwargs in (dict(), dict(is_negative=True), dict(crop=(8, 16), original_size=(96, 80))):
        want = jeng.get_learned_conditioning(prompts, 64, 48, **kwargs)
        got = teng.get_learned_conditioning(prompts, 64, 48, **kwargs)
        assert set(got) == set(want) == {"context", "y"}
        assert got["context"].shape == (2, 77, GW) and got["y"].shape == (2, ADM)
        for key in ("context", "y"):
            w = np.asarray(want[key], np.float64)
            err = np.abs(got[key].numpy().astype(np.float64) - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1.0), (key, kwargs, err)
        score = 2.5 if kwargs.get("is_negative") else 6.0
        emb = nn.timestep_embedding(torch.full((2,), score), 256)
        assert torch.allclose(got["y"][:, -256:], emb)


def _two_pass(proc, base, refiner, **fields):
    p = proc.Processing(**dict(REQUEST, **fields))
    p._refiner_engine = refiner
    return proc.process_images(base, p)


@pytest.mark.parametrize("fields", [dict(refiner_switch_at=0.5), dict(refiner_switch_at=0.8),
                                    dict(refiner_switch_at=0.8, enable_hr=True, hr_scale=2.0)],
                         ids=["switch 0.5", "switch 0.8", "switch 0.8 + hires"])
def test_refiner_two_pass_matches_forge_tpu(bases, refiners, fields):
    """The base samples σ[:k+1] (k = round(switch·5)), the refiner σ[k:]
    with its own conds and decodes; with the hires fix the second pass runs
    on the base engine and it decodes."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    want = _two_pass(jproc, bases[0], refiners[0], **fields).images[0]
    res = _two_pass(tproc, bases[1], refiners[1], **fields)
    got = res.images[0]
    size = 128 if fields.get("enable_hr") else 64
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.uint8
    assert "refiner_cond" in res.timings
    value = _psnr(got, want)
    print(f"{fields}: PSNR {value:.2f} dB")
    assert value >= 40.0, value


def test_refiner_switch_steps_and_effect(bases, refiners):
    """k = clamp(round(switch·n), 1, n − 1); a switch outside (0, 1) or no
    refiner runs the base alone; the refiner changes the image, the same
    request twice gives the same bytes."""
    from forge_tpu_torch.pipeline import processing as tproc

    p = tproc.Processing(refiner_switch_at=0.8)
    assert tproc._refiner_step(p, 30) is None  # no refiner named or given
    p._refiner_engine = refiners[1]
    assert [tproc._refiner_step(tproc.Processing(refiner_switch_at=s, refiner_checkpoint="r"), n)
            for s, n in ((0.8, 30), (0.5, 5), (0.01, 30), (0.99, 30), (1.0, 30), (0.0, 30))] == \
        [24, 2, 1, 29, None, None]
    plain = tproc.process_images(bases[1], tproc.Processing(**REQUEST)).images[0]
    refined = _two_pass(tproc, bases[1], refiners[1], refiner_switch_at=0.5).images[0]
    assert not np.array_equal(plain, refined)
    assert np.array_equal(refined, _two_pass(tproc, bases[1], refiners[1],
                                             refiner_switch_at=0.5).images[0])
    alone = _two_pass(tproc, bases[1], refiners[1], refiner_switch_at=1.0).images[0]
    assert np.array_equal(alone, plain)


def test_serving_refuses_hires_and_refiner_requests(bases, refiners):
    """As forge_tpu's serving takes plain txt2img requests only."""
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.serving import ServingPipeline

    hires = tproc.Processing(**REQUEST, enable_hr=True)
    by_name = tproc.Processing(**REQUEST, refiner_checkpoint="refiner", refiner_switch_at=0.8)
    given = tproc.Processing(**REQUEST, refiner_switch_at=0.8)
    given._refiner_engine = refiners[1]
    with ServingPipeline(bases[1]) as pipe:
        futures = [pipe.submit(p) for p in (hires, by_name, given)]
        plain = pipe.submit(tproc.Processing(**REQUEST))
        for fut in futures:
            with pytest.raises(NotImplementedError, match="hires fix or refiner"):
                fut.result(timeout=60)
        assert plain.result(timeout=60)["images"][0].shape == (64, 64, 3)


# -- config 2 at full width, traced on the meta device ----------------------------------


def meta_refiner_engine():
    """A full-width SDXL refiner engine whose every weight is a meta tensor."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.loader import LoadedCheckpoint, convert_open_clip
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_refiner_checkpoint
    from forge_tpu_torch.pipeline.engine import DiffusionEngine

    g = guess.guess(synth_sdxl_refiner_checkpoint(fill=DeviceFill("cpu")))

    def tree(sd):
        return nest({k: _meta(v.shape) for k, v in sd.items()})

    tes = {"clip_g": tree(convert_open_clip(g.text_encoders["open_clip_g"]))}
    loaded = LoadedCheckpoint(g.family, g.prediction, g.context_dim, tree(g.unet),
                              tree(g.vae), tes)
    return DiffusionEngine(loaded, "meta", torch.bfloat16)


def config2_calls():
    """Every flash and fused-conv call of config 2's parts: one model call of
    the base at 1024² (128² latents) and of the hires pass at 2048² (256²),
    one of the refiner at 1024², the 1024² and 2048² decodes and the 2048²
    encode → {part: {kernel: [call]}}, a flash call as (q shape, Lk, body),
    a conv call as (x shape, O, body)."""
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.pipeline import processing as proc

    base, refiner = meta_sdxl_engine(), meta_refiner_engine()
    calls = {}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    def one_call(engine, ctx, adm, side):
        cond = {"context": _meta((1, 77, ctx)), "y": _meta((1, adm))}
        p = proc.Processing(width=1024, height=1024, cfg_scale=7.0, sampler_name="DPM++ 2M")
        job = proc.Job(p, _meta((1, 4, side, side), torch.float32), np.array([14.6, 0.0]), None,
                       cond, cond, engine.loaded.unet)
        return proc.denoise(engine, job)

    parts = {
        "base call": lambda: one_call(base, 2048, 2816, 128),
        "hires call": lambda: one_call(base, 2048, 2816, 256),
        "refiner call": lambda: one_call(refiner, 1280, 2560, 128),
        "decode 1024": lambda: base.decode_dispatch(_meta((1, 4, 128, 128), torch.float32)),
        "encode 2048": lambda: base.encode_first_stage(_meta((1, 3, 2048, 2048), torch.float32)),
        "decode 2048": lambda: base.decode_dispatch(_meta((1, 4, 256, 256), torch.float32)),
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        for name, run in parts.items():
            calls.update(flash=[], conv=[])
            run()
            out[name] = dict(calls)
    return out


@pytest.fixture(scope="module")
def config2():
    return config2_calls()


def _model_calls():
    """(base, hires, refiner-base, refiner) model calls of config 2's requests:
    DPM++ 2M over 30 Karras steps; hires at strength 0.7 (t_enc = int(0.7·30)
    = 21, so σ[8:], 22 calls); the refiner's switch at 0.8."""
    from forge_tpu_torch.pipeline.processing import Processing, _refiner_step
    from forge_tpu_torch.sampling.prediction import DiscretePrediction
    from forge_tpu_torch.sampling.schedules import get_sigmas

    full = get_sigmas("karras", 30, DiscretePrediction())
    t_enc = min(int(0.7 * 30), 30 - 1)
    k = _refiner_step(Processing(refiner_switch_at=0.8, refiner_checkpoint="r"), 30)
    return len(full) - 1, len(full[30 - t_enc - 1:]) - 1, k, 30 - k


def test_config2_hires_launch_counts_and_bodies(config2):
    """(a) latent mode: 30 base calls at 128² (70 flash, 34 conv each), 22
    hires calls at 256² (10 self-attentions of 16384 tokens, 10 heads, and 60
    of 4096, 20 heads; 34 convs each), the 2048² decode (one head of 512 over
    65536 tokens; 28 convs): 3641 flash, 1796 conv. (c) pixel mode adds the
    1024² decode (1, 28) and the 2048² encode (1, 20): 3643 and 1844. Every
    call on the tensor-core body."""
    c = config2
    assert all(body == "wgmma" for part in c.values() for kind in part.values()
               for *_, body in kind)
    base_calls, hires_calls, _, _ = _model_calls()
    assert (base_calls, hires_calls) == (30, 22)
    base, hires = c["base call"], c["hires call"]
    assert _count(base["flash"]) == {((2, 10, 4096, 64), 4096): 10, ((2, 20, 1024, 64), 1024): 60}
    assert _count(hires["flash"]) == {((2, 10, 16384, 64), 16384): 10,
                                      ((2, 20, 4096, 64), 4096): 60}
    assert len(base["conv"]) == len(hires["conv"]) == 34
    assert sorted({(x[1], o) for x, o, _ in hires["conv"]}) == sorted(
        {(x[1], o) for x, o, _ in base["conv"]})  # the same twelve (C, O) pairs, on 256²
    assert len({(x[1], o) for x, o, _ in hires["conv"]}) == 12
    assert {x[2] for x, _, _ in hires["conv"]} == {256, 128, 64}
    assert c["decode 2048"]["flash"] == c["encode 2048"]["flash"] == [
        ((1, 1, 65536, 512), 65536, "wgmma")]
    assert c["decode 1024"]["flash"] == [((1, 1, 16384, 512), 16384, "wgmma")]
    dec, enc, dec1k = (len(c[p]["conv"]) for p in ("decode 2048", "encode 2048", "decode 1024"))
    assert (dec, enc, dec1k) == (28, 20, 28)
    latent = {k: base_calls * len(base[k]) + hires_calls * len(hires[k]) + len(c["decode 2048"][k])
              for k in ("flash", "conv")}
    assert latent == {"flash": 3641, "conv": 1796}
    pixel = {k: latent[k] + len(c["decode 1024"][k]) + len(c["encode 2048"][k])
             for k in ("flash", "conv")}
    assert pixel == {"flash": 3643, "conv": 1844}


def test_config2_refiner_launch_counts_and_bodies(config2):
    """(b) 24 base calls, then 6 refiner calls at 128²: 20 self-attentions
    of 4096 tokens (768 wide, 12 heads) and 20 of 1024 (1536, 24 heads); the
    middle block's 4 see 256 tokens, below the kernel's 512 cut; 22
    ResBlocks, 44 convs a call, C 384 to 3072; then the refiner's 1024²
    decode: 1921 flash, 1108 conv."""
    c = config2
    _, _, k, refiner_calls = _model_calls()
    assert (k, refiner_calls) == (24, 6)
    ref = c["refiner call"]
    assert _count(ref["flash"]) == {((2, 12, 4096, 64), 4096): 20, ((2, 24, 1024, 64), 1024): 20}
    assert len(ref["conv"]) == 44 and all(body == "wgmma" for *_, body in ref["conv"])
    pairs = sorted({(x[1], o, x[2]) for x, o, _ in ref["conv"]})
    assert pairs == [(384, 384, 128), (384, 768, 64), (768, 384, 128), (768, 768, 64),
                     (768, 1536, 32), (1152, 384, 128), (1152, 768, 64), (1536, 768, 64),
                     (1536, 1536, 16), (1536, 1536, 32), (2304, 768, 64), (2304, 1536, 32),
                     (3072, 1536, 16), (3072, 1536, 32)]
    total = {kind: k * len(c["base call"][kind]) + refiner_calls * len(ref[kind])
             + len(c["decode 1024"][kind]) for kind in ("flash", "conv")}
    assert total == {"flash": 1921, "conv": 1108}


def test_full_width_refiner_checkpoint():
    """The published refiner's key set, shapes only: 384 channels, 44
    transformer blocks, context 1280, adm 2560, CLIP-G 1280 × 32 with its
    projection, ~2.3 B UNet parameters."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_refiner_checkpoint

    g = guess.guess(synth_sdxl_refiner_checkpoint(fill=DeviceFill("cpu")))
    assert (g.family, g.context_dim) == ("sdxl_refiner", 1280)
    assert g.unet["input_blocks.0.0.weight"].shape == (384, 4, 3, 3)
    assert g.unet["label_emb.0.0.weight"].shape == (1536, 2560)
    assert sum(k.endswith("attn1.to_q.weight") for k in g.unet) == 44
    assert g.unet["middle_block.1.transformer_blocks.0.attn2.to_k.weight"].shape == (1536, 1280)
    assert 2.2e9 < sum(v.size for v in g.unet.values()) < 2.4e9
    te = g.text_encoders["open_clip_g"]
    assert te["text_projection"].shape == (1280, 1280)
    assert sum(k.endswith("attn.in_proj_weight") for k in te) == 32

"""The port's Chroma slice against forge_tpu and the golden fixture (CPU, f32).

- `chroma_apply` against forge_tpu's on the same weights (≤ 1e-4 of the
  output scale) and against `tests/golden/chroma_tiny.npz` (the reference
  torch model's output; PSNR ≥ 40 dB, the bar of tests/test_golden_parity.py);
- the engine: the family, `PredictionFlux`, T5 conditioning with `y` zeros
  without CLIP-L and CLIP-L's pooled output with it;
- a tiny Chroma checkpoint (a 2 + 2 block transformer, hidden 64, an
  Approximator 64 × 2, T5 64 wide, the 16-channel VAE) through `load_engine`
  + `process_images` in both packages with real CFG and a negative prompt,
  txt2img and img2img;
- AND: forge_tpu's batched call raises KeyError 'guidance' on Chroma (its
  branches lack the guidance its cond carries) though `chroma_apply` reads no
  guidance; the port refuses AND and regional prompts on Chroma.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.synth import (synth_chroma_sd, synth_clip_sd, synth_t5_sd,  # noqa: E402
                                  synth_vae_sd)
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
AXES = (4, 6, 6)
REQUEST = dict(prompt="a red fox in the snow", negative_prompt="blurry", seed=3, steps=3,
               width=32, height=32, cfg_scale=4.0, sampler_name="Euler", scheduler="simple")


def _psnr(ours, ref, peak=None):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    mse = float(np.mean((ours - ref) ** 2))
    peak = float(np.max(np.abs(ref))) if peak is None else peak
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _assert_close(got, want, rel=1e-4):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _golden_sd():
    return synth_chroma_sd(hidden=64, num_heads=4, depth=2, depth_single=2, context_dim=32,
                           approx_hidden=64, approx_layers=2, fill="random", seed=8, prefix="")


def _jax_chroma(sd, x, t, ctx, guidance=None):
    from forge_tpu.models.chroma import chroma_apply as jchroma
    from forge_tpu.models.flux import FluxConfig as JCfg

    params = jax_nest({k: jnp.asarray(np.asarray(v)) for k, v in transform_for_jax(sd).items()})
    return np.asarray(jchroma(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
                              jnp.asarray(ctx), guidance=guidance,
                              cfg=JCfg(num_heads=4, axes_dim=AXES, guidance_embed=False))
                      ).transpose(0, 3, 1, 2)


def _port_chroma(sd, x, t, ctx, guidance=None):
    from forge_tpu_torch.models.chroma import chroma_apply
    from forge_tpu_torch.models.flux import FluxConfig

    tree = nest({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        return chroma_apply(tree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                            guidance=guidance,
                            cfg=FluxConfig(num_heads=4, axes_dim=AXES, guidance_embed=False)
                            ).numpy()


def test_chroma_apply_matches_forge_tpu_and_golden():
    g = np.load(os.path.join(GOLDEN, "chroma_tiny.npz"))
    sd = _golden_sd()
    x, t, ctx = g["x"], (g["t"] * 1000.0).astype(np.float32), g["ctx"]
    got = _port_chroma(sd, x, t, ctx)
    _assert_close(got, _jax_chroma(sd, x, t, ctx))
    assert _psnr(got, g["ref"]) >= 40.0, _psnr(got, g["ref"])


def test_chroma_modulation_slots_and_batch():
    """344 slots at 19 + 38 blocks; at batch 2 with two timesteps each image
    equals its own batch-1 forward (the Approximator's input is per image)."""
    from forge_tpu_torch.models.chroma import modulation_slots

    assert modulation_slots(19, 38) == 344
    sd = _golden_sd()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    t = np.asarray([900.0, 250.0], np.float32)
    both = _port_chroma(sd, x, t, ctx)
    _assert_close(both, _jax_chroma(sd, x, t, ctx))
    for i in range(2):
        _assert_close(both[i:i + 1], _port_chroma(sd, x[i:i + 1], t[i:i + 1], ctx[i:i + 1]),
                      rel=1e-5)


def _tiny_chroma_checkpoint(clip_l: bool = False):
    sd = {}
    sd.update(synth_chroma_sd(hidden=64, num_heads=4, depth=2, depth_single=2, context_dim=64,
                              approx_hidden=64, approx_layers=2, fill="random", seed=41))
    sd.update(synth_vae_sd(ch=32, z_channels=16, fill="random", seed=42))
    sd.update(synth_t5_sd(width=64, layers=2, heads=4, ff=128, fill="random", seed=44))
    if clip_l:
        sd.update(synth_clip_sd(width=64, layers=2, fill="random", seed=43,
                                prefix="text_encoders.clip_l.transformer."))
        sd["text_encoders.clip_l.transformer.text_model.final_layer_norm.bias"] = np.full(
            64, 0.1, np.float32)
    return sd


def _engines(sd):
    from forge_tpu.models.flux import FluxConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.models.flux import FluxConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    jeng = jload(dict(sd), dtype=jnp.float32)
    jeng.flux_cfg = JCfg(num_heads=4, axes_dim=AXES, guidance_embed=False)
    teng = load_engine(dict(sd), device="cpu")
    teng.flux_cfg = FluxConfig(num_heads=4, axes_dim=AXES, guidance_embed=False)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _engines(_tiny_chroma_checkpoint())


def test_chroma_engine_family_predictor_and_conds(engines):
    from forge_tpu_torch.sampling.prediction import PredictionFlux

    jeng, teng = engines
    assert teng.family == jeng.family == "chroma"
    assert isinstance(teng.predictor, PredictionFlux) and teng.predictor.family == "chroma"
    assert np.array_equal(np.asarray(jeng.predictor.sigmas), teng.predictor.sigmas)
    assert set(teng.text_engines) == set(jeng.text_engines) == {"t5xxl"}
    assert teng.flux_cfg.guidance_embed is False and "guidance_in" not in teng.loaded.unet
    prompts = ["a red fox, (snow:1.2)", "blurry"]
    want = jeng.get_learned_conditioning(prompts, 32, 32)
    got = teng.get_learned_conditioning(prompts, 32, 32)
    assert got["context"].shape == (2, 512, 64) and got["y"].shape == (2, 768)
    assert not got["y"].any()
    _assert_close(got["context"].numpy(), np.asarray(want["context"]))
    _assert_close(got["y"].numpy(), np.asarray(want["y"]))


def test_chroma_conds_with_clip_l():
    """With CLIP-L in the checkpoint, `y` is its pooled output, as for Flux."""
    jeng, teng = _engines(_tiny_chroma_checkpoint(clip_l=True))
    assert set(teng.text_engines) == {"clip_l", "t5xxl"}
    want = jeng.get_learned_conditioning(["a red fox"], 32, 32)
    got = teng.get_learned_conditioning(["a red fox"], 32, 32)
    assert got["y"].shape == (1, 64) and got["y"].abs().max() > 0
    _assert_close(got["y"].numpy(), np.asarray(want["y"]))
    _assert_close(got["context"].numpy(), np.asarray(want["context"]))


@pytest.mark.parametrize("mode", ["txt2img", "img2img"])
def test_chroma_request_matches_forge_tpu(engines, mode):
    """CFG 4 with a negative prompt: the uncond branch runs (Chroma has no
    distilled guidance), 3 Euler "simple" steps; img2img at strength 0.6."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    fields = dict(REQUEST)
    if mode == "img2img":
        init = np.random.default_rng(7).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        fields.update(init_images=[init], denoising_strength=0.6)
    want = jproc.process_images(jeng, jproc.Processing(**fields)).images[0]
    got = process_images(teng, Processing(**fields)).images[0]
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8
    assert _psnr(got, want, peak=255.0) >= 40.0, _psnr(got, want, peak=255.0)
    assert np.array_equal(got, process_images(teng, Processing(**fields)).images[0])


def test_chroma_and_prompt_both_sides(engines):
    """The AND decision. forge_tpu adds the guidance scale to cond and uncond
    but not to AND branches, and its batched call takes the keys of the cond:
    an AND prompt on Chroma raises KeyError 'guidance' there, although
    `chroma_apply` never reads a guidance (equal outputs with and without one,
    in both packages). The port refuses AND and regional prompts on Chroma,
    as on Flux, and says why."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    sd = _golden_sd()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    t = np.asarray([600.0], np.float32)
    assert np.array_equal(_jax_chroma(sd, x, t, ctx),
                          _jax_chroma(sd, x, t, ctx, guidance=jnp.asarray([7.5])))
    assert np.array_equal(_port_chroma(sd, x, t, ctx),
                          _port_chroma(sd, x, t, ctx, guidance=torch.tensor([7.5])))
    fields = dict(REQUEST, prompt="a red fox AND a snowy owl :0.7", steps=2)
    with pytest.raises(KeyError, match="guidance"):
        jproc.process_images(jeng, jproc.Processing(**fields))
    with pytest.raises(NotImplementedError, match="AND and regional prompts on chroma"):
        process_images(teng, Processing(**fields))
    regions = [dict(prompt="a fox", area=(0.0, 0.0, 0.5, 1.0))]
    with pytest.raises(NotImplementedError):
        process_images(teng, Processing(**dict(REQUEST, regional_prompts=regions)))


def test_chroma_refuses_controlnets_and_hooks(engines):
    """The reference's Chroma apply takes ControlNets and hooks and drops them;
    the port refuses them, as on Flux."""
    _, teng = engines
    with pytest.raises(NotImplementedError, match="drops them"):
        teng.unet_apply_fn(hooks={"attn1_patch": [lambda *a: a]})

"""The port's Flux slice against forge_tpu and the golden fixtures (CPU, f32).

- T5 and Flux against `tests/golden/t5_tiny.npz` / `flux_tiny.npz` (PSNR ≥
  40 dB, the bar of tests/test_golden_parity.py) and against forge_tpu on
  the same weights (≤ 1e-4 of the output scale: both f32, only summation
  order differs);
- Flux at hidden 512, head dim 128, one double and one single block, dense
  and with quantized leaves of every kind against forge_tpu on the
  dequantized weights (≤ 1e-4 of the output scale);
- the pure-Python T5 tokenizer id for id against `transformers`;
- the whole slice: a tiny Flux checkpoint through `load_engine` +
  `process_images` in both packages (32², 2 steps, Euler, "simple", CFG 1),
  image PSNR ≥ 40 dB, dense and quantized.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.synth import synth_clip_sd, synth_flux_sd, synth_t5_sd, synth_vae_sd  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu.ops import quant as jquant  # noqa: E402
from forge_tpu_torch.core.convert import nest, quant_leaf  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOKENIZER_JSON = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                              "t5_tokenizer", "tokenizer.json")
KINDS = ["q8_0", "nf4", "q4_0", "gq4", "gq8"]
REQUEST = dict(prompt="a red fox, (sharp focus:1.2)", seed=3, steps=2, width=32, height=32,
               cfg_scale=1.0, sampler_name="Euler", scheduler="simple")


def _psnr(ours, ref, peak=None):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    mse = float(np.mean((ours - ref) ** 2))
    peak = float(np.max(np.abs(ref))) if peak is None else peak
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _assert_close(got, want, rel=1e-4):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _torch_tree(sd):
    return nest({k: quant_leaf(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
                 for k, v in sd.items()})


def test_t5_matches_golden_and_forge_tpu():
    from forge_tpu.models.t5 import t5_apply as jt5
    from forge_tpu_torch.models.t5 import t5_apply

    g = np.load(os.path.join(GOLDEN, "t5_tiny.npz"))
    sd = synth_t5_sd(width=64, layers=2, heads=4, ff=128, vocab=100, fill="random",
                     seed=24, prefix="")
    want = np.asarray(jt5(jax_nest({k: jnp.asarray(v) for k, v in sd.items()}),
                          jnp.asarray(g["toks"].astype(np.int32)), num_heads=4,
                          attention_mask=jnp.asarray(g["mask"].astype(np.float32))))
    with torch.no_grad():
        got = t5_apply(_torch_tree(sd), torch.from_numpy(g["toks"]),
                       attention_mask=torch.from_numpy(g["mask"])).numpy()
    _assert_close(got, want)
    assert _psnr(got, g["ref"]) >= 40.0


def _flux_args(g):
    return (torch.from_numpy(g["x"]), torch.from_numpy(g["t"] * 1000.0),
            torch.from_numpy(g["ctx"]), torch.from_numpy(g["y"]), torch.from_numpy(g["g"]))


def test_flux_matches_golden_and_forge_tpu():
    from forge_tpu.models.flux import FluxConfig as JCfg, flux_apply as jflux
    from forge_tpu_torch.models.flux import FluxConfig, flux_apply

    g = np.load(os.path.join(GOLDEN, "flux_tiny.npz"))
    sd = synth_flux_sd(hidden=64, num_heads=4, depth=2, depth_single=2, context_dim=64,
                       pooled_dim=64, fill="random", seed=21, prefix="")
    want = np.asarray(jflux(
        jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()}),
        jnp.asarray(g["x"].transpose(0, 2, 3, 1)), jnp.asarray(g["t"] * 1000.0),
        jnp.asarray(g["ctx"]), jnp.asarray(g["y"]), guidance=jnp.asarray(g["g"]),
        cfg=JCfg(num_heads=4, axes_dim=(4, 6, 6), guidance_embed=True))).transpose(0, 3, 1, 2)
    x, t, ctx, y, gd = _flux_args(g)
    with torch.no_grad():
        got = flux_apply(_torch_tree(sd), x, t, ctx, y, guidance=gd,
                         cfg=FluxConfig(num_heads=4, axes_dim=(4, 6, 6))).numpy()
    _assert_close(got, want)
    assert _psnr(got, g["ref"]) >= 40.0


@pytest.mark.parametrize("kind", [None] + KINDS)
def test_flux_head_dim_128_dense_and_quantized(kind):
    """Hidden 512 (4 heads of 128, the Flux-dev head width and RoPE axes),
    depth 1 + 1. Quantized: every 2-D weight (bar norms, embeddings and
    biases) as a quant leaf in the port; forge_tpu gets the same codes
    dequantized to f32."""
    from forge_tpu.models.flux import FluxConfig as JCfg, flux_apply as jflux
    from forge_tpu_torch.models.flux import FluxConfig, flux_apply

    sd = synth_flux_sd(hidden=512, num_heads=4, depth=1, depth_single=1, context_dim=64,
                       pooled_dim=96, fill="random", seed=31, prefix="")
    n_quant = 0
    if kind is not None:
        for key in list(sd):
            if sd[key].ndim == 2 and not any(s in key for s in ("norm", "emb", "bias")):
                sd[key] = jquant.quantize(sd[key], kind)
                n_quant += 1
        assert n_quant == 10 + 3 + 10
    dense = {k: (np.asarray(jquant.dequantize(v, jnp.float32)) if isinstance(v, dict) else v)
             for k, v in sd.items()}
    rng = np.random.default_rng(32)
    x = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 12, 64)).astype(np.float32)
    y = rng.standard_normal((1, 96)).astype(np.float32)
    t = np.asarray([700.0], np.float32)
    gd = np.asarray([3.5], np.float32)
    want = np.asarray(jflux(
        jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(dense).items()}),
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(y),
        guidance=jnp.asarray(gd), cfg=JCfg(num_heads=4))).transpose(0, 3, 1, 2)
    tree = _torch_tree(sd)
    with torch.no_grad():
        got = flux_apply(tree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         torch.from_numpy(y), guidance=torch.from_numpy(gd),
                         cfg=FluxConfig(num_heads=4)).numpy()
    _assert_close(got, want)


PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "",
    "Hello,   world!! 123 4.5e-3 (x) [y] {z}",
    "café naïve résumé — “quotes” ½ ﬁ",
    "日本語のテキスト、カタカナ",
    "emoji 👍🏽 and 👨‍👩‍👧 ok",
    "(masterpiece:1.2), [blurry], best quality, 8k uhd",
    "ｆｕｌｌｗｉｄｔｈ ＡＢＣ １２３  trailing spaces   ",
    "über-cool_snake_case and CamelCase; $100 & 50% off #tag @user ~tilde",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_t5_tokenizer_matches_transformers(prompt):
    transformers = pytest.importorskip("transformers")
    from forge_tpu_torch.text.t5_tokenizer import T5Tokenizer

    hf = transformers.T5TokenizerFast(tokenizer_file=TOKENIZER_JSON)
    assert T5Tokenizer(TOKENIZER_JSON).encode(prompt) == \
        hf(prompt, add_special_tokens=False)["input_ids"]


def test_flow_predictor_and_simple_schedule_match_forge_tpu():
    from forge_tpu.sampling.prediction import PredictionFlux as JFlux
    from forge_tpu.sampling.schedules import get_sigmas as jsigmas
    from forge_tpu_torch.core import latent_formats
    from forge_tpu_torch.sampling.prediction import PredictionFlux
    from forge_tpu_torch.sampling.schedules import get_sigmas

    j, t = JFlux(), PredictionFlux()
    assert j.mu == t.mu and np.array_equal(j.sigmas, t.sigmas)
    assert (j.sigma_min, j.sigma_max) == (t.sigma_min, t.sigma_max)
    assert np.array_equal(jsigmas("simple", 4, j), get_sigmas("simple", 4, t))
    noise = np.random.default_rng(0).standard_normal((1, 16, 4, 4)).astype(np.float32)
    s = np.float32(0.8)
    assert np.array_equal(np.asarray(j.noise_scaling(s, noise, np.zeros_like(noise))),
                          t.noise_scaling(s, noise, np.zeros_like(noise)))
    fmt = latent_formats.BY_FAMILY["flux"]
    assert (fmt.scale_factor, fmt.shift_factor, fmt.latent_channels) == (0.3611, 0.1159, 16)


def test_full_width_checkpoint_quantizes_314_leaves_per_forward():
    """The loader's rule on the full Flux-dev key set, shapes only (nothing
    is made): 10 per double block × 19 + 3 per single block × 38 + 10
    top-level matmul weights become quant leaves."""
    from forge_tpu_torch.core.loader import _quantizes
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor, synth_flux_sd as tsynth

    sd = tsynth(fill=DeviceFill("cpu"), prefix="")
    assert all(isinstance(v, LazyTensor) for v in sd.values())
    picked = [k for k, v in sd.items() if _quantizes(k, v.shape)]
    assert len(picked) == 10 * 19 + 3 * 38 + 10 == 314
    assert "final_layer.linear.weight" in picked and "img_in.weight" in picked
    assert sum(v.size for v in sd.values()) > 11.9e9


def test_device_fill_is_seeded_per_tensor():
    from forge_tpu_torch.core.synth import DeviceFill, synth_t5_sd as tsynth

    a = tsynth(width=64, layers=1, heads=1, ff=32, vocab=50, fill=DeviceFill("cpu", seed=1))
    b = tsynth(width=64, layers=1, heads=1, ff=32, vocab=50, fill=DeviceFill("cpu", seed=1))
    wo = "text_encoders.t5xxl.transformer.encoder.block.0.layer.1.DenseReluDense.wo.weight"
    q, k = (f"text_encoders.t5xxl.transformer.encoder.block.0.layer.0.SelfAttention.{n}.weight"
            for n in "qk")
    w1 = a[wo].materialize()  # made first here, last in `b`: the same tensor
    assert torch.equal(w1, b[wo].materialize())
    assert torch.equal(a[q].materialize(), b[q].materialize())
    assert not torch.equal(a[q].materialize(), a[k].materialize())
    assert 0.015 < float(w1.std()) < 0.025


# -- the whole slice ---------------------------------------------------------


def _tiny_flux_checkpoint():
    sd = {}
    sd.update(synth_flux_sd(hidden=64, num_heads=4, depth=2, depth_single=2, context_dim=64,
                            pooled_dim=64, fill="random", seed=21))
    sd.update(synth_vae_sd(ch=32, z_channels=16, fill="random", seed=22))
    sd.update(synth_clip_sd(width=64, layers=2, fill="random", seed=23,
                            prefix="text_encoders.clip_l.transformer."))
    sd.update(synth_t5_sd(width=64, layers=2, heads=4, ff=128, fill="random", seed=24))
    # nonzero final-norm biases keep the emphasis renormalisation well conditioned
    sd["text_encoders.clip_l.transformer.text_model.final_layer_norm.bias"] = np.full(
        64, 0.1, np.float32)
    return sd


def _forge_tpu_image(sd):
    from forge_tpu.models.flux import FluxConfig as JCfg
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.pipeline.engine import load_engine as jload

    eng = jload(sd, dtype=jnp.float32)
    eng.flux_cfg = JCfg(num_heads=4, axes_dim=(4, 6, 6), guidance_embed=True)
    return jproc.process_images(eng, jproc.Processing(**REQUEST)).images[0]


def _port_engine(sd, unet_quant=None):
    from forge_tpu_torch.models.flux import FluxConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    eng = load_engine(sd, device="cpu", unet_quant=unet_quant)
    eng.flux_cfg = FluxConfig(num_heads=4, axes_dim=(4, 6, 6))
    return eng


def _img_psnr(a, b):
    return _psnr(a, b, peak=255.0)


def test_flux_txt2img_matches_forge_tpu():
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    sd = _tiny_flux_checkpoint()
    want = _forge_tpu_image(dict(sd))
    eng = _port_engine(dict(sd))
    assert eng.family == "flux" and set(eng.text_engines) == {"clip_l", "t5xxl"}
    assert eng.compute_dtype == torch.float32
    cond = eng.get_learned_conditioning(["a red fox"])
    assert cond["context"].shape == (1, 512, 64) and cond["y"].shape == (1, 64)
    res = process_images(eng, Processing(**REQUEST))
    got = res.images[0]
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8
    assert _img_psnr(got, want) >= 40.0, _img_psnr(got, want)
    assert np.array_equal(got, process_images(eng, Processing(**REQUEST)).images[0])


@pytest.mark.parametrize("kind", ["nf4", "q4_0", "q8_0"])
def test_flux_quantized_txt2img_matches_forge_tpu_on_dequantized_weights(kind, monkeypatch):
    """`unet_quant` with the size cut lowered so the tiny matmul weights
    quantize; forge_tpu runs the same codes dequantized, dense."""
    from forge_tpu_torch.core import loader
    from forge_tpu_torch.ops.quant import QuantLeaf, dequantize
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    monkeypatch.setattr(loader, "QUANT_MIN_SIZE", 0)
    sd = _tiny_flux_checkpoint()
    eng = _port_engine(dict(sd), unet_quant=kind)
    leaves = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif isinstance(v, QuantLeaf):
                leaves[prefix + k] = v

    walk(eng.loaded.unet, "")
    assert len(leaves) == 10 * 2 + 3 * 2 + 10 and all(q.kind == kind for q in leaves.values())
    got = process_images(eng, Processing(**REQUEST)).images[0]
    dense = dict(sd)
    for key, leaf in leaves.items():
        dense["model.diffusion_model." + key] = dequantize(leaf, torch.float32).numpy()
    want = _forge_tpu_image(dense)
    assert _img_psnr(got, want) >= 40.0, _img_psnr(got, want)

"""The port's ControlNet against forge_tpu (CPU, f32), and config 3's launch counts.

A tiny SDXL-geometry ControlNet (`synth_controlnet_sd` at model width 32,
two levels, one transformer block, linear projections as SDXL has) goes
through `controlnet_apply`, `run_controlnets` (strength, the schedule gate,
block weights) and the tiny SDXL UNet with its residuals, in both packages:
outputs agree to 1e-4 of their scale. The launch-count test traces one
full-width config-3 step (SDXL UNet + SDXL ControlNet at batch 2, 1024²) and
the 1024² VAE encode on the meta device, as the SDXL dispatch tests trace
txt2img.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.synth import synth_controlnet_sd as jsynth_controlnet_sd  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest  # noqa: E402
from test_torch_sdxl import ADM, CTX, _tiny_sdxl_checkpoint  # noqa: E402


def _assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def tiny_controlnet_sd(seed=17):
    """The tiny SDXL's encoder geometry as a cldm ControlNet, random weights."""
    from forge_tpu_torch.core.synth import synth_controlnet_sd

    kw = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, transformer_depth=(0, 1),
              context_dim=CTX, adm_in_channels=ADM, fill="random", seed=seed)
    sd = synth_controlnet_sd(**kw)
    want = jsynth_controlnet_sd(**kw)  # the port's copy makes the reference's dict
    assert list(sd) == list(want) and all(np.array_equal(sd[k], want[k]) for k in sd)
    for key in [k for k in sd if k.endswith(("proj_in.weight", "proj_out.weight"))]:
        sd[key] = sd[key][:, :, 0, 0]
    return sd


def jcfg():
    from forge_tpu.models.unet import UNetConfig as JCfg

    return JCfg(context_dim=CTX, num_heads=4, use_linear_projection=True, adm_in_channels=ADM)


def tcfg():
    from forge_tpu_torch.models.unet import UNetConfig

    return UNetConfig(context_dim=CTX, num_heads=4)


@pytest.fixture(scope="module")
def trees():
    sd = tiny_controlnet_sd()
    jtree = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})
    return jtree, nest({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})


def _inputs(hint_size=64, seed=5):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([999.0, 321.0], np.float32)
    ctx = r.standard_normal((2, 77, CTX)).astype(np.float32)
    y = r.standard_normal((2, ADM)).astype(np.float32)
    hint = r.uniform(size=(1, 3, hint_size, hint_size)).astype(np.float32)
    return x, t, ctx, y, hint


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("hint_size", [64, 48, 80])
def test_controlnet_apply_matches(trees, hint_size):
    """Residuals deepest first, one per input block, and the middle one; a
    hint made for another size is resized to the latent's (antialiased
    bilinear, as jax.image.resize)."""
    from forge_tpu.models.controlnet import controlnet_apply as japply
    from forge_tpu_torch.models.controlnet import controlnet_apply

    jtree, tree = trees
    x, t, ctx, y, hint = _inputs(hint_size)
    want = japply(jtree, _nhwc(x), _nhwc(hint), jnp.asarray(t), jnp.asarray(ctx),
                  y=jnp.asarray(y), cfg=jcfg())
    with torch.no_grad():
        got = controlnet_apply(tree, torch.from_numpy(x), torch.from_numpy(hint),
                               torch.from_numpy(t), torch.from_numpy(ctx),
                               y=torch.from_numpy(y), cfg=tcfg())
    assert [tuple(r.shape) for r in got["output"]] == [(2, 64, 4, 4), (2, 32, 4, 4),
                                                        (2, 32, 8, 8), (2, 32, 8, 8)]
    for g, w in zip(got["output"] + got["middle"], want["output"] + want["middle"]):
        _assert_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))


def _states(mod, tree, hint, cfg, **kw):
    return [mod.ControlNetState(params=tree, hint=hint, cfg=cfg, **kw)]


@pytest.mark.parametrize("kw,frac", [
    (dict(strength=1.0), 0.3),
    (dict(strength=0.5, block_weights=[1.0, 0.5, 0.0]), 0.3),
    (dict(strength=1.5, start_percent=0.2, end_percent=0.6), 0.6),
    (dict(strength=1.0, start_percent=0.5), 0.3),  # before its range: nothing
])
def test_run_controlnets_matches(trees, kw, frac):
    from forge_tpu.models import controlnet as jcn
    from forge_tpu_torch.models import controlnet as tcn

    jtree, tree = trees
    x, t, ctx, y, hint = _inputs()
    want = jcn.run_controlnets(_states(jcn, jtree, _nhwc(hint), jcfg(), **kw), _nhwc(x),
                               jnp.asarray(t), jnp.asarray(np.float32(frac)), jnp.asarray(ctx),
                               y=jnp.asarray(y))
    with torch.no_grad():
        got = tcn.run_controlnets(_states(tcn, tree, torch.from_numpy(hint), tcfg(), **kw),
                                  torch.from_numpy(x), torch.from_numpy(t), frac,
                                  torch.from_numpy(ctx), y=torch.from_numpy(y))
    wants = [np.asarray(w).transpose(0, 3, 1, 2) for w in want["output"] + want["middle"]]
    if kw.get("start_percent", 0.0) > frac:  # gated off: the port does not run the net
        assert got is None and all(np.abs(w).max() == 0 for w in wants)
        return
    for g, w in zip(got["output"] + got["middle"], wants):
        _assert_close(g.numpy(), w)
    if "block_weights" in kw:
        assert np.abs(got["output"][2].numpy()).max() == 0  # weight 0.0


def test_unet_with_control_matches(trees):
    """The tiny SDXL UNet with the ControlNet's residuals added after each
    input block's skip and the middle block."""
    from forge_tpu.models import controlnet as jcn
    from forge_tpu.models.unet import unet_apply as junet
    from forge_tpu_torch.models import controlnet as tcn
    from forge_tpu_torch.models.unet import unet_apply

    jtree, tree = trees
    prefix = "model.diffusion_model."
    usd = {k[len(prefix):]: v for k, v in _tiny_sdxl_checkpoint().items() if k.startswith(prefix)}
    ujtree = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(usd).items()})
    utree = nest({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in usd.items()})
    x, t, ctx, y, hint = _inputs()
    jctrl = jcn.run_controlnets(_states(jcn, jtree, _nhwc(hint), jcfg(), strength=2.0), _nhwc(x),
                                jnp.asarray(t), jnp.asarray(np.float32(0.5)), jnp.asarray(ctx),
                                y=jnp.asarray(y))
    want = junet(ujtree, _nhwc(x), jnp.asarray(t), jnp.asarray(ctx), y=jnp.asarray(y), cfg=jcfg(),
                 control=jctrl)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    args = (utree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        ctrl = tcn.run_controlnets(_states(tcn, tree, torch.from_numpy(hint), tcfg(), strength=2.0),
                                   torch.from_numpy(x), torch.from_numpy(t), 0.5,
                                   torch.from_numpy(ctx), y=torch.from_numpy(y))
        got = unet_apply(*args, y=torch.from_numpy(y), cfg=tcfg(), control=ctrl).numpy()
        plain = unet_apply(*args, y=torch.from_numpy(y), cfg=tcfg()).numpy()
    _assert_close(got, want)
    assert np.abs(got - plain).max() > 1e-3  # the residuals took part


def test_engine_gate_reads_the_host_timestep(trees):
    """With ControlNets, `make_apply_model` hands the UNet's apply the host
    timestep; the gate 1 − t/999 is computed from it, and the result equals
    the apply that reads t from the tensor."""
    from test_torch_sdxl import _port_engine

    from forge_tpu_torch.models.controlnet import ControlNetState
    from forge_tpu_torch.sampling import cfg as cfg_mod

    _, tree = trees
    eng = _port_engine(_tiny_sdxl_checkpoint())
    x, t, ctx, y, hint = _inputs()
    states = [ControlNetState(params=tree, hint=torch.from_numpy(hint), cfg=tcfg(),
                              start_percent=0.0, end_percent=0.5)]
    apply = eng.unet_apply_fn(controlnets=states)
    assert apply.takes_host_timestep
    seen = []

    def spy(params, x_, ts, t_host=None, **cond):
        seen.append(t_host)
        return apply(params, x_, ts, t_host=t_host, **cond)

    spy.takes_host_timestep = True
    model = cfg_mod.make_apply_model(spy, eng.loaded.unet, eng.predictor, torch.float32)
    cond = {"context": torch.from_numpy(ctx), "y": torch.from_numpy(y)}
    with torch.no_grad():
        for sigma in (14.6, 0.5):  # t ≈ 999 (gate on) and t ≈ 150 (frac 0.85: off)
            got = model(torch.from_numpy(x), sigma, cond)
            ts = torch.full((2,), seen[-1])
            want = eng.predictor.calculate_denoised(
                sigma, apply(eng.loaded.unet, eng.predictor.calculate_input(sigma, torch.from_numpy(x)),
                             ts, **cond), torch.from_numpy(x))
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert isinstance(seen[0], float) and seen[0] > 990 and seen[1] < 500
    off = eng.unet_apply_fn()(eng.loaded.unet, torch.from_numpy(x), torch.full((2,), seen[1]), **cond)
    assert torch.equal(apply(eng.loaded.unet, torch.from_numpy(x), torch.full((2,), seen[1]),
                             t_host=seen[1], **cond), off)


def test_load_controlnet(tmp_path):
    from forge_tpu_torch.core.loader import load_controlnet
    from forge_tpu_torch.core.save import save_safetensors

    sd = tiny_controlnet_sd()
    path = str(tmp_path / "cn.safetensors")
    save_safetensors({"control_model." + k: v for k, v in sd.items()}, path)
    tree = load_controlnet(path, torch.float32, "cpu")
    w = tree["input_blocks"]["1"]["0"]["in_layers"]["2"]["weight"]
    assert w.dtype == torch.float32 and w.is_contiguous()  # channels_last only on the card
    assert np.array_equal(w.numpy(), sd["input_blocks.1.0.in_layers.2.weight"])
    assert set(tree) == {"time_embed", "label_emb", "input_blocks", "middle_block", "zero_convs",
                         "middle_block_out", "input_hint_block"}
    with pytest.raises(ValueError, match="input_hint_block"):
        load_controlnet({"input_blocks.0.0.weight": np.zeros((4, 4, 3, 3), np.float32)},
                        torch.float32, "cpu")


# -- launch counts of config 3 at full width, traced on the meta device ----------------


def config3_calls():
    """Every flash and fused-conv call of one config-3 model call at 1024²
    (the SDXL UNet with the SDXL ControlNet beside it, cond and uncond
    batched) and of one 1024² VAE encode. → {kernel: (controlnet, unet,
    encoder) calls}, a flash call as (q shape, Lk, body), a conv call as
    (x shape, O, body)."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd, synth_sdxl_checkpoint
    from forge_tpu_torch.models import unet as unet_mod
    from forge_tpu_torch.models import vae as vae_mod
    from forge_tpu_torch.models.controlnet import ControlNetState, run_controlnets
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body

    g = guess.guess(synth_sdxl_checkpoint(fill=DeviceFill("cpu")))
    cn_sd = synth_controlnet_sd(fill=DeviceFill("cpu"))

    def meta(shape):
        return torch.empty(shape, device="meta", dtype=torch.bfloat16)

    def tree(sd):
        return nest({k: meta(v.shape) for k, v in sd.items()})

    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        body = fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)
        calls["conv"].append((tuple(x.shape), w.shape[0], body))
        return meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    cfg = unet_mod.UNetConfig.for_family("sdxl")
    cuts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        x, t = meta((2, 4, 128, 128)), torch.empty(2, device="meta")
        ctx, y = meta((2, 77, 2048)), meta((2, 2816))
        state = ControlNetState(params=tree(cn_sd), hint=torch.empty((1, 3, 1024, 1024), device="meta"),
                                cfg=cfg)
        ctrl = run_controlnets([state], x, t, 0.0, ctx, y=y)
        cuts.append({name: len(c) for name, c in calls.items()})
        unet_mod.unet_apply(tree(g.unet), x, t, ctx, y=y, cfg=cfg, control=ctrl)
        cuts.append({name: len(c) for name, c in calls.items()})
        out = vae_mod.vae_encode(tree(g.vae), meta((1, 3, 1024, 1024)))
    assert tuple(out.shape) == (1, 4, 128, 128)
    return {name: (c[:cuts[0][name]], c[cuts[0][name]:cuts[1][name]], c[cuts[1][name]:])
            for name, c in calls.items()}


def test_config3_launch_counts_and_bodies():
    """A model call: the ControlNet's 34 self-attentions (level 1: 2 × depth
    2 at 4096 tokens; level 2 and the middle: 3 × depth 10 at 1024) and 16
    ResBlock convs beside the UNet's 70 and 34; the encoder's one attention
    (one head of 512 over 16384 tokens) and 20 resnet convs, two of them the
    new (C, O) pairs 128 → 256 at 512² and 256 → 512 at 256². Every call on
    the tensor-core body. 13 model calls (strength 0.6 of 20 steps keeps 14
    σ), one encode and one decode: 1354 flash and 698 conv launches."""
    calls = config3_calls()
    cn_flash, unet_flash, enc_flash = calls["flash"]
    cn_conv, unet_conv, enc_conv = calls["conv"]
    assert (len(cn_flash), len(unet_flash), len(enc_flash)) == (34, 70, 1)
    assert (len(cn_conv), len(unet_conv), len(enc_conv)) == (16, 34, 20)
    assert all(body == "wgmma" for c in calls.values() for part in c for *_, body in part)
    shapes = {}
    for q, lk, _ in cn_flash:
        shapes[q] = shapes.get(q, 0) + 1
    assert shapes == {(2, 10, 4096, 64): 4, (2, 20, 1024, 64): 30}
    assert enc_flash == [((1, 1, 16384, 512), 16384, "wgmma")]
    pairs = {(x[1], o, x[2]) for x, o, _ in enc_conv}
    assert pairs == {(128, 128, 1024), (128, 256, 512), (256, 256, 512), (256, 512, 256),
                     (512, 512, 256), (512, 512, 128)}
    steps = 13
    assert steps * (34 + 70) + 1 + 1 == 1354
    assert steps * (16 + 34) + 20 + 28 == 698

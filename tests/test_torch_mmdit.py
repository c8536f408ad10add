"""The port's SD3 MMDiT (forge_tpu_torch/models/mmdit.py) against forge_tpu's (CPU, f32).

The same tiny MMDiT state dicts (forge_tpu's `synth_mmdit_sd`, seeded) go
through forge_tpu's `mmdit_apply` (NHWC, its XLA attention on the CPU) and
the port's (NCHW, the flash wrapper's plain version on the CPU), the
weights carried across by `params_from_jax`. Outputs agree to 1e-5 of
their largest value (f32 on both sides; only summation order differs), in
the three variants: SD3's plain joint blocks, SD3.5's q/k RMSNorm
(`qk_norm`) and SD3.5-medium's MMDiT-X x-only `attn2` (`x_attn2`). The
golden `tests/golden/mmdit_tiny.npz` (the upstream torch MMDiTX's output)
is held at PSNR ≥ 40 dB as tests/test_golden_parity.py holds forge_tpu's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.synth import synth_mmdit_sd  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest, params_from_jax  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
VARIANTS = {"sd3": {}, "qk_norm": {"qk_norm": True}, "x_attn2": {"x_attn2": True}}


def _trees(**kw):
    """(forge_tpu's tree, the port's tree carried across) of one tiny MMDiT:
    hidden 128 (two 64-wide heads), 2 blocks, context 32, pooled 16, an 8² grid."""
    sd = synth_mmdit_sd(hidden=128, depth=2, context_dim=32, pooled_dim=16, pos_max=8,
                        fill="random", seed=41, prefix="", **kw)
    for key in [k for k in sd if k.endswith(".bias")]:  # nonzero biases take part
        sd[key] = sd[key] + 0.01 * np.arange(sd[key].size, dtype=np.float32) / sd[key].size
    jtree = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})
    return jtree, nest(params_from_jax(jtree))


def _inputs(h=8, w=8, b=2, seed=5):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, 16, h, w)).astype(np.float32)
    t = np.array([900.0, 250.0][:b], np.float32)
    ctx = r.standard_normal((b, 10, 32)).astype(np.float32)
    y = r.standard_normal((b, 16)).astype(np.float32)
    return x, t, ctx, y


def _both(jtree, tree, x, t, ctx, y):
    from forge_tpu.models.mmdit import MMDiTConfig as JCfg, mmdit_apply as jmmdit
    from forge_tpu_torch.models.mmdit import MMDiTConfig, mmdit_apply

    want = jmmdit(jtree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx),
                  jnp.asarray(y), cfg=JCfg(num_heads=2, pos_embed_max_size=8))
    with torch.no_grad():
        got = mmdit_apply(tree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          torch.from_numpy(y), cfg=MMDiTConfig(num_heads=2, pos_embed_max_size=8))
    return got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)


def _assert_close(got, want, rel=1e-5):
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mmdit_matches_forge_tpu(variant):
    """A whole forward, 1e-5: two joint blocks, the last one pre-only."""
    jtree, tree = _trees(**VARIANTS[variant])
    xb = tree["joint_blocks"]["0"]["x_block"]
    assert ("ln_q" in xb["attn"]) == (variant == "qk_norm")
    assert ("attn2" in xb) == (variant == "x_attn2")
    assert "proj" not in tree["joint_blocks"]["1"]["context_block"]["attn"]  # pre-only
    got, want = _both(jtree, tree, *_inputs())
    _assert_close(got, want)
    assert float(np.abs(want).max()) > 1e-2


def test_mmdit_variants_take_part():
    """The RMSNorm weights and attn2 change the output: set the RMSNorm
    weights to 2 (the synth's are 1, where RMSNorm still normalises) and
    zero attn2's projection."""
    from forge_tpu_torch.models.mmdit import MMDiTConfig, mmdit_apply

    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs())
    cfg = MMDiTConfig(num_heads=2, pos_embed_max_size=8)
    with torch.no_grad():
        _, tree = _trees(qk_norm=True)
        base = mmdit_apply(tree, x, t, ctx, y, cfg=cfg)
        for blk in tree["joint_blocks"].values():
            blk["x_block"]["attn"]["ln_q"]["weight"] = blk["x_block"]["attn"]["ln_q"]["weight"] * 2
        assert (mmdit_apply(tree, x, t, ctx, y, cfg=cfg) - base).abs().max() > 1e-4
        _, tree = _trees(x_attn2=True)
        base = mmdit_apply(tree, x, t, ctx, y, cfg=cfg)
        for blk in tree["joint_blocks"].values():
            proj = blk["x_block"]["attn2"]["proj"]
            proj["weight"], proj["bias"] = proj["weight"] * 0, proj["bias"] * 0
        assert (mmdit_apply(tree, x, t, ctx, y, cfg=cfg) - base).abs().max() > 1e-4


def test_cropped_pos_embed_non_square():
    """The centre window of the grid at a non-square size (3 × 5 of 8²), and a
    whole forward on a 6 × 10 latent (3 × 5 patches), against forge_tpu."""
    from forge_tpu.models.mmdit import _cropped_pos_embed as jcrop
    from forge_tpu_torch.models.mmdit import cropped_pos_embed

    jtree, tree = _trees()
    want = np.asarray(jcrop(jtree["pos_embed"], 3, 5, 8))
    got = cropped_pos_embed(tree["pos_embed"], 3, 5, 8).numpy()
    assert got.shape == (1, 15, 128)
    assert np.array_equal(got, want)
    grid = tree["pos_embed"].numpy().reshape(8, 8, 128)
    assert np.array_equal(got.reshape(3, 5, 128), grid[2:5, 1:6])  # top (8-3)//2, left (8-5)//2
    got, want = _both(jtree, tree, *_inputs(h=6, w=10))
    assert got.shape == (2, 16, 6, 10)
    _assert_close(got, want)


def test_params_from_jax_carries_the_mmdit():
    """forge_tpu's tree (the patchify conv HWIO) comes back in checkpoint
    layout: the conv OIHW, the linears [out, in], every key and value the
    state dict's."""
    sd = synth_mmdit_sd(hidden=128, depth=2, context_dim=32, pooled_dim=16, pos_max=8,
                        x_attn2=True, qk_norm=True, fill="random", seed=41, prefix="")
    jtree = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})
    assert jtree["x_embedder"]["proj"]["weight"].shape == (2, 2, 16, 128)  # HWIO
    flat = params_from_jax(jtree)
    assert set(flat) == set(sd)
    for key, value in sd.items():
        assert tuple(flat[key].shape) == value.shape, key
        assert np.array_equal(flat[key].numpy(), value), key


def test_mmdit_golden():
    """The upstream torch MMDiTX's output on `synth_mmdit_sd(hidden=64, depth=1,
    context_dim=32, pooled_dim=48, pos_max=8, seed=31)`, as
    tests/test_golden_parity.py reads it (measured there: 85 dB for forge_tpu)."""
    path = os.path.join(GOLDEN, "mmdit_tiny.npz")
    if not os.path.exists(path):
        pytest.skip("golden fixture missing (tools/make_golden.py)")
    from forge_tpu_torch.models.mmdit import mmdit_apply

    g = np.load(path)
    sd = synth_mmdit_sd(hidden=64, depth=1, context_dim=32, pooled_dim=48, in_channels=16,
                        pos_max=8, fill="random", seed=31, prefix="")
    tree = nest({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        out = mmdit_apply(tree, torch.from_numpy(g["x"]), torch.from_numpy(g["t"]),
                          torch.from_numpy(g["ctx"]), torch.from_numpy(g["y"])).numpy()
    mse = float(np.mean((out - g["ref"]) ** 2))
    psnr = 10 * np.log10(float(np.abs(g["ref"]).max()) ** 2 / mse)
    assert out.shape == g["ref"].shape
    assert psnr >= 40.0, psnr


def test_every_joint_attention_goes_to_flash(monkeypatch):
    """Every joint attention (text ⊕ image tokens, whatever the length: 10 + 16
    here) and every attn2 (image tokens alone) calls the flash wrapper, and
    under `plain_versions()` none does."""
    from forge_tpu_torch import ops
    from forge_tpu_torch.models import mmdit as mmdit_mod

    calls = []
    real = mmdit_mod.flash_attention
    monkeypatch.setattr(mmdit_mod, "flash_attention",
                        lambda q, k, v, scale=None: calls.append(tuple(q.shape)) or real(q, k, v, scale))
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs())
    cfg = mmdit_mod.MMDiTConfig(num_heads=2, pos_embed_max_size=8)
    _, tree = _trees(x_attn2=True)
    with torch.no_grad():
        mmdit_mod.mmdit_apply(tree, x, t, ctx, y, cfg=cfg)
        assert calls == [(2, 2, 26, 64), (2, 2, 16, 64)] * 2
        calls.clear()
        with ops.plain_versions():
            mmdit_mod.mmdit_apply(tree, x, t, ctx, y, cfg=cfg)
    assert calls == []

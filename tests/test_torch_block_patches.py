"""The port's UNet block patches and the extensions on the UNet's hooks
against forge_tpu (CPU, f32).

The tiny SDXL UNet of tests/test_torch_sdxl.py runs one forward in each
package with the same hooks: the five block slots (`input_block_patch`,
`input_block_patch_after_skip`, `middle_block_patch`, `output_block_patch`,
`output_block_patch_after`), alone and together, beside ControlNet residuals
on every input, middle and output position, so each slot is held where the
reference puts it relative to them; `x_concat` on a stem widened by two
channels, its source resized (up, down with the antialias) and tiled to the
batch. FreeU (`fourier_filter`, its patch), the hypernetwork (both layouts,
every activation, a `.pt` written by `torch.save` and read through both
loaders), StyleAlign (strength 1.0 and 0.5) and ControlLLLite (its modules
at depth 1, 2 and 3, its hooks). Forwards and modules agree to 1e-4 of their
scale. The reference's hooks see NHWC: each is the port's NCHW body wrapped
in transposes. The tiny txt2img slices with these extensions are
tests/test_torch_block_patches_slice.py.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_controlnet import jcfg, tcfg  # noqa: E402
from test_torch_ipadapter import _carried, _jax_tree, _unet_inputs  # noqa: E402
from test_torch_sdxl import CTX, _assert_close, _tiny_sdxl_checkpoint  # noqa: E402

PREFIX = "model.diffusion_model."


def _unet_sd(stem_extra=0):
    usd = {k[len(PREFIX):]: v for k, v in _tiny_sdxl_checkpoint().items()
           if k.startswith(PREFIX)}
    if stem_extra:  # a stem that reads `stem_extra` more latent channels (x_concat)
        w = usd["input_blocks.0.0.weight"]
        extra = np.random.default_rng(31).standard_normal(
            (w.shape[0], stem_extra) + w.shape[2:]).astype(np.float32) * 0.2
        usd["input_blocks.0.0.weight"] = np.concatenate([w, extra], axis=1)
    jtree = _jax_tree(usd)
    return jtree, _carried(jtree)


@pytest.fixture(scope="module")
def unet_trees():
    return _unet_sd()


def _run(trees, jhooks, thooks, inputs=None, control=None):
    """One forward in each package → (port NCHW, reference NCHW). `control`
    holds the residuals NCHW as numpy: {"input": [...], "middle": [...], "output": [...]}."""
    from forge_tpu.models.unet import unet_apply as junet
    from forge_tpu_torch.models.unet import unet_apply

    jtree, tree = trees
    x, t, ctx, y = inputs or _unet_inputs()
    jctl = tctl = None
    if control is not None:
        jctl = {k: [jnp.asarray(r.transpose(0, 2, 3, 1)) for r in v] for k, v in control.items()}
        tctl = {k: [torch.from_numpy(r) for r in v] for k, v in control.items()}
    want = junet(jtree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx),
                 y=jnp.asarray(y), cfg=jcfg(), control=jctl, hooks=jhooks)
    with torch.no_grad():
        got = unet_apply(tree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         y=torch.from_numpy(y), cfg=tcfg(), control=tctl, hooks=thooks)
    return got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)


def _j_nchw(a):
    return jnp.transpose(a, (0, 3, 1, 2))


def _j_nhwc(a):
    return jnp.transpose(a, (0, 2, 3, 1))


# -- models/unet.py: the block slots -------------------------------------------------------


def _block_bodies(cat, log):
    """Each slot's NCHW body, the same arithmetic in either package; `cat`
    concatenates on the channel dim."""
    def swap(s):
        c = s.shape[1] // 2
        return cat([s[:, c:], s[:, :c]])

    def input_patch(h, bid):
        log.append(("input_block_patch", bid))
        return h * (1.0 + 0.1 * bid[1]) + 0.05

    def after_skip(h, bid):
        log.append(("input_block_patch_after_skip", bid))
        return h * 0.9 - 0.02 * bid[1]

    def middle(h, bid):
        log.append(("middle_block_patch", bid))
        return h * 1.2 + 0.1

    def output_patch(h, skip, bid):
        log.append(("output_block_patch", bid))
        return h * 1.1, swap(skip) + 0.03

    def output_after(h, bid):
        log.append(("output_block_patch_after", bid))
        return h - 0.05 * bid[1]

    return {"input_block_patch": input_patch, "input_block_patch_after_skip": after_skip,
            "middle_block_patch": middle, "output_block_patch": output_patch,
            "output_block_patch_after": output_after}


def _manifests(slots, jlog, tlog):
    jb = _block_bodies(lambda xs: jnp.concatenate(xs, axis=1), jlog)
    tb = _block_bodies(lambda xs: torch.cat(xs, dim=1), tlog)

    def wrap(name, fn):  # the reference's hook: NHWC in and out around the NCHW body
        if name == "output_block_patch":
            def hook(h, skip, bid):
                h, skip = fn(_j_nchw(h), _j_nchw(skip), bid)
                return _j_nhwc(h), _j_nhwc(skip)
            return hook
        return lambda h, bid: _j_nhwc(fn(_j_nchw(h), bid))

    return ({name: (wrap(name, jb[name]),) for name in slots},
            {name: (tb[name],) for name in slots})


def _control(trees, inputs):
    """ControlNet residuals of the right shapes at every position: the
    shapes are read from one recording forward."""
    shapes = {"input": [], "middle": []}

    def rec_in(h, bid):
        shapes["input"].append(tuple(h.shape))
        return h

    def rec_mid(h, bid):
        shapes["middle"].append(tuple(h.shape))
        return h

    _run(trees, {}, {"input_block_patch": (rec_in,), "middle_block_patch": (rec_mid,)}, inputs)
    rng = np.random.default_rng(23)

    def res(shape):
        return (0.5 * rng.standard_normal(shape)).astype(np.float32)

    return {"input": [res(s) for s in shapes["input"]],
            "middle": [res(s) for s in shapes["middle"]],
            "output": [res(s) for s in shapes["input"][::-1]]}


BLOCK_SLOTS = ("input_block_patch", "input_block_patch_after_skip", "middle_block_patch",
               "output_block_patch", "output_block_patch_after")
BLOCK_CASES = {name: ((name,), True) for name in BLOCK_SLOTS}
BLOCK_CASES["all five, with ControlNet residuals"] = (BLOCK_SLOTS, True)
BLOCK_CASES["all five, no ControlNet"] = (BLOCK_SLOTS, False)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_patches_match_forge_tpu(unet_trees, case):
    slots, with_control = BLOCK_CASES[case]
    inputs = _unet_inputs()
    control = _control(unet_trees, inputs) if with_control else None
    jlog, tlog = [], []
    jhooks, thooks = _manifests(slots, jlog, tlog)
    got, want = _run(unet_trees, jhooks, thooks, inputs, control)
    _assert_close(got, want)
    assert tlog == jlog and len(tlog) > 0  # the same slots at the same block ids, in order
    plain, _ = _run(unet_trees, {}, {}, inputs, control)
    assert np.abs(got - plain).max() > 1e-3  # the patches moved the output


def test_after_skip_patch_does_not_reach_the_skip(unet_trees):
    """input_block_patch_after_skip changes h after the skip is saved: the
    output step sees the skip as it was."""
    seen = {}

    def after_skip(h, bid):
        return h * 0.0 if bid == ("input", 0) else h

    def output_patch(h, skip, bid):
        seen[bid] = skip
        return h, skip

    from forge_tpu_torch.models.unet import unet_apply

    x, t, ctx, y = (torch.from_numpy(a) for a in _unet_inputs())
    tree = unet_trees[1]
    with torch.no_grad():
        unet_apply(tree, x, t, ctx, y=y, cfg=tcfg(),
                   hooks={"input_block_patch_after_skip": (after_skip,),
                          "output_block_patch": (output_patch,)})
    last = max(seen, key=lambda bid: bid[1])
    assert float(seen[last].abs().max()) > 0  # input block 0's saved skip is not zeroed


@pytest.fixture(scope="module")
def wide_trees():
    return _unet_sd(stem_extra=2)


@pytest.mark.parametrize("source", [(1, 8, 8), (1, 5, 7), (2, 12, 16), (2, 8, 8)])
def test_x_concat_matches_forge_tpu(wide_trees, source):
    """A concat source of batch 1 or 2 at 8² (as is), 5×7 (upscaled) or 12×16
    (downscaled, with the antialias of `jax.image.resize`) for an 8² latent."""
    b, h, w = source
    src = np.random.default_rng(8).standard_normal((b, 2, h, w)).astype(np.float32)
    calls = []

    def thook(x):
        calls.append(tuple(x.shape))
        return torch.from_numpy(src)

    got, want = _run(wide_trees, {"x_concat": (lambda x: jnp.asarray(src.transpose(0, 2, 3, 1)),)},
                     {"x_concat": (thook,)})
    _assert_close(got, want)
    assert calls == [(2, 4, 8, 8)]


def test_unknown_hook_keys_still_raise(unet_trees):
    from forge_tpu_torch.models.unet import BLOCK_HOOK_KEYS, HOOK_KEYS, unet_apply

    assert BLOCK_HOOK_KEYS <= HOOK_KEYS and len(HOOK_KEYS) == 16
    x, t, ctx, y = (torch.from_numpy(a) for a in _unet_inputs())
    for key in ("block_modifiers", "attn3_patch", "hook_phases"):
        with pytest.raises(NotImplementedError, match=key):
            unet_apply(unet_trees[1], x, t, ctx, y=y, hooks={key: ()})


# -- extensions/freeu.py ---------------------------------------------------------------------


@pytest.mark.parametrize("shape, threshold, scale", [((2, 3, 8, 8), 1, 0.9),
                                                     ((1, 4, 16, 12), 1, 0.2),
                                                     ((2, 2, 9, 7), 2, 1.4)])
def test_fourier_filter_matches(shape, threshold, scale):
    from forge_tpu.extensions.freeu import fourier_filter as jfilter
    from forge_tpu_torch.extensions.freeu import fourier_filter

    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jfilter(jnp.asarray(x.transpose(0, 2, 3, 1)), threshold, scale))
    got = fourier_filter(torch.from_numpy(x), threshold, scale).numpy()
    _assert_close(got, want.transpose(0, 3, 1, 2), rel=1e-5)


FREEU_SDXL = dict(b1=1.3, b2=1.4, s1=0.9, s2=0.2)  # the values FreeU's authors publish for SDXL


def test_freeu_hooks_match_forge_tpu(unet_trees):
    from forge_tpu.extensions.freeu import build_freeu_hooks as jbuild
    from forge_tpu_torch.extensions.freeu import build_freeu_hooks

    got, want = _run(unet_trees, jbuild(model_channels=32, **FREEU_SDXL),
                     build_freeu_hooks(model_channels=32, **FREEU_SDXL))
    _assert_close(got, want)
    plain, _ = _run(unet_trees, {}, {})
    assert np.abs(got - plain).max() > 1e-3


# -- extensions/hypernetworks.py --------------------------------------------------------------


ACTIVATIONS = ["linear", "relu", "leakyrelu", "elu", "swish", "tanh", "sigmoid", "mish"]


def _hn_module(layout, dim, rng, scale=0.2):
    f32 = np.float32
    if layout == "old":
        return {"linear1.weight": (rng.standard_normal((dim * 2, dim)) * scale).astype(f32),
                "linear1.bias": (rng.standard_normal(dim * 2) * 0.1).astype(f32),
                "linear2.weight": (rng.standard_normal((dim, dim * 2)) * scale).astype(f32),
                "linear2.bias": (rng.standard_normal(dim) * 0.1).astype(f32)}
    return {"linear.0.weight": (rng.standard_normal((dim * 2, dim)) * scale).astype(f32),
            "linear.0.bias": (rng.standard_normal(dim * 2) * 0.1).astype(f32),
            "linear.1.weight": (1.0 + 0.1 * rng.standard_normal(dim * 2)).astype(f32),
            "linear.1.bias": (rng.standard_normal(dim * 2) * 0.1).astype(f32),
            "linear.2.weight": (rng.standard_normal((dim, dim * 2)) * scale).astype(f32),
            "linear.2.bias": (rng.standard_normal(dim) * 0.1).astype(f32)}


def _hn_file_dict(layout, activation, dim=CTX, seed=3):
    rng = np.random.default_rng(seed)
    return {dim: [_hn_module(layout, dim, rng), _hn_module(layout, dim, rng)],
            "activation_func": activation, "layer_structure": [1, 2, 1],
            "is_layer_norm": layout == "new", "name": "tiny-hn"}


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("layout", ["old", "new"])
def test_hypernetwork_patch_matches(layout, activation):
    from forge_tpu.extensions.hypernetworks import load_hypernetwork as jload
    from forge_tpu_torch.extensions.hypernetworks import load_hypernetwork

    d = _hn_file_dict(layout, activation, dim=16)
    ctx_k, ctx_v = np.random.default_rng(5).standard_normal((2, 2, 7, 16)).astype(np.float32)
    for strength in (1.0, 0.5):
        jk, jv = jload(d).context_patch(strength)(jnp.asarray(ctx_k), jnp.asarray(ctx_v), {})
        tk, tv = load_hypernetwork(d).context_patch(strength)(torch.from_numpy(ctx_k),
                                                              torch.from_numpy(ctx_v), {})
        _assert_close(tk.numpy(), np.asarray(jk))
        _assert_close(tv.numpy(), np.asarray(jv))
        assert np.abs(tk.numpy() - ctx_k).max() > 1e-3
    other = np.zeros((1, 3, 8), np.float32)  # a width without a module passes through
    tk, _ = load_hypernetwork(d).context_patch()(torch.from_numpy(other),
                                                 torch.from_numpy(other), {})
    assert np.array_equal(tk.numpy(), other)


def test_hypernetwork_pt_file_through_both_loaders(tmp_path):
    """A `.pt` written by `torch.save` (int keys, lists of state dicts,
    metadata) through the reference's restricted unpickler and the port's
    `torch.load(weights_only=True)`."""
    from forge_tpu.core.state_dict import load_torch_object as jload_obj
    from forge_tpu.extensions.hypernetworks import load_hypernetwork as jload
    from forge_tpu_torch.core.state_dict import load_torch_object
    from forge_tpu_torch.extensions.hypernetworks import load_hypernetwork

    d = _hn_file_dict("new", "relu", dim=16)
    path = str(tmp_path / "tiny-hn.pt")
    torch.save({k: ([{n: torch.from_numpy(a) for n, a in m.items()} for m in v]
                    if isinstance(k, int) else v) for k, v in d.items()}, path)
    want, got = jload_obj(path), load_torch_object(path)
    assert set(got) == set(want) == set(d)
    assert got["activation_func"] == want["activation_func"] == "relu"
    assert got["layer_structure"] == want["layer_structure"] == [1, 2, 1]
    for m_got, m_want, m_src in zip(got[16], want[16], d[16]):
        assert set(m_got) == set(m_want) == set(m_src)
        for name in m_src:
            assert np.array_equal(m_got[name], m_want[name])
            assert np.array_equal(m_got[name], m_src[name])
    ctx = np.random.default_rng(6).standard_normal((1, 5, 16)).astype(np.float32)
    jk, _ = jload(path).context_patch()(jnp.asarray(ctx), jnp.asarray(ctx), {})
    tk, _ = load_hypernetwork(path).context_patch()(torch.from_numpy(ctx),
                                                    torch.from_numpy(ctx), {})
    _assert_close(tk.numpy(), np.asarray(jk))


def test_hypernetwork_with_gaps_in_its_indices_from_both_sides():
    """A1111's Sequential (Linear, ReLU, LayerNorm, Linear) saves linear.0,
    .2 and .3: the reference stops at the gap and its residual add fails;
    the port reads every index."""
    from forge_tpu.extensions.hypernetworks import load_hypernetwork as jload
    from forge_tpu_torch.extensions.hypernetworks import load_hypernetwork

    rng = np.random.default_rng(9)
    m = _hn_module("new", 16, rng)
    gapped = {"linear.0.weight": m["linear.0.weight"], "linear.0.bias": m["linear.0.bias"],
              "linear.2.weight": m["linear.1.weight"], "linear.2.bias": m["linear.1.bias"],
              "linear.3.weight": m["linear.2.weight"], "linear.3.bias": m["linear.2.bias"]}
    ctx = rng.standard_normal((1, 5, 16)).astype(np.float32)
    with pytest.raises(TypeError):
        jload({16: [gapped, gapped], "activation_func": "relu"}).context_patch()(
            jnp.asarray(ctx), jnp.asarray(ctx), {})
    got, _ = load_hypernetwork({16: [gapped, gapped], "activation_func": "relu"}).context_patch()(
        torch.from_numpy(ctx), torch.from_numpy(ctx), {})
    contiguous, _ = load_hypernetwork({16: [m, m], "activation_func": "relu"}).context_patch()(
        torch.from_numpy(ctx), torch.from_numpy(ctx), {})
    assert np.array_equal(got.numpy(), contiguous.numpy())


# -- extensions/stylealign.py ------------------------------------------------------------------


@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_stylealign_hooks_match(unet_trees, strength):
    """The CFG batch of a batch of 2 (four rows: 2 cond, 2 uncond)."""
    from forge_tpu.extensions.stylealign import build_stylealign_hooks as jbuild
    from forge_tpu_torch.extensions.stylealign import build_stylealign_hooks

    x, t, ctx, y = _unet_inputs()
    rng = np.random.default_rng(4)
    inputs = (np.concatenate([x, x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)]),
              np.concatenate([t, t]), np.concatenate([ctx, ctx[::-1]]), np.concatenate([y, y]))
    got, want = _run(unet_trees, jbuild(2, strength), build_stylealign_hooks(2, strength), inputs)
    _assert_close(got, want)
    plain, _ = _run(unet_trees, {}, {}, inputs)
    assert np.abs(got - plain).max() > 1e-4  # the tiny UNet's 4² self-attentions weigh little


# -- extensions/controllllite.py ---------------------------------------------------------------


def _lllite_module(rng, depth, in_dim, ce=16, mlp=8):
    """One module in the file's torch layout (conv OIHW, linear [out, in])."""
    f32 = np.float32

    def w(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(f32)

    mod = {"conditioning1.0.weight": w(ce // 2, 3, 4, 4), "conditioning1.0.bias": w(ce // 2)}
    if depth == 1:
        mod.update({"conditioning1.2.weight": w(ce, ce // 2, 2, 2), "conditioning1.2.bias": w(ce)})
    elif depth == 2:
        mod.update({"conditioning1.2.weight": w(ce, ce // 2, 4, 4), "conditioning1.2.bias": w(ce)})
    else:
        mod.update({"conditioning1.2.weight": w(ce // 2, ce // 2, 4, 4),
                    "conditioning1.2.bias": w(ce // 2),
                    "conditioning1.4.weight": w(ce, ce // 2, 2, 2), "conditioning1.4.bias": w(ce)})
    mod.update({"down.0.weight": w(mlp, in_dim), "down.0.bias": w(mlp),
                "mid.0.weight": w(mlp, mlp + ce), "mid.0.bias": w(mlp),
                "up.0.weight": w(in_dim, mlp), "up.0.bias": w(in_dim)})
    return mod


def _lllite_sd(depth=2, in_dim=64, blocks=("input_blocks_3_1", "middle_block_1",
                                            "output_blocks_0_1", "output_blocks_1_1")):
    """Modules on every transformer block of the tiny SDXL UNet (its 4² token
    grid: depth 2 from a 64² hint), attn1 to_q/to_k/to_v and attn2 to_q."""
    rng = np.random.default_rng(12)
    sd = {}
    for blk in blocks:
        for proj in ("attn1_to_q", "attn1_to_k", "attn1_to_v", "attn2_to_q"):
            name = f"lllite_unet_{blk}_transformer_blocks_0_{proj}"
            for key, value in _lllite_module(rng, depth, in_dim).items():
                sd[f"{name}.{key}"] = value
    return sd


def _hint(side=64, seed=2):
    yy, xx = np.mgrid[0:side, 0:side]
    img = np.stack([(yy * 4) % 256, (xx * 4) % 256, ((yy + xx) * 2) % 256], -1)
    noise = np.random.default_rng(seed).integers(0, 40, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("depth, side", [(1, 32), (2, 64), (3, 128)])
def test_lllite_module_matches(depth, side):
    """split, meta, the cond embedding (a 4² grid from a hint of 32, 64, 128)
    and the offset of one module."""
    from forge_tpu.core.state_dict import transform_for_jax
    from forge_tpu.extensions import controllllite as jl
    from forge_tpu_torch.extensions import controllllite as tl

    sd = {f"lllite_unet_x.{k}": v for k, v in _lllite_module(np.random.default_rng(depth), depth,
                                                              32).items()}
    jmods = jl.split_lllite_modules({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})
    tmods = tl.split_lllite_modules({k: torch.from_numpy(v) for k, v in sd.items()})
    jw, tw = jmods["lllite_unet_x"], tmods["lllite_unet_x"]
    assert tl._module_meta(tw) == {k: v for k, v in jl._module_meta(jw).items()}
    assert tl._module_meta(tw)["depth"] == depth
    img = (_hint(side).astype(np.float32) / 255.0) * 2 - 1
    jemb = jl._cond_embed(jw, jnp.asarray(img[None]), depth)
    temb = tl._cond_embed(tw, torch.from_numpy(img.transpose(2, 0, 1)[None].copy()), depth)
    assert tuple(temb.shape) == (1, 16, 4, 4)
    _assert_close(temb.numpy(), np.asarray(jemb).transpose(0, 3, 1, 2))
    xt = np.random.default_rng(7).standard_normal((2, 16, 32)).astype(np.float32)
    meta = tl._module_meta(tw)
    want = jl._apply_module(jw, jl._module_meta(jw), jemb, jnp.asarray(xt), 0.8)
    got = tl._apply_module(tw, meta, temb, torch.from_numpy(xt), 0.8)
    _assert_close(got.numpy(), np.asarray(want))


def test_lllite_hooks_match(unet_trees):
    from forge_tpu.core.state_dict import transform_for_jax
    from forge_tpu.extensions.controllllite import build_lllite_hooks as jbuild
    from forge_tpu_torch.extensions.controllllite import build_lllite_hooks

    sd = _lllite_sd()
    jhooks = jbuild({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()}, _hint(), 1.5)
    thooks = build_lllite_hooks(sd, _hint(), 1.5)
    got, want = _run(unet_trees, jhooks, thooks)
    _assert_close(got, want)
    plain, _ = _run(unet_trees, {}, {})
    assert np.abs(got - plain).max() > 1e-3

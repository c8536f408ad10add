"""The port's UNet hooks, CLIP vision and IP-Adapter against forge_tpu (CPU, f32).

The tiny SDXL checkpoint of tests/test_torch_sdxl.py, a tiny CLIP vision
tower (`synth_clip_vision_sd` at width 64, two layers, 32-pixel patches) and
a tiny IP-Adapter over the tiny UNet's four cross-attentions
(`synth_ip_adapter_sd`) go through both packages with the JAX package's
weights carried across by `params_from_jax`. Module outputs agree to 1e-4
of their scale (f32 on both sides; only summation order differs); the
tiny txt2img slice with the IP hooks (64², DPM++ 2M Karras, 3 steps, CFG 7,
batch 2) to PSNR ≥ 80 dB; Pillow's BICUBIC in numpy bit for bit. Two
reference-side faults are shown from both sides: CLIP-ViT-H's heads and
activation, and the IP layer counter across forwards.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest, params_from_jax  # noqa: E402
from test_torch_sdxl import (ADM, CTX, REQUEST, _assert_close, _jax_engine,  # noqa: E402
                             _port_engine, _psnr, _tiny_sdxl_checkpoint)

CV_WIDTH, CV_PROJ = 64, 32
TINY_ATTN2 = (64,) * 4  # the tiny UNet's cross-attention widths in forward order
IP_WEIGHT = 0.8


def _jax_tree(sd):
    return jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})


def _carried(jtree):
    return nest(params_from_jax(jtree))


def tiny_clip_vision_sd(width=CV_WIDTH, layers=2, mlp=256, patch=32, projection=CV_PROJ,
                        seed=21):
    from forge_tpu_torch.core.synth import synth_clip_vision_sd

    sd = synth_clip_vision_sd(width=width, layers=layers, mlp=mlp, patch=patch,
                              projection=projection, fill="random", seed=seed)
    sd["vision_model.embeddings.class_embedding"] *= 25.0  # a class token of unit scale
    return sd


def tiny_ip_adapter_sd(seed=22):
    from forge_tpu_torch.core.synth import synth_ip_adapter_sd

    sd = synth_ip_adapter_sd(clip_dim=CV_PROJ, context_dim=CTX, widths=TINY_ATTN2,
                             fill="random", seed=seed)
    for key in sd:
        if key.startswith("ip_adapter."):
            sd[key] = sd[key] * 10.0  # k_ip, v_ip of a scale that moves the image
    return sd


def reference_image(h=96, w=80, seed=3):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def unet_trees():
    prefix = "model.diffusion_model."
    usd = {k[len(prefix):]: v for k, v in _tiny_sdxl_checkpoint().items() if k.startswith(prefix)}
    jtree = _jax_tree(usd)
    return jtree, _carried(jtree)


@pytest.fixture(scope="module")
def ip_trees():
    jcv, jip = _jax_tree(tiny_clip_vision_sd()), _jax_tree(tiny_ip_adapter_sd())
    return (jcv, jip), (_carried(jcv), _carried(jip))


def _unet_inputs(seed=5):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([999.0, 321.0], np.float32)
    ctx = r.standard_normal((2, 77, CTX)).astype(np.float32)
    y = r.standard_normal((2, ADM)).astype(np.float32)
    return x, t, ctx, y


def _run_unets(unet_trees, jhooks, thooks, inputs=None):
    """One forward of the tiny UNet in each package → (port NCHW, reference NCHW)."""
    from forge_tpu.models.unet import unet_apply as junet
    from forge_tpu_torch.models.unet import unet_apply
    from test_torch_controlnet import jcfg, tcfg

    jtree, tree = unet_trees
    x, t, ctx, y = inputs or _unet_inputs()
    want = junet(jtree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx),
                 y=jnp.asarray(y), cfg=jcfg(), hooks=jhooks)
    with torch.no_grad():
        got = unet_apply(tree, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         y=torch.from_numpy(y), cfg=tcfg(), hooks=thooks)
    return got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)


# -- models/unet.py: the attention hook manifest ------------------------------------------


def _hook_manifest(which, kind, is_torch, log):
    """One hook of each kind, the same arithmetic in either package."""
    def mean1(v):
        return v.mean(dim=1, keepdim=True) if is_torch else v.mean(axis=1, keepdims=True)

    def record(extra):
        log.append((extra["block"], extra.get("n_heads"), extra.get("block_index")))

    def context_patch(ck, cv, extra):
        record(extra)
        return ck * 1.5, cv * 0.5 + 0.1

    def patch(q, k, v, extra):
        record(extra)
        return q * 1.3, k, v - 0.05

    def replace(q, k, v, extra):
        record(extra)
        return q * 0.5 + mean1(v)

    def output_patch(out, extra):
        record(extra)
        return out * 0.7 + 0.01

    key = f"{which}_{kind}"
    return {"context_patch": {key: [context_patch]}, "patch": {key: [patch]},
            "replace": {key: {("middle", 0): replace}}, "replace_all": {key: replace},
            "output_patch": {key: [output_patch]}}[kind]


@pytest.mark.parametrize("which", ["attn1", "attn2"])
@pytest.mark.parametrize("kind", ["context_patch", "patch", "replace", "replace_all",
                                  "output_patch"])
def test_attention_hooks_match(unet_trees, which, kind):
    """Each key of the manifest on the tiny UNet: the same output as
    forge_tpu, the same calls with the same `block`, `n_heads` and
    `block_index`, and an output the hook moved."""
    jlog, tlog = [], []
    got, want = _run_unets(unet_trees, _hook_manifest(which, kind, False, jlog),
                           _hook_manifest(which, kind, True, tlog))
    plain, _ = _run_unets(unet_trees, None, None)
    _assert_close(got, want)
    assert np.abs(got - plain).max() > 1e-3
    assert tlog == jlog and len(tlog) == (1 if kind == "replace" else 4)
    assert {b for b, *_ in tlog} <= {("input", 3), ("middle", 0), ("output", 0), ("output", 1)}


def test_attn_index_counts_transformer_blocks_in_one_forward(unet_trees):
    """`attn_index` numbers the transformer blocks 0 … n−1 in forward order,
    the same on every forward."""
    seen = []

    def spy(q, k, v, extra):
        seen.append((extra["block"], extra["attn_index"]))
        return q, k, v

    for _ in range(2):
        _run_unets(unet_trees, None, {"attn2_patch": [spy]})
    want = [(("input", 3), 0), (("middle", 0), 1), (("output", 0), 2), (("output", 1), 3)]
    assert seen == want * 2


def test_unported_hook_keys_raise(unet_trees):
    from forge_tpu_torch.models.unet import unet_apply

    tree = unet_trees[1]
    x, t, ctx, y = (torch.from_numpy(a) for a in _unet_inputs())
    for key in ("block_modifiers", "input_block_patcher", "attn3_patch"):
        with pytest.raises(NotImplementedError, match=key):
            unet_apply(tree, x, t, ctx, y=y, hooks={key: []})


# -- pipeline/images.py, models/clipvision.py ---------------------------------------------


@pytest.mark.parametrize("shape", [(1024, 1024), (300, 500), (64, 48), (224, 224)])
def test_preprocess_is_pillow_bicubic(shape):
    """Pillow's BICUBIC (forge_tpu's preprocess calls Pillow) bit for bit,
    then the same CLIP normalisation."""
    from forge_tpu.models.clipvision import preprocess as jpreprocess
    from forge_tpu_torch.models.clipvision import preprocess

    img = np.random.default_rng(shape[0]).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    got = preprocess(img).numpy()
    assert got.shape == (1, 3, 224, 224) and got.dtype == np.float32
    assert np.array_equal(got, jpreprocess(img).transpose(0, 3, 1, 2))
    as_float = preprocess(img.astype(np.float32) + 0.25).numpy()  # floats are cut to uint8
    assert np.array_equal(as_float, got)


@pytest.mark.parametrize("geometry", [
    dict(),                                              # tiny: width 64, one head
    dict(width=1024, layers=1, mlp=4096, patch=14, projection=768),  # ViT-L/14: 16 heads of 64
])
def test_clip_vision_matches(geometry):
    """Projected embed, pooled class token and penultimate hidden states,
    where forge_tpu's heads (width // 64) and quick_gelu are the model's own."""
    from forge_tpu.models.clipvision import clip_vision_apply as japply
    from forge_tpu.models.clipvision import preprocess as jpreprocess
    from forge_tpu_torch.models.clipvision import clip_vision_apply, preprocess

    jtree = _jax_tree(tiny_clip_vision_sd(**geometry))
    img = reference_image()
    want = japply(jtree, jnp.asarray(jpreprocess(img)))
    with torch.no_grad():
        got = clip_vision_apply(_carried(jtree), preprocess(img))
    patch = geometry.get("patch", 32)
    assert got[2].shape == (1, (224 // patch) ** 2 + 1, geometry.get("width", CV_WIDTH))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)
    assert np.abs(got[0].numpy() - got[1].numpy()[:, :got[0].shape[1]]).max() > 1e-3


def test_clip_vit_h_heads_and_activation_differ_from_forge_tpu():
    """At ViT-H/14 geometry (width 1280, 257 tokens, two layers) the port
    takes 16 heads of 80 and gelu, the laion model's own; forge_tpu takes
    1280 // 64 = 20 heads and quick_gelu. Given forge_tpu's choice the port
    computes forge_tpu's result, so the config is the only difference."""
    from forge_tpu.models.clipvision import clip_vision_apply as japply
    from forge_tpu.models.clipvision import preprocess as jpreprocess
    from forge_tpu_torch.models.clipvision import (ClipVisionConfig, clip_vision_apply,
                                                   preprocess)

    assert ClipVisionConfig.for_width(1280) == ClipVisionConfig(16, "gelu")
    assert ClipVisionConfig.for_width(1664) == ClipVisionConfig(16, "gelu")
    assert ClipVisionConfig.for_width(1024) == ClipVisionConfig(16, "quick_gelu")
    jtree = _jax_tree(tiny_clip_vision_sd(width=1280, layers=2, mlp=5120, patch=14,
                                          projection=1024))
    img = reference_image()
    want = japply(jtree, jnp.asarray(jpreprocess(img)))
    tree, pixels = _carried(jtree), preprocess(img)
    with torch.no_grad():
        port = clip_vision_apply(tree, pixels)
        as_reference = clip_vision_apply(tree, pixels, cfg=ClipVisionConfig(20, "quick_gelu"))
    for g, w in zip(as_reference, want):
        _assert_close(g.numpy(), w)
    w = np.asarray(want[0])
    assert np.abs(port[0].numpy() - w).max() > 1e-2 * np.abs(w).max()


def test_loaders_match_params_from_jax(ip_trees):
    """`load_clip_vision` and `load_ip_adapter` from the state dicts give the
    trees `params_from_jax` carries across (the patch embedding back to OIHW)."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.loader import load_clip_vision, load_ip_adapter

    (jcv, jip), (cv, ip) = ip_trees
    for loader, sd, carried in ((load_clip_vision, tiny_clip_vision_sd(), cv),
                                (load_ip_adapter, tiny_ip_adapter_sd(), ip)):
        tree = loader(sd, torch.float32, "cpu")
        flat, want = flatten(tree), flatten(carried)
        assert flat.keys() == want.keys()
        for key, value in want.items():
            assert flat[key].dtype == torch.float32 and torch.equal(flat[key], value), key
    assert cv["vision_model"]["embeddings"]["patch_embedding"]["weight"].shape == (CV_WIDTH, 3, 32, 32)
    assert set(ip["ip_adapter"]) == {"1", "3", "5", "7"}
    with pytest.raises(ValueError, match="ip_adapter"):
        load_ip_adapter({"image_proj.proj.weight": np.zeros((4, 4), np.float32)},
                        torch.float32, "cpu")
    with pytest.raises(ValueError, match="vision_model"):
        load_clip_vision({"visual_projection.weight": np.zeros((4, 4), np.float32)},
                         torch.float32, "cpu")


def test_full_width_ip_adapter_and_vit_h_sizes():
    """The full-width synths by shape (nothing is made): CLIP-ViT-H/14
    (≈ 632 M parameters) and the SDXL ViT-H IP-Adapter (≈ 349 M)."""
    from forge_tpu_torch.core.synth import (DeviceFill, SDXL_ATTN2_WIDTHS, synth_clip_vision_sd,
                                            synth_ip_adapter_sd)

    cv = synth_clip_vision_sd(fill=DeviceFill("cpu"))
    ip = synth_ip_adapter_sd(fill=DeviceFill("cpu"))
    assert 6.3e8 < sum(v.size for v in cv.values()) < 6.35e8
    assert 3.48e8 < sum(v.size for v in ip.values()) < 3.50e8
    assert cv["vision_model.embeddings.position_embedding.weight"].shape == (257, 1280)
    assert ip["image_proj.proj.weight"].shape == (4 * 2048, 1024)
    assert len(SDXL_ATTN2_WIDTHS) == 70
    assert ip["ip_adapter.1.to_k_ip.weight"].shape == (640, 2048)
    assert ip["ip_adapter.9.to_v_ip.weight"].shape == (1280, 2048)
    assert ip["ip_adapter.139.to_v_ip.weight"].shape == (640, 2048)


# -- pipeline/ipadapter.py ---------------------------------------------------------------


def _resampler_sd(clip_width=CV_WIDTH, dim=128, n=4, depth=2, seed=23):
    r = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    sd = {"image_proj.latents": w(1, n, dim, scale=1.0),
          "image_proj.proj_in.weight": w(dim, clip_width), "image_proj.proj_in.bias": w(dim),
          "image_proj.proj_out.weight": w(CTX, dim), "image_proj.proj_out.bias": w(CTX),
          "image_proj.norm_out.weight": 1 + w(CTX), "image_proj.norm_out.bias": w(CTX)}
    for i in range(depth):
        b = f"image_proj.layers.{i}."
        for name in ("0.norm1", "0.norm2", "1.0"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = 1 + w(dim), w(dim)
        sd[b + "0.to_q.weight"], sd[b + "0.to_kv.weight"] = w(dim, dim), w(2 * dim, dim)
        sd[b + "0.to_out.weight"] = w(dim, dim)
        sd[b + "1.1.weight"], sd[b + "1.3.weight"] = w(4 * dim, dim), w(dim, 4 * dim)
    return sd


@pytest.mark.parametrize("kind", ["simple", "resampler"])
def test_project_image_embeds_matches(ip_trees, kind):
    from forge_tpu.pipeline.ipadapter import project_image_embeds as jproject
    from forge_tpu_torch.pipeline.ipadapter import project_image_embeds

    r = np.random.default_rng(4)
    if kind == "simple":
        (_, jtree), (_, tree) = ip_trees
        embed = r.standard_normal((2, CV_PROJ)).astype(np.float32)
    else:
        jtree = _jax_tree(_resampler_sd())
        tree = _carried(jtree)
        embed = r.standard_normal((2, 50, CV_WIDTH)).astype(np.float32)
    want = jproject(jtree, jnp.asarray(embed))
    with torch.no_grad():
        got = project_image_embeds(tree, torch.from_numpy(embed))
    assert got.shape == (2, 4, CTX)
    _assert_close(got.numpy(), want)


def _ip_hooks(ip_trees, weight=IP_WEIGHT, batch_size=2):
    """Each package's manifest from the same reference image."""
    from forge_tpu.pipeline.ipadapter import build_ip_adapter_hooks as jbuild
    from forge_tpu_torch.pipeline.ipadapter import build_ip_adapter_hooks

    (jcv, jip), (cv, ip) = ip_trees
    img = reference_image()
    return (jbuild(jip, jcv, img, weight=weight, batch_size=batch_size),
            build_ip_adapter_hooks(ip, cv, img, weight=weight, batch_size=batch_size))


def test_encode_image_matches(ip_trees):
    """CLIP vision → image_proj: the IP tokens and the zeroed image's."""
    from forge_tpu.models.clipvision import clip_vision_apply as japply
    from forge_tpu.models.clipvision import preprocess as jpreprocess
    from forge_tpu.pipeline.ipadapter import project_image_embeds as jproject
    from forge_tpu_torch.pipeline.ipadapter import encode_image

    (jcv, jip), (cv, ip) = ip_trees
    img = reference_image()
    projected, _, _ = japply(jcv, jnp.asarray(jpreprocess(img)))
    tokens, uncond = encode_image(ip, cv, img)
    _assert_close(tokens.numpy(), jproject(jip, projected))
    _assert_close(uncond.numpy(), jproject(jip, jnp.zeros_like(projected)))


def test_ip_hooks_give_the_same_output_on_every_forward(unet_trees, ip_trees):
    """The counter trap. The port's manifest gives the same output on two
    consecutive forwards, equal to forge_tpu's first. forge_tpu's closure
    counter runs on past the four layers, so its second eager forward
    silently drops the adapter (under jit one trace holds one forward, and
    the count is right only there)."""
    jhooks, thooks = _ip_hooks(ip_trees, batch_size=1)  # the UNet batch [cond, uncond]
    first, want = _run_unets(unet_trees, jhooks, thooks)
    second, want_second = _run_unets(unet_trees, jhooks, thooks)
    plain, want_plain = _run_unets(unet_trees, None, None)
    _assert_close(first, want)
    assert np.array_equal(first, second)
    assert np.abs(first - plain).max() > 1e-3
    assert np.abs(want - want_plain).max() > 1e-3
    _assert_close(want_second, want_plain, rel=1e-6)  # the reference's second forward: no IP


@pytest.fixture(scope="module")
def engines():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


def test_txt2img_with_ip_adapter_matches_forge_tpu(engines, ip_trees):
    """The tiny SDXL txt2img slice at batch 2 with the IP hooks (cond and
    uncond tokens in the CFG batch) through both packages."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    jeng, teng = engines
    jhooks, thooks = _ip_hooks(ip_trees)
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST, batch_size=2,
                                                       unet_hooks=jhooks)).images
    got = tproc.process_images(teng, tproc.Processing(**REQUEST, batch_size=2,
                                                      unet_hooks=thooks)).images
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, 64, 3) and g.dtype == np.uint8
        value = _psnr(g, w)
        print(f"txt2img + IP-Adapter: PSNR {value:.2f} dB")
        assert value >= 80.0, value
    plain = tproc.process_images(teng, tproc.Processing(**REQUEST, batch_size=2)).images
    assert all(_psnr(g, p) < 60 for g, p in zip(got, plain))  # the adapter moved the image


def test_ip_weight_zero_is_the_request_without_hooks(engines, ip_trees):
    from forge_tpu_torch.pipeline import processing as tproc

    teng = engines[1]
    _, zero = _ip_hooks(ip_trees, weight=0.0)
    got = tproc.process_images(teng, tproc.Processing(**REQUEST, batch_size=2, unet_hooks=zero))
    plain = tproc.process_images(teng, tproc.Processing(**REQUEST, batch_size=2))
    assert all(np.array_equal(g, p) for g, p in zip(got.images, plain.images))

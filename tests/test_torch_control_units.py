"""The ControlNet extension's unit path (extensions/controlnet.py) and the
inpaint preprocessors' hint and composites (pipeline/cn_inpaint.py) against
forge_tpu (CPU, f32): `load_control_model` telling a cldm, a T2I-Adapter
and a Control-LoRA apart (the `control_model.` prefix stripped),
`_cn_config`, `_decode_image` and `_decode_unit_mask` (base64 PNG through
the port's codec), `attach_units` for each module taken ("none", "canny",
"inpaint_global_harmonious", "inpaint_only": hints, states and deferred hooks),
the modules refused from both sides, Control-LoRA's assembly onto the live
UNet (base + up·down in f32; the engine's tree untouched; cached on the
engine), `mix_hint`, `latent_mask_from_pixels`, inpaint_only's state and
`composite_final` (OpenCV's dilate and blur, held against cv2). The
requests are in tests/test_torch_control_units_slice.py."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_controlnet import tiny_controlnet_sd  # noqa: E402
from test_torch_sdxl import _assert_close  # noqa: E402
from test_torch_t2i_adapter import TINY_XL, t2i_sd  # noqa: E402
from torch_controls_cases import init_and_mask, processing, sdxl_engines  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


def control_lora_sd(unet_tree, rank=4, seed=21):
    """A Control-LoRA in stabilityai/control-lora's layout for a tiny UNet
    (the SDXL's or the SD1.5's: the same channels a block): the marker, the
    cldm's hint block, zero convs and middle_block_out, a
    norm of its own, and `.up`/`.down` pairs on trunk convs and linears."""
    from forge_tpu_torch.core.convert import flatten

    rng = np.random.default_rng(seed)
    cldm = tiny_controlnet_sd(seed=seed)
    sd = {k: v for k, v in cldm.items()
          if k.startswith(("zero_convs", "middle_block_out", "input_hint_block"))}
    sd["lora_controlnet"] = np.zeros((), np.float32)
    flat = flatten(unet_tree)
    sd["input_blocks.1.0.in_layers.0.weight"] = (
        1.0 + 0.1 * rng.standard_normal(flat["input_blocks.1.0.in_layers.0.weight"].shape)
    ).astype(np.float32)
    picks = ("input_blocks.1.0.in_layers.2.weight", "input_blocks.3.0.out_layers.3.weight",
             "attn1.to_q.weight", "proj_in.weight", "middle_block.0.emb_layers.1.weight",
             "time_embed.0.weight")
    for key in [next(k for k in flat if k.endswith(pick)) for pick in picks]:
        shape = tuple(flat[key].shape)
        base = key[:-len(".weight")]
        up_shape = (shape[0], rank) + ((1, 1) if len(shape) == 4 else ())
        sd[base + ".up"] = (0.2 * rng.standard_normal(up_shape)).astype(np.float32)
        sd[base + ".down"] = (0.2 * rng.standard_normal((rank,) + shape[1:])).astype(np.float32)
    return sd


def _save(sd, path):
    from forge_tpu_torch.core.save import save_safetensors

    save_safetensors(sd, str(path))
    return str(path)


def test_load_control_model_tells_the_kinds_apart(engines, tmp_path):
    from forge_tpu.extensions.controlnet import load_control_model as jload
    from forge_tpu_torch.extensions.controlnet import _MODEL_CACHE, load_control_model
    from forge_tpu_torch.models.t2i_adapter import AdapterConfig

    cldm = tiny_controlnet_sd()
    models = {
        "controlnet": {"control_model." + k: v for k, v in cldm.items()},
        "t2i_adapter": t2i_sd(**TINY_XL),
        "control_lora": control_lora_sd(engines[1].loaded.unet),
    }
    try:
        for kind, sd in models.items():
            path = _save(sd, tmp_path / f"{kind}.safetensors")
            got = load_control_model(path, device="cpu")
            assert got[0] == jload(path)[0] == kind
            assert load_control_model(path, device="cpu") is got  # cached by path
            assert load_control_model(sd, device="cpu")[0] == kind  # a state dict directly
            if kind == "controlnet":
                assert set(got[1]) == {"time_embed", "label_emb", "input_blocks", "middle_block",
                                       "zero_convs", "input_hint_block", "middle_block_out"}
                assert got[2].context_dim == 128 and got[2].head_dim == 64
            if kind == "t2i_adapter":
                assert isinstance(got[2], AdapterConfig) and got[2].xl
        with pytest.raises(ValueError, match="unrecognized"):
            load_control_model({"x.weight": np.zeros((2, 2), np.float32)}, device="cpu")
    finally:
        _MODEL_CACHE.clear()


@pytest.mark.parametrize("ctx, channels", [(768, 320), (None, 64), (2048, 320), (1024, 320)])
def test_cn_config_matches(ctx, channels):
    from forge_tpu.extensions.controlnet import _cn_config as jconfig
    from forge_tpu_torch.extensions.controlnet import _cn_config

    sd = {"input_blocks.0.0.weight": np.zeros((channels, 4, 3, 3), np.float32)}
    if ctx:
        sd["input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight"] = np.zeros((640, ctx))
    got, want = _cn_config(sd), jconfig(sd)
    assert (got.context_dim, got.num_heads, got.head_dim) == (want.context_dim, want.num_heads,
                                                              want.head_dim)


def test_decode_image_and_mask_match():
    from forge_tpu.extensions.controlnet import _decode_image as jdecode
    from forge_tpu.extensions.controlnet import _decode_unit_mask as jmask
    from forge_tpu_torch.extensions.controlnet import _decode_image, _decode_unit_mask
    from forge_tpu_torch.pipeline.images import encode_png

    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, size=(20, 24), dtype=np.uint8)
    png = base64.b64encode(encode_png(rgb)).decode()
    rgba = base64.b64encode(encode_png(np.concatenate(
        [rgb, np.full((20, 24, 1), 99, np.uint8)], axis=2))).decode()
    for image in (png, "data:image/png;base64," + png, rgba, {"image": png}, rgb, gray,
                  rgb.astype(np.float32) / 255.0, rgb.astype(np.float32)):
        got, want = _decode_image(image), jdecode(image)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    mask_png = base64.b64encode(encode_png(gray)).decode()
    for unit, image in (({"mask": mask_png}, png), ({"mask_image": gray}, png),
                        ({}, {"image": png, "mask": mask_png}), ({}, png)):
        got, want = _decode_unit_mask(unit, image), jmask(unit, image)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == np.float32 and np.array_equal(got, want)


def _unit_image(size=48, seed=6):
    img = np.random.default_rng(seed).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    img[10:30, 12:20] = 255
    mask = np.zeros((size, size), np.uint8)
    mask[16:40, 8:28] = 255
    return img, mask


MODULES = {
    "none": dict(processor_res=32),
    "canny": dict(threshold_a=60, threshold_b=150),
    "inpaint_global_harmonious": {},
    "inpaint_only": {},
}


@pytest.mark.parametrize("module", list(MODULES))
def test_attach_units_matches_forge_tpu(module, tmp_path):
    """Each module's hint at the request's size, its state's gating and
    weights, and the deferred hooks it leaves, against the reference's."""
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu_torch.extensions import controlnet as tcn
    from forge_tpu_torch.models.controlnet import ControlNetState

    _save(tiny_controlnet_sd(), tmp_path / "cldm_tiny.safetensors")
    img, mask = _unit_image()
    unit = dict(MODULES[module], module=module, model="cldm_tiny", image=img, mask=mask,
                weight=0.7, guidance_start=0.1, guidance_end=0.8,
                advanced_weighting=[1.0, 0.5])
    ps = []
    try:
        for ext, proc, kw in ((jcn, processing("forge_tpu"), {}),
                              (tcn, processing("forge_tpu_torch"), {"device": "cpu"})):
            ext.set_model_dirs([str(tmp_path)])
            ext._MODEL_CACHE.clear()
            p = proc.Processing(prompt="x", width=64, height=56)
            assert ext.attach_units(p, [unit, dict(unit, enabled=False), dict(unit, image=None)],
                                    **kw) == 1
            ps.append(p)
    finally:
        for ext in (jcn, tcn):
            ext.set_model_dirs(["models/ControlNet", "models/controlnet"])
            ext._MODEL_CACHE.clear()
    jp, tp = ps
    (jst,), (tst,) = jp.controlnets, tp.controlnets
    assert isinstance(tst, ControlNetState)
    assert tuple(tst.hint.shape) == (1, 3, 56, 64)
    _assert_close(tst.hint.numpy(), np.asarray(jst.hint).transpose(0, 3, 1, 2), rel=1e-6)
    assert (tst.strength, tst.start_percent, tst.end_percent, tst.block_weights) == (
        jst.strength, jst.start_percent, jst.end_percent, jst.block_weights)
    assert len(tp.deferred_hooks or ()) == len(jp.deferred_hooks or ()) == (
        module == "inpaint_only")


REFUSED = {  # module: the ROADMAP item the port names, and what the reference does
    "ip-adapter_clip_sdxl": ("6 \\(d\\)", "raises KeyError (no such preprocessor)"),
    "inpaint_only+lama": ("item 9", "runs LaMa"),
    "invert": ("item 9", "builds a ControlNetState"),
    "blur_gaussian": ("item 9", "builds a ControlNetState"),
}


@pytest.mark.parametrize("module", list(REFUSED))
def test_refused_modules_from_both_sides(module, tmp_path):
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu.models.controlnet import ControlNetState as JState
    from forge_tpu_torch.extensions.controlnet import build_unit_state

    item, reference = REFUSED[module]
    img, mask = _unit_image()
    unit = {"module": module, "model": "cldm_tiny", "image": img, "mask": mask}
    with pytest.raises(NotImplementedError, match=item):
        build_unit_state(unit, 64, 64, device="cpu")
    _save(tiny_controlnet_sd(), tmp_path / "cldm_tiny.safetensors")
    jcn.set_model_dirs([str(tmp_path)])
    jcn._MODEL_CACHE.clear()
    try:
        if reference.startswith("raises"):
            err = FileNotFoundError if "FileNotFound" in reference else KeyError
            with pytest.raises(err):
                jcn.build_unit_state(unit, 64, 64)
        elif module == "inpaint_only+lama":
            from forge_tpu.preprocessors import lama

            called = []
            orig = lama.lama_prefill
            lama.lama_prefill = lambda image, m: called.append(1) or image
            try:
                out = jcn.build_unit_state(unit, 64, 64)
            finally:
                lama.lama_prefill = orig
            assert called and isinstance(out[0], JState) and callable(out[1])
        else:
            out = jcn.build_unit_state(unit, 64, 64)
            assert callable(out) if "deferred hook" in reference else isinstance(out, JState)
    finally:
        jcn.set_model_dirs(["models/ControlNet", "models/controlnet"])
        jcn._MODEL_CACHE.clear()


def test_control_lora_assembly_matches_forge_tpu(engines):
    from forge_tpu.core.tree import flatten as jflatten
    from forge_tpu.extensions.controlnet import assemble_control_lora as jassemble
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.extensions.controlnet import assemble_control_lora

    jeng, teng = engines
    sd = control_lora_sd(teng.loaded.unet)
    before = {k: v.clone() for k, v in flatten(teng.loaded.unet).items()}
    tree, cfg = assemble_control_lora(teng, sd, "tiny-control-lora")
    jtree, _ = jassemble(jeng, sd, "tiny-control-lora")
    assert cfg == teng.unet_cfg
    got, want = flatten(tree), jflatten(jtree)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        _assert_close(v.numpy(), w.transpose(3, 2, 0, 1) if w.ndim == 4 else w, rel=1e-6)
    base = flatten(teng.loaded.unet)
    for k in ("input_blocks.1.0.in_layers.2.weight", "time_embed.0.weight"):
        up, down = sd[k[:-7] + ".up"], sd[k[:-7] + ".down"]
        delta = (up.reshape(up.shape[0], -1).astype(np.float64)
                 @ down.reshape(down.shape[0], -1)).reshape(base[k].shape)
        _assert_close(got[k].numpy(), base[k].numpy() + delta, rel=1e-6)
    assert torch.equal(got["input_blocks.2.0.op.weight"], base["input_blocks.2.0.op.weight"])
    assert np.array_equal(got["input_blocks.1.0.in_layers.0.weight"].numpy(),
                          sd["input_blocks.1.0.in_layers.0.weight"])
    assert all(torch.equal(v, before[k]) for k, v in flatten(teng.loaded.unet).items())
    assert assemble_control_lora(teng, sd, "tiny-control-lora")[0] is tree  # cached on the engine


def test_mix_hint_and_latent_mask_match():
    from forge_tpu.pipeline.cn_inpaint import latent_mask_from_pixels as jlatent
    from forge_tpu.pipeline.cn_inpaint import mix_hint as jmix
    from forge_tpu_torch.pipeline.cn_inpaint import latent_mask_from_pixels, mix_hint

    rng = np.random.default_rng(9)
    for h, w in ((64, 48), (61, 45), (8, 8)):
        img = rng.random((h, w, 3)).astype(np.float32)
        mask = rng.random((h, w)).astype(np.float32)
        assert np.array_equal(mix_hint(img, mask), jmix(img, mask))
        got = latent_mask_from_pixels(mask)
        assert got.shape == (1, 1, h // 8, w // 8)
        assert np.array_equal(got, jlatent(mask).transpose(0, 3, 1, 2))


def test_feather_mask_matches_cv2():
    import cv2

    from forge_tpu_torch.pipeline.cn_inpaint import feather_mask

    rng = np.random.default_rng(10)
    for shape in ((64, 48), (13, 29), (5, 3)):
        for mask in (rng.random(shape).astype(np.float32),
                     (rng.random(shape) > 0.8).astype(np.float32)):
            want = np.clip(cv2.blur(cv2.dilate(mask, np.ones((7, 7), np.uint8)), (7, 7)), 0, 1)
            np.testing.assert_allclose(feather_mask(mask), want, rtol=0, atol=1e-6)


def test_inpaint_only_state_and_composite_match(engines):
    """The deferred hook's state (the source's latent, the latent and
    pixel masks, the image at the request's size) and the final composite,
    also onto an image of another size, against the reference's (which
    calls cv2)."""
    from forge_tpu.pipeline.cn_inpaint import attach_inpaint_only as jattach
    from forge_tpu.pipeline.cn_inpaint import composite_final as jcomposite
    from forge_tpu_torch.pipeline.cn_inpaint import attach_inpaint_only, composite_final

    jeng, teng = engines
    img, mask = init_and_mask(48, seed=12)
    jp = processing("forge_tpu").Processing(width=64, height=56)
    tp = processing("forge_tpu_torch").Processing(width=64, height=56)
    jattach(jeng, jp, img, mask)
    attach_inpaint_only(teng, tp, img, mask)
    st, jst = tp._cn_inpaint, jp._cn_inpaint
    _assert_close(st["latent"].numpy(), np.asarray(jst["latent"]).transpose(0, 3, 1, 2))
    assert np.array_equal(st["latent_mask"].numpy(),
                          np.asarray(jst["latent_mask"]).transpose(0, 3, 1, 2))
    assert np.array_equal(st["image"], jst["image"]) and np.array_equal(st["mask"], jst["mask"])
    assert tp.extra_generation_params == jp.extra_generation_params
    rng = np.random.default_rng(13)
    for shape in ((56, 64, 3), (112, 128, 3)):
        gen = rng.integers(0, 256, size=shape, dtype=np.uint8)
        got, want = composite_final(tp, gen), jcomposite(jp, gen)
        assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1
        assert np.mean(got == want) > 0.999
    plain = processing("forge_tpu_torch").Processing()
    gen = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    assert composite_final(plain, gen) is gen

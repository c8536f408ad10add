"""LoRA, the hires fix, inpainting and q8_0 weights on SD3 and Chroma, the
port against forge_tpu (CPU, f32).

The tiny SD3 (tests/test_torch_sd3.py: a 2-block MMDiT, CLIP-L, CLIP-G, T5,
the 16-channel VAE; both engines at context 128) and the tiny Chroma
(tests/test_torch_chroma.py: 2 + 2 blocks, its Approximator, T5) run the
same requests through both packages: a seeded rank-4 kohya LoRA over every
linear of the diffusion model and the text encoders' attention and MLP
linears (SD3: `lora_te1_` CLIP-L, `lora_te2_` CLIP-G, `lora_te3_` T5, which
neither matcher takes; Chroma: `lora_te3_` T5), the hires fix at 1.5× with
the "Latent" and "Lanczos" upscalers, inpainting of the family's own image
(whole picture and only masked), and SD3 with `unet_quant="q8_0"` (every
weight the loader's rule picks, its size cut lowered to 0 for the tiny
widths) against forge_tpu on the same codes dequantized, dense, with and
without a LoRA (online on the quantized leaves, merged on the reference's
dense weights). SD3 is held at 80 dB and Chroma at 40 dB (their files'
levels, peak 255). Then the full-width hires and inpaint requests of
chip_smoke's phase 26 traced on the meta device, and every feature the
families still refuse.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_family_features_cases as cases  # noqa: E402
from test_torch_sd3 import CTX, meta_engine  # noqa: E402
from test_torch_sd3 import REQUEST as SD3_REQUEST  # noqa: E402
from test_torch_sd3 import _tiny_sd3_checkpoint  # noqa: E402
from test_torch_serving import _count, _meta  # noqa: E402

TOLERANCE_DB = {"sd3": 80.0, "chroma": 40.0}
HIRES = dict(enable_hr=True, hr_scale=1.5, hr_denoising_strength=0.6)


class _Family:
    """One family's engines (forge_tpu's, the port's), its request, its LoRA
    file and its seed-1 image, made when first asked for."""

    def __init__(self, name, tmp):
        import test_torch_chroma as chroma
        from forge_tpu.pipeline.engine import load_engine as jload
        from forge_tpu_torch.pipeline.engine import load_engine
        from forge_tpu_torch.pipeline.processing import Processing, process_images

        if name == "sd3":
            ckpt = _tiny_sd3_checkpoint()
            self.jeng = jload(dict(ckpt), dtype=jnp.float32)
            self.teng = load_engine(dict(ckpt), device="cpu")
            self.jeng.loaded.context_dim = self.teng.loaded.context_dim = CTX
            self.request = dict(SD3_REQUEST)
        else:
            self.jeng, self.teng = chroma._engines(chroma._tiny_chroma_checkpoint())
            self.request = dict(chroma.REQUEST)
        self.lora = cases.lora_state_dict(self.teng)
        self.lora_path = cases.attach_lora(self.jeng, self.teng, tmp / name, self.lora)
        self.image = process_images(self.teng, Processing(**self.request)).images[0]


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = _Family(name, tmp_path_factory.mktemp("lora"))
        return made[name]

    return get


# -- LoRA ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sd3", "chroma"])
def test_lora_names_match_as_forge_tpu(families, name):
    """Both matchers take the same keys for each target and leave the same
    names: every `lora_unet_` name on the diffusion model; on SD3 `lora_te1_`
    on CLIP-L (the first engine in dict order holding the key: CLIP-L and
    CLIP-G share their layers' names), `lora_te2_` on CLIP-G (the first name
    holding "g"); `lora_te3_` (T5) nowhere."""
    f = families(name)
    (jmatched, junmatched), (matched, unmatched) = cases.matched_both_sides(f.jeng, f.teng,
                                                                            f.lora)
    assert matched == jmatched and unmatched == junmatched
    n_unet = sum(k.startswith("lora_unet_") for k in f.lora if k.endswith(".lora_up.weight"))
    assert len(matched["unet"]) == n_unet > 10
    assert unmatched and all(u.startswith("lora_te3_") for u in unmatched)
    if name == "sd3":
        assert set(matched) == {"unet", "te:clip_l", "te:clip_g", "te:t5xxl"}
        n_te = {p: sum(k.startswith(p) and k.endswith(".lora_up.weight") for k in f.lora)
                for p in ("lora_te1_", "lora_te2_")}
        assert (len(matched["te:clip_l"]), len(matched["te:clip_g"])) == (
            n_te["lora_te1_"], n_te["lora_te2_"])
        assert not matched["te:t5xxl"]
    else:
        assert set(matched) == {"unet", "te:t5xxl"} and not matched["te:t5xxl"]


@pytest.mark.parametrize("name", ["sd3", "chroma"])
def test_lora_matches_forge_tpu(families, name):
    """`<lora:tiny:0.8>` on the diffusion model and the text encoders: the
    image, its "Lora hashes" infotext key and the whole infotext as forge_tpu's;
    the image moves off the plain request's, and repeats byte for byte."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    f = families(name)
    prompt = f.request["prompt"] + f" <lora:{cases.LORA_NAME}:0.8>"
    want, got = cases.run_both(f.jeng, f.teng, f.request, prompt=prompt)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB[name], value
    assert cases.psnr(got.images[0], f.image) < 35.0
    assert "Lora hashes: " in got.infotexts[0] and got.infotexts[0] == want.infotexts[0]
    again = process_images(f.teng, Processing(**dict(f.request, prompt=prompt))).images[0]
    assert np.array_equal(again, got.images[0])
    assert "lora" in got.timings


# -- the hires fix ----------------------------------------------------------------------


@pytest.mark.parametrize("upscaler", ["Latent", "Lanczos"])
@pytest.mark.parametrize("name", ["sd3", "chroma"])
def test_hires_matches_forge_tpu(families, name, upscaler):
    """1.5× at strength 0.6 over the base's steps: the flow schedule's tail
    (SD3 at shift 3.0, Chroma's), 16-channel latents bilinear in latent space
    ("Latent") or decoded, Lanczos-upscaled and encoded ("Lanczos")."""
    from forge_tpu.sampling.schedules import get_sigmas as jget
    from forge_tpu_torch.sampling.schedules import get_sigmas

    f = families(name)
    steps = f.request["steps"]
    assert np.array_equal(get_sigmas("simple", steps, f.teng.predictor),
                          jget("simple", steps, f.jeng.predictor))
    want, got = cases.run_both(f.jeng, f.teng, f.request, hr_upscaler=upscaler, **HIRES)
    side = f.request["width"] * 3 // 2
    assert got.images[0].shape == want.images[0].shape == (side, side, 3)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB[name], value
    assert got.infotexts[0] == want.infotexts[0] and "Hires upscaler: " + upscaler in got.infotexts[0]
    assert {"hires_upscale", "hires_sample"} <= set(got.timings)


# -- inpainting -------------------------------------------------------------------------


@pytest.mark.parametrize("only_masked", [False, True], ids=["whole", "only_masked"])
@pytest.mark.parametrize("name", ["sd3", "chroma"])
def test_inpaint_matches_forge_tpu(families, name, only_masked):
    """The family's own seed-1 image under a centred mask (blur 1, strength
    0.75, "original"): the flow noising σ·noise + (1 − σ)·latent on 16
    channels, the latent mask, the composite; past the blurred mask every
    pixel is the init image's."""
    f = families(name)
    fields = cases.inpaint_fields(f.image, only_masked)
    want, got = cases.run_both(f.jeng, f.teng, f.request, **fields)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB[name], value
    keep = cases.outside_blur(fields["inpaint_mask"], cases.MASK_BLUR)
    assert keep.any() and not keep.all()
    assert np.array_equal(got.images[0][keep], f.image[keep])
    assert not np.array_equal(got.images[0], f.image)


# -- SD3 on q8_0 weights ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sd3_q8(tmp_path_factory):
    """The port's SD3 with `unet_quant="q8_0"` (the size cut 0: the tiny
    weights quantize) and forge_tpu's on the same codes dequantized, dense."""
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.core import loader
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.ops.quant import QuantLeaf, dequantize
    from forge_tpu_torch.pipeline.engine import load_engine

    ckpt = _tiny_sd3_checkpoint()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loader, "QUANT_MIN_SIZE", 0)
        teng = load_engine(dict(ckpt), device="cpu", unet_quant="q8_0")
    leaves = {k: v for k, v in flatten(teng.loaded.unet).items() if isinstance(v, QuantLeaf)}
    dense = dict(ckpt)
    for key, leaf in leaves.items():
        dense["model.diffusion_model." + key] = dequantize(leaf, torch.float32).numpy()
    jeng = jload(dense, dtype=jnp.float32)
    jeng.loaded.context_dim = teng.loaded.context_dim = CTX
    # bf16 values at alpha = rank: a strength of 0.5 keeps the port's bf16 epilogue factors exact
    lora = cases.lora_state_dict(teng, seed=6, bf16_values=True)
    cases.attach_lora(jeng, teng, tmp_path_factory.mktemp("lora_q8"), lora)
    return jeng, teng, leaves, ckpt


def test_sd3_q8_0_matches_forge_tpu_on_dequantized_weights(sd3_q8, monkeypatch):
    """The weights the port quantizes are the ones forge_tpu's
    `_to_quantized_tree` quantizes (at the same size cut): every 2-D MMDiT
    weight without "norm", "emb" or "bias" in its key, the pre-only last
    block's 2 and the final layer's 2 included; the image as forge_tpu's on
    the dequantized weights."""
    from forge_tpu.core import loader as jloader
    from forge_tpu.core.tree import flatten as jflatten
    from forge_tpu.ops.quant import QuantTensor

    jeng, teng, leaves, ckpt = sd3_q8
    unet = {k[len("model.diffusion_model."):]: v for k, v in ckpt.items()
            if k.startswith("model.diffusion_model.")}
    monkeypatch.setattr(jloader, "QUANT_MIN_SIZE", 0)
    tree = jflatten(jloader._to_quantized_tree(unet, "q8_0", jnp.float32))
    assert set(leaves) == {k for k, v in tree.items() if isinstance(v, QuantTensor)}
    assert len(leaves) == 10 + 2 + 5 + 2
    assert all(leaf.kind == "q8_0" for leaf in leaves.values())
    want, got = cases.run_both(jeng, teng, SD3_REQUEST)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= 80.0, value


def test_sd3_q8_0_lora_online_matches_forge_tpu_merged(sd3_q8):
    """A LoRA on the q8_0 engine: low-rank epilogue factors on every quantized
    leaf (its codes untouched), merged into the rest; forge_tpu merges the
    same LoRA into its dense weights."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.ops.quant import QuantLeaf
    from forge_tpu_torch.pipeline.extra_networks import activate

    jeng, teng, leaves, _ = sd3_q8
    prompt = SD3_REQUEST["prompt"] + f" <lora:{cases.LORA_NAME}:0.5>"
    _, patched, tes = activate(teng, [prompt], registry=teng.lora_registry)
    online = {k: v for k, v in flatten(patched).items() if isinstance(v, QuantLeaf)}
    assert set(online) == set(leaves) and set(tes) == {"clip_l", "clip_g"}
    for key, leaf in online.items():
        assert leaf.lora_down.shape[0] == 4 and leaf.lora_dense is None
        assert leaf.codes is leaves[key].codes and leaves[key].lora_down is None
    want, got = cases.run_both(jeng, teng, SD3_REQUEST, prompt=prompt)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= 80.0, value
    base = cases.run_both(jeng, teng, SD3_REQUEST)[1].images[0]
    assert cases.psnr(got.images[0], base) < 40.0


# -- chip_smoke phase 26 at full width on the meta device --------------------------------


def _chroma_meta_engine():
    from forge_tpu_torch.core.synth import DeviceFill, synth_chroma_checkpoint

    return meta_engine(synth_chroma_checkpoint(fill=DeviceFill("cpu")))


def _sd3_meta_engine():
    from forge_tpu_torch.core.synth import DeviceFill, synth_sd3_checkpoint

    return meta_engine(synth_sd3_checkpoint(fill=DeviceFill("cpu")))


@pytest.mark.parametrize("name", ["sd3", "chroma"])
def test_family_features_full_width_launch_counts(name):
    """One model call at 1024² and at the hires size 1536² (CFG batch 2), the
    1536² decode and the 1024² encode on the meta device: SD3's 24 joint
    attentions of 154 + 4096 and 154 + 9216 tokens, Chroma's 57 of 512 + 4096
    and 512 + 9216, no fused conv in either network; the VAE's one flash of
    512 and 28 (decode) or 20 (encode) convs; every call on the tensor-core
    body. chip_smoke's phase 26 expects these a request."""
    import chip_smoke

    engine = _sd3_meta_engine() if name == "sd3" else _chroma_meta_engine()
    if name == "sd3":
        cond = {"context": _meta((1, 154, 4096)), "y": _meta((1, 2048))}
        heads, text, d = 24, 154, 64
    else:
        g = torch.zeros((1,), device="meta")
        cond = {"context": _meta((1, 512, 4096)), "y": _meta((1, 768)), "guidance": g}
        heads, text, d = 24, 512, 128
    c = cases.trace_parts(engine, {
        "base": cases.model_call(engine, (1, 16, 128, 128), cond),
        "hires": cases.model_call(engine, (1, 16, 192, 192), cond),
        "decode": lambda: engine.decode_dispatch(_meta((1, 16, 192, 192), torch.float32)),
        "encode": lambda: engine.encode_first_stage(_meta((1, 3, 1024, 1024), torch.float32))})
    assert all(body == "wgmma" for part in c.values() for kind in ("flash", "conv")
               for *_, body in part[kind])
    spec = chip_smoke.FEATURES[name]
    for part, tokens in (("base", 4096), ("hires", 9216)):
        assert _count(c[part]["flash"]) == {((2, heads, text + tokens, d), text + tokens):
                                            spec["flash"]}
        assert c[part]["conv"] == [] and spec["conv"] == 0
    assert c["decode"]["flash"] == [((1, 1, 36864, 512), 36864, "wgmma")]
    assert len(c["decode"]["conv"]) == 28
    assert c["encode"]["flash"] == [((1, 1, 16384, 512), 16384, "wgmma")]
    assert len(c["encode"]["conv"]) == 20
    counts = chip_smoke.feature_counts(name, 2)
    assert counts["hires"] == {"flash_attention": 4 * spec["flash"] + 1,
                               "gn_silu_conv3x3": 28, "dequant_matmul": 0}
    assert counts["inpaint"] == {"flash_attention": 2 * spec["flash"] + 2,
                                 "gn_silu_conv3x3": 20 + 28, "dequant_matmul": 0}


def test_sd3_q8_0_full_width_dequant_calls():
    """SD3-medium on q8_0: the 239 weights the loader's rule quantizes (23
    blocks × 10, the pre-only block's 2 + 5, the final layer's 2), each one
    dequant-matmul a model call: the x stream at M = 2·4096 (1024²) and
    2·9216 (1536²), the context stream at M = 2·154, adaLN at M = 2; K and N
    from 1536 to 9216."""
    import chip_smoke

    engine = _sd3_meta_engine()
    n = cases.meta_quantized(engine)
    assert n == chip_smoke.SD3_Q8_LEAVES == 239
    cond = {"context": _meta((1, 154, 4096)), "y": _meta((1, 2048))}
    c = cases.trace_parts(engine, {"base": cases.model_call(engine, (1, 16, 128, 128), cond),
                                   "hires": cases.model_call(engine, (1, 16, 192, 192), cond)})
    for part, tokens in (("base", 4096), ("hires", 9216)):
        calls = c[part]["dequant"]
        assert len(calls) == n
        rows = _count([(m, (nn, k)) for m, nn, k in calls])
        assert {m for m, _ in rows} == {2 * tokens, 2 * 154, 2}
        assert rows[(2 * tokens, (4608, 1536))] == 24 and rows[(2 * 154, (4608, 1536))] == 24
        assert rows[(2 * tokens, (1536, 6144))] == 24 and rows[(2 * 154, (1536, 6144))] == 23
        assert rows[(2 * tokens, (64, 1536))] == 1 and rows[(2, (9216, 1536))] == 47
    shapes = {(m, nn, k) for m, nn, k in c["base"]["dequant"] + c["hires"]["dequant"]}
    assert shapes == set(chip_smoke.SD3_Q8_SHAPES)
    counts = chip_smoke.feature_counts("sd3", 2)
    assert counts["q8_0"]["dequant_matmul"] == 2 * n


# -- what stays refused -----------------------------------------------------------------


@pytest.mark.parametrize("field", sorted(cases.UNPORTED))
@pytest.mark.parametrize("name", ["sd3", "chroma"])
def test_unported_features_still_raise(families, name, field):
    """Each feature `UNPORTED_BY_FAMILY` still lists raises before any work,
    naming the family."""
    from forge_tpu_torch.pipeline.processing import UNPORTED_BY_FAMILY, Processing, process_images

    family = "sd3" if name == "sd3" else "chroma"
    assert set(UNPORTED_BY_FAMILY[family]) == set(cases.UNPORTED)
    f = families(name)
    with pytest.raises(NotImplementedError, match=family):
        process_images(f.teng, Processing(**dict(f.request, **cases.UNPORTED[field])))

"""LoRA, the hires fix, inpainting and Playground's img2img on SD2 and
Playground v2.5, the port against forge_tpu (CPU, f32).

The tiny SD2 768-v (tests/test_torch_sd2.py: SD1.5's topology at 32
channels, linear projections, an open_clip tower renamed `clip_h`, the v
objective) and the tiny Playground v2.5 (tests/test_torch_playground.py:
the tiny SDXL with the EDM marker keys, σ_data 0.5, σ 0.002–120, the
channel latent format) run the same requests through both packages: a
seeded rank-4 kohya LoRA over every linear of the UNet and the text
encoders' attention and MLP linears (SD2: `lora_te_` on OpenCLIP-H;
Playground: `lora_te1_` CLIP-L, `lora_te2_` CLIP-G), the hires fix at 1.5×
with the "Latent" and "Lanczos" upscalers, inpainting of the family's own
image (whole picture and only masked) and, on Playground, img2img at
strength 0.5 (the EDM noising from σ_max 120, the encode through the channel
format). Both are held at 70 dB (their files' level, peak 255). Then the
full-width requests of chip_smoke's phase 26 traced on the meta device, and
every feature the families still refuse.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_family_features_cases as cases  # noqa: E402
from test_torch_sd3 import meta_engine  # noqa: E402
from test_torch_serving import _count, _meta  # noqa: E402

TOLERANCE_DB = 70.0
HIRES = dict(enable_hr=True, hr_scale=1.5, hr_denoising_strength=0.6)
FAMILY = {"sd2": "sd20", "playground": "playground"}


def _playground_engines():
    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from test_torch_sdxl import ADM, CTX, _tiny_sdxl_checkpoint

    sd = _tiny_sdxl_checkpoint()
    sd["edm_mean"] = np.zeros(4, np.float32)  # the single-file EDM markers
    sd["edm_std"] = np.ones(4, np.float32)
    jeng = jload(dict(sd), dtype=jnp.float32)
    jeng.unet_cfg = JCfg(context_dim=CTX, num_heads=4, use_linear_projection=True,
                         adm_in_channels=ADM)
    teng = load_engine(dict(sd), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CTX, num_heads=4)
    return jeng, teng


class _Family:
    """One family's engines, its request, its LoRA file and its seed-1 image."""

    def __init__(self, name, tmp):
        import test_torch_playground as playground
        import test_torch_sd2 as sd2
        from forge_tpu_torch.pipeline.processing import Processing, process_images

        if name == "sd2":
            self.jeng, self.teng = sd2._engines(True)  # SD2.1-768-v's objective
            self.request = dict(sd2.REQUEST)
        else:
            self.jeng, self.teng = _playground_engines()
            self.request = dict(playground.REQUEST)
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


@pytest.mark.parametrize("name", ["sd2", "playground"])
def test_lora_names_match_as_forge_tpu(families, name):
    """Both matchers take the same keys for each target and leave none: every
    `lora_unet_` name on the UNet (linear projections, attention, feed-forward,
    time and label embeddings); SD2's `lora_te_` on `clip_h` (the open_clip
    tower in the HF key space both loaders give it); Playground's `lora_te1_`
    on CLIP-L and `lora_te2_` on CLIP-G."""
    f = families(name)
    (jmatched, junmatched), (matched, unmatched) = cases.matched_both_sides(f.jeng, f.teng,
                                                                            f.lora)
    assert matched == jmatched and unmatched == junmatched == []
    ups = [k for k in f.lora if k.endswith(".lora_up.weight")]
    assert len(matched["unet"]) == sum(k.startswith("lora_unet_") for k in ups) > 10
    if name == "sd2":
        assert set(matched) == {"unet", "te:clip_h"}
        assert len(matched["te:clip_h"]) == sum(k.startswith("lora_te_") for k in ups)
    else:
        assert set(matched) == {"unet", "te:clip_l", "te:clip_g"}
        assert (len(matched["te:clip_l"]), len(matched["te:clip_g"])) == tuple(
            sum(k.startswith(p) for k in ups) for p in ("lora_te1_", "lora_te2_"))


@pytest.mark.parametrize("name", ["sd2", "playground"])
def test_lora_matches_forge_tpu(families, name):
    """`<lora:tiny:0.8>` on the UNet and the text tower(s): the image and the
    infotext (its "Lora hashes" key) as forge_tpu's; the image moves off the
    plain request's, and repeats byte for byte."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    f = families(name)
    prompt = f.request["prompt"] + f" <lora:{cases.LORA_NAME}:0.8>"
    want, got = cases.run_both(f.jeng, f.teng, f.request, prompt=prompt)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB, value
    assert cases.psnr(got.images[0], f.image) < 35.0
    assert "Lora hashes: " in got.infotexts[0] and got.infotexts[0] == want.infotexts[0]
    again = process_images(f.teng, Processing(**dict(f.request, prompt=prompt))).images[0]
    assert np.array_equal(again, got.images[0])


# -- the hires fix ----------------------------------------------------------------------


@pytest.mark.parametrize("upscaler", ["Latent", "Lanczos"])
@pytest.mark.parametrize("name", ["sd2", "playground"])
def test_hires_matches_forge_tpu(families, name, upscaler):
    """1.5× at strength 0.6 over the base's steps: SD2's v objective over the
    discrete schedule's tail; Playground's EDM at σ_data 0.5, its channel
    latent format around the latent upscale and the pixel one's encode."""
    f = families(name)
    want, got = cases.run_both(f.jeng, f.teng, f.request, hr_upscaler=upscaler, **HIRES)
    side = f.request["width"] * 3 // 2
    assert got.images[0].shape == want.images[0].shape == (side, side, 3)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB, value
    assert got.infotexts[0] == want.infotexts[0]
    assert "Hires upscaler: " + upscaler in got.infotexts[0]


# -- inpainting and img2img -------------------------------------------------------------


@pytest.mark.parametrize("only_masked", [False, True], ids=["whole", "only_masked"])
@pytest.mark.parametrize("name", ["sd2", "playground"])
def test_inpaint_matches_forge_tpu(families, name, only_masked):
    """The family's own seed-1 image under a centred mask (blur 1, strength
    0.75, "original"): v or EDM noising of the encoded image, the latent mask,
    the composite; past the blurred mask every pixel is the init image's."""
    f = families(name)
    fields = cases.inpaint_fields(f.image, only_masked)
    want, got = cases.run_both(f.jeng, f.teng, f.request, **fields)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB, value
    keep = cases.outside_blur(fields["inpaint_mask"], cases.MASK_BLUR)
    assert keep.any() and not keep.all()
    assert np.array_equal(got.images[0][keep], f.image[keep])
    assert not np.array_equal(got.images[0], f.image)


def test_playground_img2img_matches_forge_tpu(families):
    """Strength 0.5 of 3 DPM++ 2M Karras steps over a smooth init image: the
    schedule's tail from σ_max 120, x = latent + σ·noise, the VAE encode
    through the channel latent format."""
    f = families("playground")
    h, w = f.request["height"], f.request["width"]
    yy, xx = np.mgrid[0:h, 0:w]
    init = np.stack([yy * 4, xx * 4, (yy + xx) * 2], -1).astype(np.uint8)
    want, got = cases.run_both(f.jeng, f.teng, f.request, init_images=[init],
                               denoising_strength=0.5)
    assert got.images[0].shape == want.images[0].shape == (h, w, 3)
    value = cases.psnr(got.images[0], want.images[0])
    assert value >= TOLERANCE_DB, value
    assert got.infotexts[0] == want.infotexts[0] and "Denoising strength: 0.5" in got.infotexts[0]


# -- chip_smoke phase 26 at full width on the meta device --------------------------------


def _meta_family(name):
    from forge_tpu_torch.core import synth
    from forge_tpu_torch.core.synth import DeviceFill

    make = synth.synth_sd2_checkpoint if name == "sd2" else synth.synth_playground_checkpoint
    return meta_engine(make(fill=DeviceFill("cpu")))


@pytest.mark.parametrize("name", ["sd2", "playground"])
def test_family_features_full_width_launch_counts(name):
    """One UNet call at the base size and at the 1.5× hires size (CFG batch
    2), the hires decode and the base-size encode on the meta device. SD2 at
    768² → 1152²: 15 self-attentions of ≥ 512 tokens (5 heads of 20736, 10 of
    5184, 20 of 1296 at 1152²; the middle block's 324 tokens plain) and 44
    convs a call; Playground at 1024² → 1536²: SDXL's 70 (10 heads of 9216,
    20 of 2304 at 1536²) and 34; the VAE one flash and 28 (decode) or 20
    (encode) convs; every call on the tensor-core body. chip_smoke's phase 26
    expects these a request."""
    import chip_smoke

    engine = _meta_family(name)
    spec = chip_smoke.FEATURES[name]
    base, hires = spec["size"] // 8, spec["size"] * 3 // 16
    if name == "sd2":
        cond = {"context": _meta((1, 77, 1024))}
        levels = [(5, 1), (10, 4), (20, 16)]
        per_level = (5, 5, 5)
    else:
        cond = {"context": _meta((1, 77, 2048)), "y": _meta((1, 2816))}
        levels = [(10, 4), (20, 16)]
        per_level = (10, 60)
    c = cases.trace_parts(engine, {
        "base": cases.model_call(engine, (1, 4, base, base), cond),
        "hires": cases.model_call(engine, (1, 4, hires, hires), cond),
        "decode": lambda: engine.decode_dispatch(_meta((1, 4, hires, hires), torch.float32)),
        "encode": lambda: engine.encode_first_stage(
            _meta((1, 3, spec["size"], spec["size"]), torch.float32))})
    assert all(body == "wgmma" for part in c.values() for kind in ("flash", "conv")
               for *_, body in part[kind])
    for part, side in (("base", base), ("hires", hires)):
        want = {((2, heads, side * side // div, 64), side * side // div): n
                for (heads, div), n in zip(levels, per_level)}
        assert _count(c[part]["flash"]) == want
        assert len(c[part]["flash"]) == spec["flash"]
        assert len(c[part]["conv"]) == spec["conv"]
    assert c["decode"]["flash"] == [((1, 1, hires * hires, 512), hires * hires, "wgmma")]
    assert len(c["decode"]["conv"]) == 28
    assert c["encode"]["flash"] == [((1, 1, base * base, 512), base * base, "wgmma")]
    assert len(c["encode"]["conv"]) == 20
    if name == "sd2":  # the middle block's 18² stays plain, as 12² does at 768²
        assert not any(q[2] == 324 for q, _, _ in c["hires"]["flash"])
    counts = chip_smoke.feature_counts(name, 2)
    assert counts["hires"] == {"flash_attention": 4 * spec["flash"] + 1,
                               "gn_silu_conv3x3": 4 * spec["conv"] + 28, "dequant_matmul": 0}
    assert counts["inpaint"] == {"flash_attention": 2 * spec["flash"] + 2,
                                 "gn_silu_conv3x3": 2 * spec["conv"] + 48, "dequant_matmul": 0}
    hires_convs = {(x[1], o, x[2]) for x, o, _ in c["hires"]["conv"] + c["decode"]["conv"]}
    assert hires_convs <= {(s[0][1], s[1], s[0][2]) for s in chip_smoke.FEATURES_CONV_SHAPES}


# -- what stays refused -----------------------------------------------------------------


@pytest.mark.parametrize("field", sorted(cases.UNPORTED))
@pytest.mark.parametrize("name", ["sd2", "playground"])
def test_unported_features_still_raise(families, name, field):
    """Each feature `UNPORTED_BY_FAMILY` still lists raises before any work,
    naming the family."""
    from forge_tpu_torch.pipeline.processing import UNPORTED_BY_FAMILY, Processing, process_images

    family = FAMILY[name]
    assert set(UNPORTED_BY_FAMILY[family]) == set(cases.UNPORTED)
    f = families(name)
    with pytest.raises(NotImplementedError, match=family):
        process_images(f.teng, Processing(**dict(f.request, **cases.UNPORTED[field])))

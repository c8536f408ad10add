"""The port's img2img slice end to end against forge_tpu: config 3 in small.

The tiny SDXL checkpoint of tests/test_torch_sdxl.py, a tiny LoRA over its
UNet attention and both text towers (written by the port's safetensors
writer, read by each package's registry), and a tiny SDXL-geometry
ControlNet-canny whose hint is `canny` of the init image, through
`process_images` in both packages (f32 on the CPU): img2img; inpainting
with the "original" and "latent noise" fills; "only masked" inpainting.
64² DPM++ 2M Karras, 5 steps at strength 0.6 (4 model calls), CFG 7,
seed 1. The uint8 images must reach PSNR ≥ 40 dB against each other, the
bar of tests/test_golden_parity.py; pixels the blurred mask does not reach
equal the init image's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest  # noqa: E402
from test_torch_controlnet import jcfg, tcfg, tiny_controlnet_sd  # noqa: E402
from test_torch_sdxl import _jax_engine, _port_engine, _psnr, _tiny_sdxl_checkpoint  # noqa: E402

SIZE = 64
REQUEST = dict(prompt="a castle on a hill <lora:tiny:0.8>", negative_prompt="blurry", seed=1,
               steps=5, width=SIZE, height=SIZE, sampler_name="DPM++ 2M", scheduler="karras",
               cfg_scale=7.0, denoising_strength=0.6)
CASES = {
    "img2img": dict(),
    "inpaint original": dict(mask=(24, 40, 20, 44), inpainting_fill="original"),
    "inpaint latent noise": dict(mask=(24, 40, 20, 44), inpainting_fill="latent_noise"),
    "only masked": dict(mask=(20, 36, 24, 40), inpaint_full_res=True, inpaint_full_res_padding=4),
}


def _lora():
    r = np.random.default_rng(0)
    sd = {}
    for base, o, i in (("lora_unet_input_blocks_3_1_transformer_blocks_0_attn1_to_q", 64, 64),
                       ("lora_unet_output_blocks_0_1_transformer_blocks_0_attn1_to_v", 64, 64),
                       ("lora_te1_text_model_encoder_layers_0_self_attn_q_proj", 64, 64),
                       ("lora_te2_text_model_encoder_layers_1_mlp_fc1", 256, 64)):
        sd[base + ".lora_up.weight"] = (r.standard_normal((o, 4)) * 0.2).astype(np.float32)
        sd[base + ".lora_down.weight"] = (r.standard_normal((4, i)) * 0.2).astype(np.float32)
        sd[base + ".alpha"] = np.asarray(4, np.float32)
    return sd


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from forge_tpu.pipeline.extra_networks import LoraRegistry as JRegistry
    from forge_tpu.preprocessors.cv import canny
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.pipeline.extra_networks import LoraRegistry

    lora_dir = tmp_path_factory.mktemp("lora")
    save_safetensors(_lora(), str(lora_dir / "tiny.safetensors"))
    sd = _tiny_sdxl_checkpoint()
    jeng, teng = _jax_engine(sd), _port_engine(sd)
    jeng.lora_registry = JRegistry([str(lora_dir)])
    teng.lora_registry = LoraRegistry([str(lora_dir)])
    cn = tiny_controlnet_sd()
    init = np.random.default_rng(0).uniform(0, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)
    init[8:40, 12:52] //= 3  # a dark block, so canny finds an outline
    hint = np.repeat(canny(init)[..., None], 3, -1)[None].astype(np.float32)
    jcn = jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(cn).items()})
    tcn = nest({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cn.items()})
    return jeng, teng, jcn, tcn, init, hint


def _request(proc, cn_mod, cn_params, hint, init, case):
    kw = dict(CASES[case])
    mask_box = kw.pop("mask", None)
    p = proc.Processing(**REQUEST, init_images=[init], **kw)
    if mask_box is not None:
        y1, y2, x1, x2 = mask_box
        mask = np.zeros((SIZE, SIZE), np.float32)
        mask[y1:y2, x1:x2] = 1.0
        p.inpaint_mask = mask
    p.controlnets = [cn_mod.ControlNetState(params=cn_params, hint=hint, strength=1.0,
                                            cfg=jcfg() if cn_mod.__name__.startswith("forge_tpu.")
                                            else tcfg())]
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_img2img_slice_matches_forge_tpu(setup, case):
    from forge_tpu.models import controlnet as jcn_mod
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.models import controlnet as tcn_mod
    from forge_tpu_torch.pipeline import processing as tproc

    jeng, teng, jcn, tcn, init, hint = setup
    jp = _request(jproc, jcn_mod, jcn, jnp.asarray(hint), init, case)
    jp.controlnets[0].digest = "tiny-canny"
    want = jproc.process_images(jeng, jp).images[0]
    tp = _request(tproc, tcn_mod, tcn, torch.from_numpy(hint.transpose(0, 3, 1, 2)), init, case)
    res = tproc.process_images(teng, tp)
    got = res.images[0]
    assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    assert {"lora", "cond", "encode", "noise", "sample", "decode"} <= set(res.timings)
    value = _psnr(got, want)
    print(f"{case}: PSNR {value:.2f} dB")
    assert value >= 40.0, value
    if case != "img2img":  # pixels past the blur's reach (4σ = 16 px) keep the init image
        y1, y2, x1, x2 = CASES[case]["mask"]
        if case == "only masked":
            region = (y1 - 4, y2 + 4, x1 - 4, x2 + 4)  # the padded crop it pastes into
            y1, y2, x1, x2 = region
        far = np.ones((SIZE, SIZE), bool)
        far[max(y1 - 17, 0):y2 + 17, max(x1 - 17, 0):x2 + 17] = False
        assert far.any() and np.array_equal(got[far], init[far])
        assert not np.array_equal(got, init)


def test_lora_and_controlnet_change_the_image(setup):
    """The LoRA and the ControlNet each move the result (the test above
    would pass with either left out if both packages left it out), and the
    engine's weights are unchanged after a LoRA request."""
    from forge_tpu_torch.models import controlnet as tcn_mod
    from forge_tpu_torch.pipeline import processing as tproc

    _, teng, _, tcn, init, hint = setup
    w = teng.loaded.unet["input_blocks"]["3"]["1"]["transformer_blocks"]["0"]["attn1"]["to_q"]["weight"]
    w0 = w.clone()
    thint = torch.from_numpy(hint.transpose(0, 3, 1, 2))
    base = tproc.process_images(teng, _request(tproc, tcn_mod, tcn, thint, init, "img2img")).images[0]
    p = _request(tproc, tcn_mod, tcn, thint, init, "img2img")
    p.prompt = "a castle on a hill"
    no_lora = tproc.process_images(teng, p).images[0]
    p = _request(tproc, tcn_mod, tcn, thint, init, "img2img")
    p.controlnets = None
    no_cn = tproc.process_images(teng, p).images[0]
    assert _psnr(base, no_lora) < 60 and _psnr(base, no_cn) < 60
    assert torch.equal(w, w0)
    assert teng.loaded.unet["input_blocks"]["3"]["1"]["transformer_blocks"]["0"]["attn1"]["to_q"][
        "weight"] is w


def test_only_masked_inverts_the_mask_once(setup):
    """"Only masked" with `inpainting_mask_invert` repaints what the inverted
    mask marks: the same image as the inverted mask given outright. The
    reference inverts the crop's mask a second time (its
    processing.py:1619 passes the flag on with the already inverted crop)."""
    from forge_tpu_torch.models import controlnet as tcn_mod
    from forge_tpu_torch.pipeline import processing as tproc

    _, teng, _, tcn, init, hint = setup
    thint = torch.from_numpy(hint.transpose(0, 3, 1, 2))
    inverted = _request(tproc, tcn_mod, tcn, thint, init, "only masked")
    inverted.inpaint_mask = 1.0 - inverted.inpaint_mask
    inverted.inpainting_mask_invert = True
    plain = _request(tproc, tcn_mod, tcn, thint, init, "only masked")
    got = tproc.process_images(teng, inverted).images[0]
    assert np.array_equal(got, tproc.process_images(teng, plain).images[0])


def test_prompt_features_not_ported_still_raise(setup):
    """Prompt editing and AND run now, beside a LoRA tag (its hash in the
    infotext), on img2img too; in the prompt a hires pass encodes for
    itself they still raise (the reference encodes them as literal text)."""
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts

    teng, init = setup[1], setup[4]
    with opts.override({"save_write_params_txt": False}):
        for prompt in ("a [cat:dog:0.5] <lora:tiny:0.8>", "a cat AND a dog"):
            for fields in ({}, dict(init_images=[init], denoising_strength=0.6)):
                res = tproc.process_images(teng, tproc.Processing(
                    prompt=prompt, seed=1, steps=2, width=SIZE, height=SIZE, **fields))
                assert res.images[0].shape == (SIZE, SIZE, 3)
                assert ('Lora hashes: "tiny: ' in res.infotexts[0]) == ("lora" in prompt)
        with pytest.raises(NotImplementedError, match="not ported"):
            tproc.process_images(teng, tproc.Processing(
                prompt="a cat", hr_prompt="a [cat:dog:0.5]", enable_hr=True, steps=2,
                width=SIZE, height=SIZE))

"""The img2img slice's request, fixtures and check, shared by
tests/test_torch_img2img_slice.py and tests/test_torch_img2img_inpaint.py,
split so that the two files run on different workers.
"""

import numpy as np
import jax.numpy as jnp
import torch

from forge_tpu.core.state_dict import transform_for_jax
from forge_tpu.core.tree import nest as jax_nest
from forge_tpu_torch.core.convert import nest
from test_torch_controlnet import jcfg, tcfg, tiny_controlnet_sd
from test_torch_sdxl import _jax_engine, _port_engine, _psnr, _tiny_sdxl_checkpoint

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


def make_setup(tmp_path_factory):
    """(forge_tpu engine, port engine, both ControlNets' params, the init image, the canny hint)."""
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


def check_img2img_slice_matches_forge_tpu(setup, case):
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

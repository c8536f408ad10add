"""Shared pieces of tests/test_torch_family_features_dit.py (SD3, Chroma) and
test_torch_family_features_unet.py (SD2, Playground v2.5): a seeded kohya
LoRA file over a tiny engine's diffusion model and text encoders, both
packages' requests on one pair of engines, the centred inpaint mask, the
unmatched LoRA names of both matchers, and a meta-device tracer of the
kernels' call sites (flash in `ops/attention.py`, `models/mmdit.py` and
`models/flux.py`, the fused conv, the dequant-matmul's linears) for
chip_smoke's phase 26 counts."""

import os

import numpy as np
import torch

from test_torch_serving import _meta

LORA_NAME = "tiny"
UNPORTED = {  # each feature `UNPORTED_BY_FAMILY` still lists, as a request asks for it
    "controlnets": dict(controlnets=[object()]),
    "unet_hooks": dict(unet_hooks={"attn2_patch": [lambda q, k, v, extra: (q, k, v)]}),
    "tiled_diffusion": dict(tiled_diffusion={"tile": 8, "overlap": 2}),
    "refiner": dict(refiner_checkpoint="refiner", refiner_switch_at=0.8),
    "regional_prompts": dict(regional_prompts=[dict(prompt="an owl", area=(0, 0, 0.5, 1))]),
    "hook_phases": dict(hook_phases=[(0.5, {})]),
    "deferred_hooks": dict(deferred_hooks=[lambda engine, p, cond, uncond: None]),
    "pre_cfg_hooks": dict(pre_cfg_hooks=[lambda *a: a]),
    "post_cfg_hooks": dict(post_cfg_hooks=[lambda *a: a]),
    "cfg_combine_hook": dict(cfg_combine_hook=lambda *a: a),
    "reference_state": dict(reference_state=object()),
    "cond_transform": dict(cond_transform=lambda cond: cond),
}


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _te_module(key: str) -> bool:
    """A text encoder's attention and MLP linears (CLIP's and T5's), not its embeddings."""
    return any(s in key for s in ("self_attn", "mlp", "SelfAttention", "DenseReluDense"))


def lora_state_dict(teng, seed: int = 5, rank: int = 4, alpha: float = 4.0,
                    bf16_values: bool = False):
    """A kohya LoRA over every linear of the engine's diffusion model (`lora_unet_`)
    and each text encoder's attention and MLP linears (its trainer's prefix: T5's
    `lora_te3_` is matched by neither package)."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.synth import KOHYA_TE_PREFIX, kohya_lora_targets, synth_kohya_lora

    targets = kohya_lora_targets({k: tuple(v.shape) for k, v in flatten(teng.loaded.unet).items()},
                                 "lora_unet_")
    for name, engine in teng.text_engines.items():
        shapes = {k: tuple(v.shape) for k, v in flatten(engine.params).items()}
        targets.update(kohya_lora_targets(shapes, KOHYA_TE_PREFIX[name], _te_module))
    sd = synth_kohya_lora(targets, rank=rank, alpha=alpha, seed=seed, scale=0.1)
    if bf16_values:  # values a bf16 epilogue factor holds exactly
        sd = {k: torch.from_numpy(v).bfloat16().float().numpy() if v.ndim == 2 else v
              for k, v in sd.items()}
    return sd


def attach_lora(jeng, teng, directory, sd) -> str:
    """`sd` written as `<directory>/tiny.safetensors`, both engines' registries on it."""
    from forge_tpu.pipeline.extra_networks import LoraRegistry as JRegistry
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.pipeline.extra_networks import LoraRegistry

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{LORA_NAME}.safetensors")
    save_safetensors(sd, path)
    jeng.lora_registry = JRegistry([str(directory)])
    teng.lora_registry = LoraRegistry([str(directory)])
    return path


def matched_both_sides(jeng, teng, sd):
    """Both matchers over the engines' own key sets → ({target: matched keys}, unmatched
    names) of each package."""
    from forge_tpu.core.patches import match_lora as jmatch
    from forge_tpu.core.tree import flatten as jflatten
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.patches import match_lora

    out = []
    for match, flat, eng in ((jmatch, jflatten, jeng), (match_lora, flatten, teng)):
        te_keys = {n: flat(te.params).keys() for n, te in eng.text_engines.items()}
        result, unmatched = match(sd, flat(eng.loaded.unet).keys(), te_keys_by_name=te_keys)
        out.append(({target: set(patches) for target, patches in result.items()},
                    sorted(unmatched)))
    return out


def run_both(jeng, teng, request, **fields):
    """The same request through forge_tpu and the port → (reference's, port's) Processed."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    fields = dict(request, **fields)
    return (jproc.process_images(jeng, jproc.Processing(**fields)),
            process_images(teng, Processing(**fields)))


def centred_mask(h: int, w: int) -> np.ndarray:
    """A centred rectangle, half the image each way (1 = repaint)."""
    mask = np.zeros((h, w), np.float32)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
    return mask


MASK_BLUR = 1  # the blur's support (4σ) leaves a ring untouched around a 32² image's mask


def inpaint_fields(init: np.ndarray, only_masked: bool):
    h, w = init.shape[:2]
    return dict(init_images=[init], inpaint_mask=centred_mask(h, w), mask_blur=MASK_BLUR,
                denoising_strength=0.75, inpainting_fill="original",
                inpaint_full_res=only_masked, inpaint_full_res_padding=4)


def outside_blur(mask: np.ndarray, blur: float) -> np.ndarray:
    """The pixels the blurred mask leaves untouched: the composite keeps the init image there."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(mask, sigma=blur) == 0


def trace_parts(engine, parts):
    """Every kernel call of each part (a thunk run on the meta device) → {part:
    {kernel: [call]}}: flash as (q shape, Lk, body), a fused conv as (x shape,
    O, body), a quantized linear as (M, N, K)."""
    from forge_tpu_torch.models import flux as flux_mod
    from forge_tpu_torch.models import mmdit as mmdit_mod
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops import nn as nn_mod
    from forge_tpu_torch.ops.flash_attention import flash_body
    import pytest

    calls = {}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    def linear_quantized(x, leaf, bias=None):
        m = int(np.prod(x.shape[:-1]))
        calls["dequant"].append((m, leaf.shape[0], leaf.shape[1]))
        return _meta(tuple(x.shape[:-1]) + (leaf.shape[0],), x.dtype)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (attention_mod, mmdit_mod, flux_mod):
            mp.setattr(mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        mp.setattr(nn_mod, "linear_quantized", linear_quantized)
        for name, run in parts.items():
            calls.update(flash=[], conv=[], dequant=[])
            run()
            out[name] = {k: list(v) for k, v in calls.items()}
    return out


def model_call(engine, x_shape, cond):
    """One `processing.denoise` over one σ at CFG batch 2 on the meta device."""
    from forge_tpu_torch.pipeline import processing as proc

    p = proc.Processing(width=x_shape[3] * 8, height=x_shape[2] * 8, cfg_scale=4.0,
                        sampler_name="Euler")
    job = proc.Job(p, _meta(x_shape, torch.float32), np.array([0.9, 0.0]), None, cond, cond,
                   engine.loaded.unet)
    return lambda: proc.denoise(engine, job)


def meta_quantized(engine, kind: str = "q8_0") -> int:
    """The engine's diffusion-model weights that `unet_quant=kind` quantizes
    (core/loader.py `_quantizes`) made meta `QuantLeaf`s in place → their count."""
    from forge_tpu_torch.core.convert import flatten, nest
    from forge_tpu_torch.core.loader import _quantizes
    from forge_tpu_torch.ops.quant import QuantLeaf

    flat = flatten(engine.loaded.unet)
    n = 0
    for key, value in flat.items():
        if _quantizes(key, tuple(value.shape)):
            flat[key] = QuantLeaf(kind, tuple(value.shape), _meta((1,), torch.uint8),
                                  _meta((1,), torch.float16))
            n += 1
    engine.loaded.unet = nest(flat)
    return n

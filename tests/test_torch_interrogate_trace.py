"""chip_smoke's phase 23 at full width, traced on the meta device (no
memory): BLIP's ViT-B/16 at 384² makes exactly 12 flash calls at
q(1,12,577,64); Marigold's SD2 UNet at batch 1 on a 64² latent 10 (five at
q(1,5,4096,64), five at q(1,10,1024,64)) and 44 fused convs, its VAE's 512²
encode and decode one flash each (q(1,1,4096,512)) and 20 and 28 convs, all
tensor-core in bf16, with every conv shape in chip_smoke's rows; the other
networks of the phase at their published widths (CLIP ViT-L/14's towers,
BLIP's decoder, DeepDanbooru, LeReS, ZoeDepth, UniFormer, the anime face,
LaMa) call no kernel and give the shapes their callers expect; phase 23's
counts compose as chip_smoke says.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import collections

import pytest

torch = pytest.importorskip("torch")

from test_torch_extras_trace import meta_tree  # noqa: E402


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.fixture
def kernels(monkeypatch):
    """The flash and fused-conv wrappers replaced by recorders on meta tensors."""
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.ops.fused_gn_conv import conv_body

    flash, conv = collections.Counter(), collections.Counter()

    def fake_flash(q, k, v, scale=None, body=None):
        flash[(tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype))] += 1
        return torch.empty_like(q)

    def fake_conv(x, a, s, w, bias=None, body=None):
        conv[((tuple(x.shape), w.shape[0]), conv_body(x.shape[1], w.shape[0], x.dtype))] += 1
        return _meta((x.shape[0], w.shape[0], x.shape[2], x.shape[3]), x.dtype)

    monkeypatch.setattr(attention_mod, "flash_attention", fake_flash)
    monkeypatch.setattr(fused_gn_conv, "gn_silu_conv3x3", fake_conv)
    return flash, conv


def test_blip_vit_at_384(kernels):
    from forge_tpu_torch.core.synth_annotators import synth_blip_sd
    from forge_tpu_torch.models.blip import bert_decode_logits, vit_encode

    flash, conv = kernels
    tree = meta_tree(synth_blip_sd(fill="zeros"))
    with torch.no_grad():
        v = vit_encode(tree["visual_encoder"], _meta((1, 3, 384, 384)))
        assert dict(flash) == {((1, 12, 577, 64), 577, "wgmma"): 12}
        logits = bert_decode_logits(tree["text_decoder"], torch.zeros((1, 48), dtype=torch.int64,
                                                                      device="meta"), v)
    assert tuple(v.shape) == (1, 577, 768) and tuple(logits.shape) == (1, 48, 30524)
    assert sum(flash.values()) == 12 and not conv


def test_marigold_unet_and_vae(kernels):
    import chip_smoke
    from forge_tpu_torch.core.synth_annotators import synth_marigold_sd
    from forge_tpu_torch.models.unet import UNetConfig, unet_apply
    from forge_tpu_torch.models.vae import vae_decode, vae_encode

    flash, conv = kernels
    sd = synth_marigold_sd(fill="zeros")

    def part(prefix):
        return meta_tree({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})

    unet, vae = part("unet."), part("vae.")
    with torch.no_grad():
        out = unet_apply(unet, _meta((1, 8, 64, 64)), _meta((1,), torch.float32),
                         _meta((1, 2, 1024)), cfg=UNetConfig(context_dim=1024, head_dim=64))
        assert tuple(out.shape) == (1, 4, 64, 64)
        assert dict(flash) == {((1, 5, 4096, 64), 4096, "wgmma"): 5,
                               ((1, 10, 1024, 64), 1024, "wgmma"): 5}
        assert sum(conv.values()) == chip_smoke.MARIGOLD_UNET["gn_silu_conv3x3"] == 44
        unet_shapes = {shape for shape, _ in conv}
        flash.clear()
        conv.clear()
        z = vae_encode(vae, _meta((1, 3, 512, 512)))
        n_enc = sum(conv.values())
        y = vae_decode(vae, z)
    assert tuple(z.shape) == (1, 4, 64, 64) and tuple(y.shape) == (1, 3, 512, 512)
    assert dict(flash) == {((1, 1, 4096, 512), 4096, "wgmma"): 2}
    assert (n_enc, sum(conv.values()) - n_enc) == (20, 28)
    assert chip_smoke.MARIGOLD_VAE == {"flash_attention": 2, "gn_silu_conv3x3": 48}
    assert {body for _, body in conv} == {"wgmma"}
    shapes = unet_shapes | {shape for shape, _ in conv}
    assert shapes == set(chip_smoke.MARIGOLD_CONV_SHAPES)
    assert shapes <= set(chip_smoke.GN_CONV_SHAPES)
    for row in chip_smoke.INTERROGATE_FLASH_SHAPES:
        assert row in chip_smoke.FLASH_SHAPES and row in chip_smoke.INTERROGATE_ROWS[0]


NETS = {  # synth function → (module, forward, input shape, output shape)
    "synth_deepbooru_sd": ("forge_tpu_torch.postprocessing.deepbooru", "deepbooru_apply",
                           (1, 3, 512, 512), (1, 9176)),
    "synth_leres_sd": ("forge_tpu_torch.preprocessors.leres", "leres_apply", (1, 3, 512, 512),
                       (1, 512, 512)),
    "synth_zoe_sd": ("forge_tpu_torch.preprocessors.zoe", "zoe_apply", (2, 3, 512, 512),
                     (2, 512, 512)),
    "synth_anime_face_sd": ("forge_tpu_torch.preprocessors.anime_face", "anime_face_apply",
                            (1, 3, 512, 512), (1, 7, 512, 512)),
    "synth_lama_sd": ("forge_tpu_torch.preprocessors.lama", "lama_apply", (1, 4, 256, 256),
                      (1, 3, 256, 256)),
}


@pytest.mark.parametrize("fn", list(NETS))
def test_network_at_published_width_calls_no_kernel(kernels, fn):
    import importlib

    from forge_tpu_torch.core import synth_annotators

    flash, conv = kernels
    mod, forward, shape, out_shape = NETS[fn]
    tree = meta_tree(getattr(synth_annotators, fn)(fill="zeros"))
    with torch.no_grad():
        out = getattr(importlib.import_module(mod), forward)(tree, _meta(shape))
    assert tuple(out.shape) == out_shape
    assert not flash and not conv


def test_uniformer_and_clip_at_published_widths(kernels):
    from forge_tpu_torch.core.synth_annotators import (synth_clip_interrogator_sd,
                                                       synth_uniformer_sd)
    from forge_tpu_torch.models.clip import clip_pooled_projection, clip_text_apply
    from forge_tpu_torch.models.clipvision import clip_vision_apply
    from forge_tpu_torch.preprocessors.uniformer import upernet_apply, uniformer_features

    flash, conv = kernels
    tree = meta_tree(synth_uniformer_sd(fill="zeros"))
    with torch.no_grad():
        feats = uniformer_features(tree["backbone"], _meta((1, 3, 512, 512)))
        logits = upernet_apply(tree["decode_head"], feats)
        clip = meta_tree(synth_clip_interrogator_sd(fill="zeros"))
        projected, _, _ = clip_vision_apply(clip, _meta((1, 3, 224, 224)))
        _, _, pooled = clip_text_apply(clip, torch.zeros((256, 77), dtype=torch.int64,
                                                         device="meta"))
        text = clip_pooled_projection(clip, pooled)
    assert [tuple(f.shape[1:]) for f in feats] == [(64, 128, 128), (128, 64, 64), (320, 32, 32),
                                                   (512, 16, 16)]
    assert tuple(logits.shape) == (1, 150, 128, 128)
    assert tuple(projected.shape) == (1, 768) and tuple(text.shape) == (256, 768)
    assert not flash and not conv


def test_phase_23_counts():
    import chip_smoke

    for steps in (4, 20):
        counts = chip_smoke.interrogate_counts(steps)
        cn = chip_smoke.surface_counts(steps)["ControlNetScript"]
        assert counts["witness"] == chip_smoke.surface_counts(steps)["witness"]
        assert counts["ControlNetScript"] == dict(cn, flash_attention=cn["flash_attention"] + 202,
                                                  gn_silu_conv3x3=cn["gn_silu_conv3x3"] + 928)
        assert chip_smoke.marigold_counts(steps) == {"flash_attention": 10 * steps + 2,
                                                     "gn_silu_conv3x3": 44 * steps + 48}
        assert counts["caption"]["flash_attention"] == counts["API clip"]["flash_attention"] == 12
        assert not any(counts["API deepbooru"].values())
    assert set(chip_smoke.INTERROGATE_ANNOTATORS) == {
        "depth_leres", "depth_zoe", "depth_marigold", "seg_ufade20k", "seg_anime_face",
        "inpaint_only+lama"}

"""chip_smoke's phase 18 at full width, traced on the meta device (no
memory): reference-only's recording pass (batch 1) and CFG pass (batch 2)
for each module, every flash call by query shape and key length and every
fused conv by size on the tensor-core body, each a shape phase 2 times; the
full-width FaceID, FaceID-Plus v2 and InstantID adapters' tokens and hooks
on the SDXL UNet (their attentions plain); InstantID's cldm (config 3's)
reading the 16 face tokens; and the launch counts chip_smoke expects a
request."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import pytest

torch = pytest.importorskip("torch")

from collections import Counter  # noqa: E402

from test_torch_serving import _meta, meta_sdxl_engine  # noqa: E402


@pytest.fixture(scope="module")
def engine():
    return meta_sdxl_engine()


def _meta_tree(sd):
    from forge_tpu_torch.core.convert import nest

    return nest({k: _meta(v.shape) for k, v in sd.items()})


def _tracing(mp):
    """Flash and the fused conv replaced by recorders → the record."""
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body

    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    mp.setattr(attention_mod, "flash_attention", flash)
    mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
    return calls


def _forward(engine, batch, hooks=None, control=None, context=77):
    from forge_tpu_torch.models.unet import unet_apply

    out = unet_apply(engine.loaded.unet, _meta((batch, 4, 128, 128)),
                     torch.zeros((batch,), device="meta"), _meta((batch, context, 2048)),
                     y=_meta((batch, 2816)), cfg=engine.unet_cfg, hooks=hooks, control=control)
    assert tuple(out.shape) == (batch, 4, 128, 128)


def _timed():
    import chip_smoke

    return ({(shape, lk) for shape, lk, _ in chip_smoke.FLASH_SHAPES},
            {(shape, o) for shape, o in chip_smoke.GN_CONV_SHAPES})


@pytest.mark.parametrize("module", ["reference_only", "reference_adain", "reference_adain+attn"])
def test_reference_step_shapes(engine, module):
    """One in-window step at weight 1.0 (every SDXL attention of 640 or 1280
    channels records): the recording forward at batch 1, then the CFG
    forward at [cond, uncond], whose self-attentions with the recorded keys
    run three times each."""
    from forge_tpu_torch.pipeline.reference_only import ReferenceState, build_reference_hooks

    state = ReferenceState(latent=_meta((1, 4, 128, 128)), style_fidelity=0.125, weight=1.0,
                           use_attn=module != "reference_adain", use_adain="adain" in module)
    capture, consume = build_reference_hooks(state, None, 1, False)
    with pytest.MonkeyPatch.context() as mp:
        calls = _tracing(mp)
        _forward(engine, 1, capture)
        recorded = len(calls["flash"]), len(calls["conv"])
        _forward(engine, 2, consume)
    assert recorded == (70, 34) and len(calls["conv"]) == 68
    flash = Counter((shape, lk) for shape, lk, _ in calls["flash"])
    own = {((1, 10, 4096, 64), 4096): 10, ((1, 20, 1024, 64), 1024): 60}
    if state.use_attn:
        want = Counter({((1, 10, 4096, 64), 8192): 20, ((1, 20, 1024, 64), 2048): 120,
                        ((1, 10, 4096, 64), 4096): 20, ((1, 20, 1024, 64), 1024): 120})
    else:
        want = Counter({((2, 10, 4096, 64), 4096): 10, ((2, 20, 1024, 64), 1024): 60, **own})
    assert flash == want and sum(want.values()) == (280 if state.use_attn else 140)
    assert all(body == "wgmma" for *_, body in calls["flash"] + calls["conv"])
    timed_flash, timed_conv = _timed()
    assert set(flash) <= timed_flash
    assert {(shape, o) for shape, o, _ in calls["conv"]} <= timed_conv


def _full_width(name):
    from forge_tpu_torch.core import synth
    from forge_tpu_torch.core.synth import DeviceFill

    fill = DeviceFill("cpu")
    return {"faceid": lambda: synth.synth_faceid_sd(fill=fill),
            "faceid_plus": lambda: synth.synth_faceid_sd(plus=True, fill=fill),
            "instantid": lambda: synth.synth_instantid_sd(fill=fill),
            "vit_h": lambda: synth.synth_clip_vision_sd(fill=fill),
            "bigG": lambda: synth.synth_clip_vision_sd(width=1664, layers=48, mlp=8192,
                                                       projection=1280, fill=fill),
            "photomaker": lambda: synth.synth_photomaker_sd(fill=fill),
            "cldm": lambda: synth.synth_controlnet_sd(fill=fill)}[name]()


def test_full_width_image_prompt_weights():
    """The published shapes chip_smoke makes on the card, by shape (nothing
    is made): FaceID SDXL's MLP 512 → 1024 → 4 × 2048 and its 70 layers
    numbered 0–69; FaceID-Plus v2's perceiver (2048 wide, 4 layers) over
    ViT-H's 1280; InstantID's Resampler (1280, 4 layers, 16 queries, 512 in,
    2048 out); CLIP-ViT-bigG/14 (1664, 48 layers, projection 1280);
    PhotoMaker's ViT-L/14 id encoder and its fuse at 2048."""
    sd = _full_width("faceid")
    assert sd["image_proj.proj.0.weight"].shape == (1024, 512)
    assert sd["image_proj.proj.2.weight"].shape == (4 * 2048, 1024)
    assert sd["ip_adapter.69.to_k_ip.weight"].shape == (640, 2048)
    assert "ip_adapter.70.to_k_ip.weight" not in sd
    plus = _full_width("faceid_plus")
    assert plus["image_proj.perceiver_resampler.proj_in.weight"].shape == (2048, 1280)
    assert plus["image_proj.perceiver_resampler.layers.3.0.to_kv.weight"].shape == (4096, 2048)
    iid = _full_width("instantid")
    assert iid["image_proj.latents"].shape == (1, 16, 1280)
    assert iid["image_proj.proj_in.weight"].shape == (1280, 512)
    assert iid["image_proj.proj_out.weight"].shape == (2048, 1280)
    assert iid["ip_adapter.139.to_v_ip.weight"].shape == (640, 2048)
    big = _full_width("bigG")
    assert big["vision_model.embeddings.position_embedding.weight"].shape == (257, 1664)
    assert big["visual_projection.weight"].shape == (1280, 1664)
    assert 1.84e9 < sum(v.size for v in big.values()) < 1.85e9
    pm = _full_width("photomaker")
    patch = pm["id_encoder.vision_model.embeddings.patch_embedding.weight"]
    assert patch.shape == (1024, 3, 14, 14)
    assert pm["id_encoder.visual_projection.weight"].shape == (2048, 1024)
    assert pm["id_encoder.fuse_module.mlp1.0.weight"].shape == (2048, 4096)


@pytest.mark.parametrize("name", ["faceid", "faceid_plus", "instantid"])
def test_full_width_adapter_forward(engine, name):
    """The adapter's tokens from a 512-d face embedding (FaceID-Plus's
    perceiver over ViT-H's 257 hidden states), then one CFG forward with its
    hooks: every IP attention plain (4 or 16 keys), the UNet's 70 flash and
    34 convs as the witness's; InstantID's cldm reading the tokens."""
    from forge_tpu_torch.models.controlnet import ControlNetState, run_controlnets
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline import ipadapter

    tree = _meta_tree(_full_width(name))
    face = _meta((1, 512))
    with pytest.MonkeyPatch.context() as mp:
        calls = _tracing(mp)
        if name == "instantid":
            cldm = ControlNetState(params=_meta_tree(_full_width("cldm")),
                                   hint=_meta((1, 3, 1024, 1024)),
                                   cfg=UNetConfig(context_dim=2048, head_dim=64))
            hooks, cldm = ipadapter.build_instantid(tree, face, controlnet_state=cldm)
            assert tuple(cldm.context_override.shape) == (2, 16, 2048)
            ctrl = run_controlnets([cldm], _meta((2, 4, 128, 128)),
                                   torch.zeros((2,), device="meta"), 0.5, _meta((2, 77, 2048)),
                                   y=_meta((2, 2816)))
            assert (len(calls["flash"]), len(calls["conv"])) == (34, 16)
        else:
            clip = _meta((1, 257, 1280)) if name == "faceid_plus" else None
            tokens = ipadapter.project_faceid_embeds(tree, face, clip, shortcut=clip is not None)
            assert tuple(tokens.shape) == (1, 4, 2048)
            hooks = ipadapter.IPAdapterState(tree, tokens, 0.8, uncond_tokens=tokens).build_hooks()
            ctrl = None
        _forward(engine, 2, hooks, control=ctrl)
    n_flash, n_conv = (104, 50) if name == "instantid" else (70, 34)
    assert (len(calls["flash"]), len(calls["conv"])) == (n_flash, n_conv)
    assert all(body == "wgmma" for *_, body in calls["flash"] + calls["conv"])


def test_chip_smoke_counts_a_request():
    import chip_smoke

    counts = chip_smoke.image_prompt_counts(4)
    plain = {"flash_attention": 281, "gn_silu_conv3x3": 164, "dequant_matmul": 0}
    for label in ("witness", "FaceID", "FaceID-Plus v2", "Revision", "PhotoMaker witness",
                  "PhotoMaker"):
        assert counts[label] == plain
    two_pass = {"flash_attention": 280 * 4 + 2, "gn_silu_conv3x3": 68 * 4 + 48,
                "dequant_matmul": 0}
    for label in ("reference_only", "reference_adain+attn", "API", "API twin"):
        assert counts[label] == two_pass
    assert counts["reference_adain"] == {"flash_attention": 140 * 4 + 2,
                                         "gn_silu_conv3x3": 68 * 4 + 48, "dequant_matmul": 0}
    assert counts["InstantID"] == {"flash_attention": 104 * 4 + 1, "gn_silu_conv3x3": 50 * 4 + 28,
                                   "dequant_matmul": 0}
    assert chip_smoke.image_prompt_counts(20)["reference_only"]["flash_attention"] == 5602

"""chip_smoke's phase 17 at full width, traced on the meta device (no
memory): one SDXL forward at 2048² with Deep Shrink's hooks (Forge's
defaults) and one without, every flash call by shape and every fused conv
by size on the tensor-core body, each a shape phase 2 times; an SDXL
T2I-Adapter in chip_smoke's layout, its features on the UNet's input slots
3, 5 and 8 and the middle block at 1024²; and the launch counts chip_smoke
expects a request."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import pytest

torch = pytest.importorskip("torch")

from collections import Counter  # noqa: E402

from test_torch_serving import _meta, meta_sdxl_engine  # noqa: E402


@pytest.fixture(scope="module")
def engine():
    return meta_sdxl_engine()


def _trace(engine, size, hooks=None, control=None):
    from forge_tpu_torch.models.unet import unet_apply
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body

    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    side = size // 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        out = unet_apply(engine.loaded.unet, _meta((2, 4, side, side)),
                         torch.zeros((2,), device="meta"), _meta((2, 77, 2048)),
                         y=_meta((2, 2816)), cfg=engine.unet_cfg, hooks=hooks, control=control)
    assert tuple(out.shape) == (2, 4, side, side)
    return calls


def test_deep_shrink_forward_shapes(engine):
    import chip_smoke
    from forge_tpu_torch.extensions.kohya_hrfix import build_kohya_hooks

    kw = {k: v for k, v in chip_smoke.CONTROLS_SHRINK.items() if k != "end_percent"}
    timed_flash = {shape for shape, _, _ in chip_smoke.FLASH_SHAPES}
    timed_conv = {(shape, o) for shape, o in chip_smoke.GN_CONV_SHAPES}
    size = chip_smoke.CONTROLS_SHRINK_SIZE
    for hooks, want in ((build_kohya_hooks(**kw), chip_smoke.CONTROLS_SHRUNK_SHAPES),
                        (None, chip_smoke.CONTROLS_FULL_SHAPES)):
        calls = _trace(engine, size, hooks)
        assert Counter(shape for shape, _ in calls["flash"]) == want
        assert len(calls["conv"]) == 34
        assert all(body == "wgmma" for *_, body in calls["flash"] + calls["conv"])
        assert {shape for shape, _ in calls["flash"]} <= timed_flash
        assert {(shape, o) for shape, o, _ in calls["conv"]} <= timed_conv
    shrunk = _trace(engine, size, build_kohya_hooks(**kw))
    assert {(shape, o) for shape, o, _ in shrunk["conv"]} >= {
        (shape, o) for shape, o in chip_smoke.CONTROLS_CONV_SHAPES}
    assert {shape for shape, _, _ in chip_smoke.CONTROLS_FLASH_SHAPES} == set(
        chip_smoke.CONTROLS_SHRUNK_SHAPES) | set(chip_smoke.CONTROLS_FULL_SHAPES)


def test_t2i_xl_adapter_feeds_the_sdxl_unet(engine):
    """chip_smoke's SDXL adapter (made on the CPU here, then taken to meta):
    config, feature slots and shapes, and one UNet forward that adds them."""
    import chip_smoke
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.models.t2i_adapter import adapter_apply, detect_adapter_config

    sd = chip_smoke.synth_t2i_xl_sd(torch.Generator().manual_seed(0))
    tree = nest({k: _meta(v.shape) for k, v in sd.items()})
    cfg = detect_adapter_config(tree)
    assert (cfg.channels, cfg.nums_rb, cfg.xl) == (chip_smoke.CONTROLS_T2I_CHANNELS, 2, True)
    feats = adapter_apply(tree, _meta((1, 3, 1024, 1024)), cfg)
    got = {i: tuple(f.shape) for i, f in enumerate(feats["input"]) if f is not None}
    assert got == {3: (1, 320, 64, 64), 5: (1, 640, 64, 64), 8: (1, 1280, 32, 32)}
    assert [tuple(f.shape) for f in feats["middle"]] == [(1, 1280, 32, 32)]
    control = {kind: [None if f is None else f.expand((2,) + tuple(f.shape[1:])) for f in fs]
               for kind, fs in feats.items()}
    calls = _trace(engine, 1024, control=control)
    assert len(calls["flash"]) == 70 and len(calls["conv"]) == 34


def test_chip_smoke_counts_a_request():
    import chip_smoke

    shrunk, counts = chip_smoke.controls_counts(10)
    assert shrunk == 4 and chip_smoke.controls_counts(20)[0] == 7
    plain = {"flash_attention": 701, "gn_silu_conv3x3": 368, "dequant_matmul": 0}
    for label in ("shrink witness", "Deep Shrink", "txt2img witness", "T2I-Adapter",
                  "latent modifier"):
        assert counts[label] == plain
    assert counts["Control-LoRA"] == {"flash_attention": 1041, "gn_silu_conv3x3": 528,
                                      "dequant_matmul": 0}
    assert counts["Fooocus inpaint"] == {"flash_attention": 703, "gn_silu_conv3x3": 408,
                                         "dequant_matmul": 0}
    assert counts["inpaint_only"] == {"flash_attention": 7 * 104 + 3,
                                      "gn_silu_conv3x3": 7 * 50 + 68, "dequant_matmul": 0}

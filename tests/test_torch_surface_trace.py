"""chip_smoke's phase 21 at full width, traced on the meta device (no
memory): the merged checkpoints of the whole run, SDXL's widths at cut
depths (chip_smoke.SURFACE_CUT), are an SDXL checkpoint every key of which
the published layout has at the same shape, and one UNet forward of it
makes 11 flash calls (at shapes phase 2 times) and SDXL's 34 fused convs,
all on the tensor-core body; and the launch counts chip_smoke expects a
request, composed from the traced parts: a UNet forward (70 flash, 34
conv), the ControlNet's beside it (34, 16; tests/test_torch_controlnet.py),
the 1024² decode (1, 28) and the merged UNet's forward."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import pytest

torch = pytest.importorskip("torch")

from collections import Counter  # noqa: E402

from test_torch_controlnet import config3_calls  # noqa: E402
from test_torch_serving import _meta  # noqa: E402

DECODE = {"flash_attention": 1, "gn_silu_conv3x3": 28}  # the 1024² decode (test_torch_sdxl.py)


@pytest.fixture(scope="module")
def cut_checkpoint():
    import chip_smoke
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_checkpoint

    return synth_sdxl_checkpoint(fill=DeviceFill("cpu"), **chip_smoke.SURFACE_CUT)


def test_cut_checkpoint_keeps_the_widths(cut_checkpoint):
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_checkpoint

    full = synth_sdxl_checkpoint(fill=DeviceFill("cpu"))
    assert all(k in full and full[k].shape == v.shape for k, v in cut_checkpoint.items())
    g = guess.guess(cut_checkpoint)
    assert (g.family, g.context_dim) == ("sdxl", 2048)
    assert set(g.text_encoders) == {"clip_l", "open_clip_g"}
    blocks = {k.split(".resblocks.")[1].split(".")[0] for k in g.text_encoders["open_clip_g"]
              if ".resblocks." in k}
    assert blocks == {"0", "1"}


def test_merged_unet_forward(cut_checkpoint):
    import chip_smoke
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.models import unet as unet_mod
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body

    g = guess.guess(cut_checkpoint)
    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        out = unet_mod.unet_apply(nest({k: _meta(v.shape) for k, v in g.unet.items()}),
                                  _meta((2, 4, 128, 128)), torch.zeros((2,), device="meta"),
                                  _meta((2, 77, 2048)), y=_meta((2, 2816)),
                                  cfg=unet_mod.UNetConfig.for_family("sdxl"))
    assert tuple(out.shape) == (2, 4, 128, 128)
    assert Counter(shape for shape, _ in calls["flash"]) == {(2, 10, 4096, 64): 5,
                                                              (2, 20, 1024, 64): 6}
    assert len(calls["conv"]) == 34
    assert all(body == "wgmma" for *_, body in calls["flash"] + calls["conv"])
    assert {shape for shape, _ in calls["flash"]} <= {s for s, _, _ in chip_smoke.FLASH_SHAPES}
    assert {(shape, o) for shape, o, _ in calls["conv"]} <= {
        (s, o) for s, o in chip_smoke.GN_CONV_SHAPES}
    blocks = sum(1 for k in cut_checkpoint if k.startswith("model.diffusion_model.")
                 and k.endswith(".attn1.to_q.weight"))
    assert blocks == len(calls["flash"]) == 11


@pytest.mark.parametrize("steps", [4, 20])
def test_surface_counts(steps):
    import chip_smoke

    calls = config3_calls()
    cn = {"flash_attention": len(calls["flash"][0]), "gn_silu_conv3x3": len(calls["conv"][0])}
    unet = {"flash_attention": len(calls["flash"][1]), "gn_silu_conv3x3": len(calls["conv"][1])}
    merged = {"flash_attention": 11, "gn_silu_conv3x3": unet["gn_silu_conv3x3"]}

    def request(*forwards):
        return {k: steps * sum(f[k] for f in forwards) + DECODE[k] for k in DECODE} | {
            "dequant_matmul": 0}

    want = {"witness": request(unet), "ControlNetScript": request(unet, cn),
            "alwayson": request(unet, cn), "saving": request(unet, cn),
            "embedding": request(unet), "merged": request(merged)}
    assert chip_smoke.surface_counts(steps, 11) == want
    assert chip_smoke.surface_counts(steps)["merged"] == want["witness"]

"""chip_smoke's phase 22 at full width, traced on the meta device (no
memory): every annotator network at its published widths
(core/synth_annotators.py) runs one forward at the feed a 512² image gives
it, with the output shape its detector expects; Depth Anything V2's ViT-L/14
makes exactly 24 flash calls at q(1,16,1370,64) (bf16: the tensor-core
body) and no other network calls a kernel; phase 22 (c)'s counts are phase
21's ControlNet request and the annotator's 24.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import pytest

torch = pytest.importorskip("torch")

from test_torch_extras_trace import meta_tree  # noqa: E402

NETS = {  # synth function → (module, forward, input shape, output shape or shapes)
    "synth_depth_anything_sd": ("depth_anything", "depth_anything_apply", (1, 3, 518, 518),
                                (1, 518, 518)),
    "synth_midas_sd": ("depth", "dpt_apply", (1, 3, 384, 384), (1, 384, 384)),
    "synth_openpose_body_sd": ("openpose", "body_apply", (1, 3, 184, 184),
                               [(1, 38, 23, 23), (1, 19, 23, 23)]),
    "synth_openpose_hand_sd": ("openpose", "hand_apply", (1, 3, 368, 368), (1, 22, 46, 46)),
    "synth_openpose_face_sd": ("openpose", "face_apply", (1, 3, 384, 384), (1, 71, 48, 48)),
    "synth_hed_sd": ("hed", "hed_apply", (1, 3, 512, 512),
                     [(1, 1, 512 >> i, 512 >> i) for i in range(5)]),
    "synth_pidinet_sd": ("pidinet", "pidinet_apply", (1, 3, 512, 512), (1, 1, 512, 512)),
    "synth_teed_sd": ("teed", "teed_apply", (1, 3, 512, 512), (1, 512, 512)),
    "synth_lineart_sd": ("lineart", "lineart_apply", (1, 3, 512, 512), (1, 1, 512, 512)),
    "synth_lineart_anime_sd": ("lineart", "lineart_anime_apply", (1, 3, 512, 512),
                               (1, 1, 512, 512)),
    "synth_manga_line_sd": ("manga_line", "manga_line_apply", (1, 1, 512, 512),
                            (1, 1, 512, 512)),
    "synth_mlsd_sd": ("mlsd", "mlsd_apply", (1, 4, 512, 512), (1, 9, 256, 256)),
    "synth_normalbae_sd": ("normalbae", "normalbae_apply", (1, 3, 512, 512), (1, 4, 512, 512)),
}


@pytest.mark.parametrize("fn", list(NETS))
def test_annotator_at_published_width_on_meta(fn, monkeypatch):
    import importlib

    from forge_tpu_torch.core import synth_annotators
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.preprocessors.pidinet import convert_pidinet_sd

    mod, forward, shape, out_shape = NETS[fn]
    sd = getattr(synth_annotators, fn)(fill="zeros")
    if mod == "pidinet":
        sd = convert_pidinet_sd(sd)
    calls = []

    def flash(q, k, v, scale=None, body=None):
        calls.append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    monkeypatch.setattr(attention_mod, "flash_attention", flash)
    apply = getattr(importlib.import_module(f"forge_tpu_torch.preprocessors.{mod}"), forward)
    with torch.no_grad():
        out = apply(meta_tree(sd), torch.empty(shape, device="meta", dtype=torch.bfloat16))
    shapes = [tuple(o.shape) for o in out] if isinstance(out, (list, tuple)) else tuple(out.shape)
    assert shapes == out_shape
    if mod == "depth_anything":
        assert calls == [((1, 16, 1370, 64), 1370, "wgmma")] * 24
    else:
        assert calls == []


def test_phase_22_counts():
    import chip_smoke

    for steps in (4, 20):
        counts = chip_smoke.annotators_counts(steps)
        cn = chip_smoke.surface_counts(steps)["ControlNetScript"]
        assert counts["witness"] == chip_smoke.surface_counts(steps)["witness"]
        assert counts["ControlNetScript"] == dict(cn, flash_attention=cn["flash_attention"] + 24)
    assert chip_smoke.ANNOTATOR_FLASH == 24
    assert ((1, 16, 1370, 64), 1370, True) in chip_smoke.FLASH_SHAPES
    assert set(chip_smoke.ANNOTATORS) | set(chip_smoke.ANNOTATOR_VARIANTS) <= {
        n for n in __import__("forge_tpu_torch.preprocessors", fromlist=["x"]).preprocessor_names()}

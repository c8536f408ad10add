"""chip_smoke's phase 19 at full width, traced on the meta device (no
memory): a model call of each request kind (txt2img and img2img at 1024²,
the outpaintings' 1280² canvas, soft inpainting's masked call, the img2img
alternative test's two uncombined batch-1 applies) and the VAE's decode and
encode at 1024² and 1280², every flash call and fused conv on the
tensor-core body and at a shape phase 2 times; and the launch counts
chip_smoke expects a run, composed from those parts."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_serving import _meta, meta_sdxl_engine  # noqa: E402

F32 = torch.float32


@pytest.fixture(scope="module")
def parts():
    """part → {"flash": [(q shape, Lk, body)], "conv": [(x shape, O, body)]}."""
    from forge_tpu_torch.extensions.soft_inpainting import SoftInpaintingSettings
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.selectable_scripts import _cfg_apply

    engine = meta_sdxl_engine()
    calls = {}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    def cond(b):
        return {"context": _meta((b, 77, 2048)), "y": _meta((b, 2816))}

    def one_call(p, x, **kw):
        job = proc.Job(p, x, np.array([14.6, 0.0], np.float32), None, cond(x.shape[0]),
                       cond(x.shape[0]), engine.loaded.unet, **kw)
        return proc.denoise(engine, job)

    def request(side, **kw):
        return proc.Processing(width=side, height=side, cfg_scale=7.0, sampler_name="DPM++ 2M",
                               **kw)

    latent = {1024: _meta((1, 4, 128, 128), F32), 1280: _meta((1, 4, 160, 160), F32)}
    runs = {
        "call 1024": lambda: one_call(request(1024), latent[1024]),
        "call 1280": lambda: one_call(request(1280), latent[1280]),
        "soft call": lambda: one_call(request(1024, soft_inpainting=SoftInpaintingSettings()),
                                      latent[1024], mask=_meta((1, 1, 128, 128), F32),
                                      init_latent=latent[1024]),
        "alt applies": lambda: _cfg_apply(engine, cond(1), cond(1), 7.0)(latent[1024], 14.6),
        "decode 1024": lambda: engine.decode_dispatch(latent[1024]),
        "encode 1024": lambda: engine.encode_first_stage(_meta((1, 3, 1024, 1024), F32)),
        "decode 1280": lambda: engine.decode_dispatch(latent[1280]),
        "encode 1280": lambda: engine.encode_first_stage(_meta((1, 3, 1280, 1280), F32)),
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        for name, run in runs.items():
            calls.update(flash=[], conv=[])
            run()
            out[name] = dict(calls)
    return out


def test_parts_launches_and_bodies(parts):
    """A model call is one UNet forward at CFG batch 2 (70 flash, 34 conv;
    the 1280² canvas's level-1 and level-2 attentions at 6400 and 1600
    tokens), the alternative test's step two forwards at batch 1; a decode 1 /
    28, an encode 1 / 20 (the VAE mid-block at 16384 or 25600 tokens)."""
    want = {"call 1024": (70, 34), "call 1280": (70, 34), "soft call": (70, 34),
            "alt applies": (140, 68), "decode 1024": (1, 28), "encode 1024": (1, 20),
            "decode 1280": (1, 28), "encode 1280": (1, 20)}
    assert {name: (len(c["flash"]), len(c["conv"])) for name, c in parts.items()} == want
    for c in parts.values():
        assert all(body == "wgmma" for *_, body in c["flash"] + c["conv"])
    assert {s for s, _, _ in parts["call 1280"]["flash"]} == {(2, 10, 6400, 64), (2, 20, 1600, 64)}
    assert {s for s, _, _ in parts["alt applies"]["flash"]} == {(1, 10, 4096, 64),
                                                               (1, 20, 1024, 64)}
    assert parts["decode 1280"]["flash"][0][:2] == ((1, 1, 25600, 512), 25600)


def test_every_shape_is_a_phase_2_row(parts):
    import chip_smoke

    flash = {(s, lk) for c in parts.values() for s, lk, _ in c["flash"]}
    conv = {(s, o) for c in parts.values() for s, o, _ in c["conv"]}
    assert flash <= {(s, lk) for s, lk, _ in chip_smoke.FLASH_SHAPES}
    assert conv <= set(chip_smoke.GN_CONV_SHAPES)
    rows_flash, rows_conv = chip_smoke.SCRIPTS_ROWS  # what --scripts runs: every one of them
    assert flash == {(s, lk) for s, lk, _ in rows_flash}
    assert conv == set(rows_conv)


def test_chip_smoke_counts_a_run(parts):
    """scripts_counts(4), composed from the parts: a txt2img request 4 calls
    and a decode; an img2img request t_enc + 1 calls (strength 0.5: 3, 0.4:
    2, 0.75: 4, config 3's 0.6: 3), its encodes (two for "fill") and a
    decode; the alternative test 4 + 4 steps of two applies."""
    import chip_smoke

    def n(*names_times):
        flash = sum(k * len(parts[name]["flash"]) for name, k in names_times)
        conv = sum(k * len(parts[name]["conv"]) for name, k in names_times)
        return {"flash_attention": flash, "gn_silu_conv3x3": conv, "dequant_matmul": 0}

    def times(k, c):
        return {name: k * v for name, v in c.items()}

    txt = n(("call 1024", 4), ("decode 1024", 1))
    counts = chip_smoke.scripts_counts(4)
    for label in ("script witness", "recording script"):
        assert counts[label] == txt
    for label in ("X/Y/Z grid", "prompt matrix", "API prompt matrix", "API X/Y/Z grid"):
        assert counts[label] == times(4, txt)
    assert counts["prompts from textbox"] == n(("call 1024", 4 + 2), ("decode 1024", 2))
    assert counts["loopback"] == times(2, n(("call 1024", 3), ("encode 1024", 1),
                                            ("decode 1024", 1)))
    assert counts["SD upscale"] == times(9, n(("call 1024", 2), ("encode 1024", 1),
                                              ("decode 1024", 1)))
    assert counts["poor man's outpainting"] == n(("call 1280", 4), ("encode 1280", 2),
                                                 ("decode 1280", 1))
    assert counts["outpainting mk2"] == n(("call 1280", 4), ("encode 1280", 1),
                                          ("decode 1280", 1))
    assert counts["img2img alternative test"] == n(("alt applies", 8), ("encode 1024", 1),
                                                   ("decode 1024", 1))
    assert counts["soft inpainting"] == counts["inpaint witness"] == n(
        ("soft call", 3), ("encode 1024", 1), ("decode 1024", 1))
    assert chip_smoke.scripts_counts(20)["SD upscale"]["flash_attention"] == 9 * (70 * 9 + 2)


def test_chip_smoke_imports_no_jax_pil_or_cv2():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, chip_smoke\n"
            "import forge_tpu_torch.api.server, forge_tpu_torch.pipeline.selectable_scripts\n"
            "import forge_tpu_torch.extensions.xyz_grid, forge_tpu_torch.extensions.soft_inpainting\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'forge_tpu', 'PIL', 'cv2')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr

"""chip_smoke's phase 20 at full width, traced on the meta device (no
memory): the four upscalers and the two face restorers at their published
widths (core/synth.py) each run one forward and call neither kernel, while
the SDXL request phase 20 restores is its witness's UNet calls and decode,
and config 2 (c)'s hires pass through SwinIR is config 2 (c)'s; the launch
counts chip_smoke expects a run, composed from those parts, and phase 2
rows at every shape they take: the whole run's at (c)'s, `--extras`' at
(d)'s too (the 2048² VAE's five middle sizes are held there only)."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_serving import _meta, meta_sdxl_engine  # noqa: E402

F32 = torch.float32


def meta_tree(sd):
    """A synth state dict's nested tree of meta tensors: floating weights in
    bf16, index buffers int64."""
    from forge_tpu_torch.core.convert import nest

    def integer(v):
        return isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.integer)

    return nest({k: _meta(v.shape, torch.int64 if integer(v) else torch.bfloat16)
                 for k, v in sd.items()})


def meta_tree_flat(sd):
    from forge_tpu_torch.core.convert import flatten

    return flatten(meta_tree(sd))


NETWORKS = {  # synth function → (forward, input shape, output shape)
    "synth_swinir_sd": ("swinir", (1, 3, 192, 192), (1, 3, 768, 768)),
    "synth_hat_sd": ("hat", (1, 3, 192, 192), (1, 3, 768, 768)),
    "synth_dat_sd": ("dat", (1, 3, 192, 192), (1, 3, 768, 768)),
    "synth_scunet_sd": ("scunet", (1, 3, 192, 192), (1, 3, 192, 192)),
    "synth_codeformer_sd": ("codeformer", (1, 3, 512, 512), (1, 3, 512, 512)),
    "synth_gfpgan_sd": ("gfpgan", (1, 3, 512, 512), (1, 3, 512, 512)),
}


@pytest.fixture(scope="module")
def recorder():
    """(calls, a context that swaps both kernel wrappers for recorders)."""
    import contextlib

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

    @contextlib.contextmanager
    def recording():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(attention_mod, "flash_attention", flash)
            mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
            calls.update(flash=[], conv=[])
            yield calls

    return recording


@pytest.mark.parametrize("fn", list(NETWORKS))
def test_networks_launch_no_kernel(recorder, fn):
    from forge_tpu_torch.core import synth
    from forge_tpu_torch.core.synth import DeviceFill
    from forge_tpu_torch.models import codeformer, dat, hat, scunet, swinir
    from forge_tpu_torch.postprocessing import gfpgan
    from forge_tpu_torch.pipeline.upscalers import sniff_architecture

    arch, shape, out_shape = NETWORKS[fn]
    sd = getattr(synth, fn)(fill=DeviceFill("cpu"))
    x = _meta(shape)
    with recorder() as calls:
        if arch == "codeformer":
            y = codeformer.codeformer_apply(codeformer.load_codeformer(meta_tree(sd)), x)
        elif arch == "gfpgan":
            y = gfpgan.gfpgan_apply(meta_tree(sd), x)
        else:
            mod = {"swinir": swinir, "hat": hat, "dat": dat, "scunet": scunet}[arch]
            params = getattr(mod, f"load_{arch}")(meta_tree_flat(sd))
            meta = getattr(mod, f"infer_{arch}_meta")(params)
            assert sniff_architecture(sd) == {"swinir": "SwinIR", "hat": "HAT", "dat": "DAT",
                                              "scunet": "SCUNet"}[arch]
            y = getattr(mod, f"{arch}_apply")(params, x, **meta)
        assert tuple(y.shape) == out_shape
        assert calls == {"flash": [], "conv": []}


@pytest.fixture(scope="module")
def parts(recorder):
    """part → {"flash": [...], "conv": [...]} of phase 20's SDXL requests."""
    from forge_tpu_torch.pipeline import processing as proc

    engine = meta_sdxl_engine()

    def cond(b):
        return {"context": _meta((b, 77, 2048)), "y": _meta((b, 2816))}

    def one_call(side, x):
        p = proc.Processing(width=side, height=side, cfg_scale=7.0, sampler_name="DPM++ 2M")
        job = proc.Job(p, x, np.array([14.6, 0.0], np.float32), None, cond(x.shape[0]),
                       cond(x.shape[0]), engine.loaded.unet)
        return proc.denoise(engine, job)

    runs = {
        "call 1024": lambda: one_call(1024, _meta((1, 4, 128, 128), F32)),
        "decode 1024": lambda: engine.decode_dispatch(_meta((1, 4, 128, 128), F32)),
        "call 2048": lambda: one_call(2048, _meta((1, 4, 256, 256), F32)),
        "encode 2048": lambda: engine.encode_first_stage(_meta((1, 3, 2048, 2048), F32)),
        "decode 2048": lambda: engine.decode_dispatch(_meta((1, 4, 256, 256), F32)),
    }
    out = {}
    for name, run in runs.items():
        with recorder() as calls:
            run()
            out[name] = {k: list(v) for k, v in calls.items()}
    return out


def test_chip_smoke_counts_a_run(parts):
    """extras_counts(4) and (20), composed from the parts: the restored
    request and its witness the calls and a decode each; config 2 (c)'s
    pixel pass SDXL_STEPS (14) calls at 1024², the decode, the 2048² encode,
    CONFIG2_HIRES_CALLS (10) calls at 2048² and its decode, through either upscaler; the rest nothing."""
    import chip_smoke

    def n(*names_times):
        return {"flash_attention": sum(k * len(parts[p]["flash"]) for p, k in names_times),
                "gn_silu_conv3x3": sum(k * len(parts[p]["conv"]) for p, k in names_times),
                "dequant_matmul": 0}

    for steps in (4, 20):
        counts = chip_smoke.extras_counts(steps)
        txt = n(("call 1024", steps), ("decode 1024", 1))
        assert counts["restore_faces"] == counts["restore witness"] == txt
        for label in ("upscalers", "restorers", "API"):
            assert counts[label] == n()
        hires = n(("call 1024", chip_smoke.SDXL_STEPS), ("decode 1024", 1), ("encode 2048", 1),
                  ("call 2048", chip_smoke.CONFIG2_HIRES_CALLS), ("decode 2048", 1))
        assert counts["hires SwinIR"] == counts["hires ESRGAN"] == hires
    assert chip_smoke.extras_counts(4)["restore_faces"] == {
        "flash_attention": 281, "gn_silu_conv3x3": 164, "dequant_matmul": 0}
    assert chip_smoke.extras_counts(20)["hires SwinIR"] == {
        "flash_attention": 1683, "gn_silu_conv3x3": 892, "dequant_matmul": 0}


def test_every_shape_is_a_phase_2_row(parts):
    import chip_smoke

    flash = {(s, lk) for c in parts.values() for s, lk, _ in c["flash"]}
    conv = {(s, o) for c in parts.values() for s, o, _ in c["conv"]}
    assert flash <= {(s, lk) for s, lk, _ in chip_smoke.FLASH_SHAPES}
    restored = {(s, o) for p in ("call 1024", "decode 1024") for s, o, _ in parts[p]["conv"]}
    assert restored <= set(chip_smoke.GN_CONV_SHAPES)  # the whole run's rows hold (c)
    rows_flash = chip_smoke.EXTRAS_ROWS[0] + chip_smoke.EXTRAS_HIRES_ROWS[0]
    rows_conv = chip_smoke.EXTRAS_ROWS[1] + chip_smoke.EXTRAS_HIRES_ROWS[1]
    assert flash == {(s, lk) for s, lk, _ in rows_flash}
    assert conv <= set(rows_conv)
    assert all(body == "wgmma" for c in parts.values() for *_, body in c["flash"] + c["conv"])

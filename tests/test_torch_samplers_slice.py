"""The port's samplers end to end against forge_tpu, and their launch counts on SDXL.

The tiny SD1.5 checkpoint (tests/fixtures.py `make_sd15_checkpoint(0)`)
goes through forge_tpu's `make_tiny_engine` and the port's `load_engine`,
then `process_images` at 64², CFG 7, seed 1 (f32 on the CPU): "DPM++ SDE"
over 5 Karras steps (second order, Brownian noise with two draws a step),
and "DPM2 a" over 5 steps with `eta_ancestral` 0.7 and `eta_noise_seed_delta`
31337 set through each package's options (the discarded penultimate σ, the
ENSD's reseeded step noise). The uint8 images must reach PSNR ≥ 40 dB
against each other, the bar of tests/test_golden_parity.py, and the port's
must repeat byte for byte.

The launch-count test traces chip_smoke's `samplers` phase at full width on
the meta device: the SDXL engine at 1024², CFG 7, with "DPM++ SDE" and
"DPM2" over 20 Karras steps (39 model calls each: no call at σ = 0), and
"UniPC" and "DDIM CFG++" over 20 steps (20 calls), beside the "DPM++ 2M"
Karras baseline (20 calls), each then decoded.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402
from test_torch_serving import _count, _meta, meta_sdxl_engine  # noqa: E402

REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
               seed=1, steps=5, width=64, height=64, cfg_scale=7.0)
CASES = {  # name: (the request's sampler fields, options set in both packages)
    "DPM++ SDE karras": (dict(sampler_name="DPM++ SDE", scheduler="karras"), {}),
    "DPM2 a under options": (dict(sampler_name="DPM2 a"),
                             {"eta_ancestral": 0.7, "eta_noise_seed_delta": 31337}),
}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def engines():
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    return make_tiny_engine(0), teng


def _port_image(teng, fields, options):
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from forge_tpu_torch.runtime.options import opts

    with opts.override(options):
        return process_images(teng, Processing(**REQUEST, **fields)).images[0]


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_slice_matches_forge_tpu(engines, case):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts

    jeng, teng = engines
    fields, options = CASES[case]
    with jopts.override(options):
        want = jproc.process_images(jeng, jproc.Processing(**REQUEST, **fields)).images[0]
    got = _port_image(teng, fields, options)
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    value = _psnr(got, want)
    print(f"{case}: PSNR {value:.2f} dB")
    assert value >= 40.0, value
    assert np.array_equal(got, _port_image(teng, fields, options))
    if options:  # the options reach the request: without them the image is another
        assert not np.array_equal(got, _port_image(teng, fields, {}))


# -- chip_smoke's samplers phase at full width, traced on the meta device -------------------

PHASE = {  # chip_smoke's requests: sampler, scheduler → model calls of 20 steps
    "DPM++ 2M": ("karras", 20),
    "DPM++ SDE": ("karras", 2 * 19 + 1),
    "DPM2": ("karras", 2 * 19 + 1),
    "UniPC": ("automatic", 1 + 19),
    "DDIM CFG++": ("automatic", 20),
}


def test_samplers_phase_launch_counts_and_bodies():
    """Each request's model calls through `prepare`'s txt2img step (σ, the
    discarded penultimate σ, the step noise: Brownian for DPM++ SDE) and
    `denoise` on the full-width SDXL engine, each call one UNet forward at
    CFG batch 2 on 128² latents; one forward traced (70 flash: 10 at 4096
    tokens, 60 at 1024; 34 convs) and the 1024² decode (1 flash, 28 convs):
    2731 flash / 1354 conv for DPM++ SDE and DPM2, 1401 / 708 for UniPC,
    DDIM CFG++ and the DPM++ 2M baseline a request, every call on the
    tensor-core body."""
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.sampling.schedules import get_sigmas

    engine = meta_sdxl_engine()
    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    cond = {"context": _meta((1, 77, 2048)), "y": _meta((1, 2816))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        p = proc.Processing(width=1024, height=1024, cfg_scale=7.0, sampler_name="DDIM CFG++")
        job = proc.Job(p, _meta((1, 4, 128, 128), torch.float32), np.array([14.6, 0.0]), None,
                       cond, cond, engine.loaded.unet)
        proc.denoise(engine, job)  # one model call: the CFG++ pair at CFG batch 2
        forward = dict(calls)
        calls.update(flash=[], conv=[])
        engine.decode_dispatch(_meta((1, 4, 128, 128), torch.float32))
        decode = dict(calls)

        unet_calls = []

        def unet(params, x, t, context, y=None):
            unet_calls.append(tuple(x.shape))
            return torch.empty_like(x)

        mp.setattr(engine, "unet_apply_fn", lambda hooks=None, controlnets=None: unet)
        for sampler, (scheduler, want_calls) in PHASE.items():
            p = proc.Processing(width=1024, height=1024, cfg_scale=7.0, steps=20, seed=1,
                                sampler_name=sampler, scheduler=scheduler)
            proc._resolve_seeds(p)
            job = proc._prep_txt2img(engine, p, [1], [1], cond, cond, engine.loaded.unet, {})
            info = proc.get_sampler(sampler)
            assert len(job.sigmas) == 21 and job.sigmas[-1] == 0
            if info.discard_next_to_last_sigma:  # 21 Karras σ less the penultimate
                full = get_sigmas("karras", 21, engine.predictor)
                assert np.array_equal(job.sigmas, np.delete(full, -2))
            assert (job.step_noise is None) == (info.noise_draws == 0)
            unet_calls.clear()
            proc.denoise(engine, job)
            assert unet_calls == [(2, 4, 128, 128)] * want_calls, (sampler, len(unet_calls))
            flash_n = want_calls * len(forward["flash"]) + len(decode["flash"])
            conv_n = want_calls * len(forward["conv"]) + len(decode["conv"])
            assert (flash_n, conv_n) == {39: (2731, 1354), 20: (1401, 708)}[want_calls], sampler

    assert _count(forward["flash"]) == {((2, 10, 4096, 64), 4096): 10,
                                        ((2, 20, 1024, 64), 1024): 60}
    assert len(forward["conv"]) == 34 and len(decode["conv"]) == 28
    assert decode["flash"] == [((1, 1, 16384, 512), 16384, "wgmma")]
    assert all(body == "wgmma" for part in (forward, decode) for kind in part.values()
               for *_, body in kind)

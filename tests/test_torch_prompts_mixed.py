"""The prompt surface's combinations forge_tpu mixes, from both sides, and the prompts phase's launches.

On the tiny SD1.5 engines of tests/test_torch_prompts_slice.py, with
forge_tpu's sampler passes recorded rather than run: (4) NGMS with prompt
editing, where forge_tpu hands its tail the sliced σ and so selects the
first variant again, and the port the second; and the combinations
forge_tpu mixes, which the port refuses: AND with the refiner (1280- and
2048-wide at full size: the tiny refiner's 64 against the tiny SDXL's 128),
regional masks under the hires fix's larger latent, and AND under a hires
prompt; AND on Flux, which fails in forge_tpu's CFG function.

The launch-count test traces chip_smoke's `prompts` phase at full width on
the meta device: SDXL at 1024², DPM++ 2M Karras, 20 steps, with the UNet's
batch 2 (editing), 3 (AND), 4 (two regions), 2 then 1 (NGMS).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_prompts_slice import REQUEST, _port, engines  # noqa: E402,F401
from test_torch_serving import _count, _meta, meta_sdxl_engine  # noqa: E402


def _record_reference_passes(mp, jproc):
    """forge_tpu's sampler passes recorded (σ, cond, branches, masks, the
    engine's context width, x's shape) and returned unrun; its decode gives
    zeros."""
    passes = []

    def run(engine, p, x, sigmas, noise, cond, uncond, skip_uncond, **kwargs):
        passes.append(dict(sigmas=np.asarray(sigmas), cond=cond, uncond=uncond,
                           skip_uncond=skip_uncond, shape=tuple(x.shape),
                           branches=getattr(p, "_cond_branches", None),
                           masks=getattr(p, "_branch_masks", None)))
        return x

    mp.setattr(jproc, "_run_sampler", run)
    mp.setattr(jproc, "_decode_to_uint8", lambda engine, latent, p=None: np.zeros(
        (latent.shape[0], latent.shape[1] * 8, latent.shape[2] * 8, 3), np.uint8))
    return passes


def test_ngms_tail_with_prompt_editing_from_both_sides(engines, monkeypatch):
    """`[cat:dog:0.5]` over 5 Karras steps (cat for steps 0-1, dog from 2),
    NGMS splitting at step 1: forge_tpu's tail gets σ[1:] and its step 2 is
    the tail's row 1, "cat" again; the port selects in the whole σ table,
    row 2, "dog" — upstream's step counter runs on through the split."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu.sampling import cfg as jcfg
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.sampling import cfg as tcfg
    from forge_tpu_torch.sampling.schedules import get_sigmas

    jeng, teng = engines
    sig = get_sigmas("karras", 5, teng.predictor)
    thr = float((sig[0] + sig[1]) / 2)
    fields = dict(REQUEST, prompt="a photo of a [cat:dog:0.5]")
    passes = _record_reference_passes(monkeypatch, jproc)
    with jopts.override({"s_min_uncond": thr}):
        jproc.process_images(jeng, jproc.Processing(**fields))
    assert [len(r["sigmas"]) for r in passes] == [2, 5] and passes[1]["skip_uncond"]

    jobs = []
    real = tproc.denoise
    monkeypatch.setattr(tproc, "denoise", lambda engine, job: jobs.append(job) or real(engine, job))
    _port(teng, dict(prompt="a photo of a [cat:dog:0.5]"), {"s_min_uncond": thr})
    assert [len(j.sigmas) for j in jobs] == [2, 5] and jobs[1].uncond is None
    assert np.array_equal(jobs[1].sigma_table, sig)

    rows = np.asarray([0, 0, 1, 1, 1], np.float32)[:, None, None]  # the variant of each step
    tail_step2 = np.float32(sig[2])
    jvariant = jcfg._select_cond({"v": jcfg.PerStep(rows)}, tail_step2, passes[1]["sigmas"])["v"]
    tvariant = tcfg._select_cond({"v": tcfg.PerStep(torch.from_numpy(rows))}, float(tail_step2),
                                 jobs[1].sigma_table)["v"]
    assert float(jvariant[0, 0]) == 0.0 and float(tvariant[0, 0]) == 1.0
    # the reference's tail cond is the per-step stack the port holds too
    assert isinstance(passes[1]["cond"]["context"], jcfg.PerStep)
    assert isinstance(jobs[1].cond["context"], tcfg.PerStep)


def test_regional_prompts_under_the_hires_fix_from_both_sides(engines, monkeypatch):
    """forge_tpu hands the hires pass the first pass's 8×8 maps for a 16×16
    latent; the port refuses."""
    from forge_tpu.pipeline import processing as jproc

    jeng, teng = engines
    fields = dict(REQUEST, prompt="a landscape", enable_hr=True, hr_scale=2.0,
                  regional_prompts=[dict(prompt="a red sky", area=(0, 0, 0.5, 1))])
    passes = _record_reference_passes(monkeypatch, jproc)
    jproc.process_images(jeng, jproc.Processing(**fields))
    assert passes[1]["shape"] == (1, 16, 16, 4)
    assert tuple(passes[1]["masks"][1].shape) == (8, 8, 1)
    with pytest.raises(NotImplementedError, match="regional prompts with the hires fix"):
        _port(teng, {k: v for k, v in fields.items() if k not in REQUEST}, {})


def test_and_under_a_hires_prompt_from_both_sides(engines, monkeypatch):
    """forge_tpu encodes the hires prompt for the cond and keeps the first
    prompt's AND branch beside it; the port refuses. Without a hires prompt
    the hires pass runs the first prompt's branches, in both."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    jeng, teng = engines
    fields = dict(REQUEST, prompt="a cat AND a red hat :0.8", enable_hr=True, hr_scale=2.0,
                  hr_prompt="a dog")
    passes = _record_reference_passes(monkeypatch, jproc)
    jproc.process_images(jeng, jproc.Processing(**fields))
    first, hires = passes
    assert hires["branches"] is first["branches"]
    assert not np.array_equal(np.asarray(hires["cond"]["context"]),
                              np.asarray(first["cond"]["context"]))
    with pytest.raises(NotImplementedError, match="AND prompts with a hires pass"):
        _port(teng, {k: v for k, v in fields.items() if k not in REQUEST}, {})
    jobs = []
    real = tproc.denoise
    monkeypatch.setattr(tproc, "denoise", lambda engine, job: jobs.append(job) or real(engine, job))
    fields.pop("hr_prompt")
    res = _port(teng, {k: v for k, v in fields.items() if k not in REQUEST}, {})
    assert res.images[0].shape == (128, 128, 3)
    assert [tuple(j.x.shape) for j in jobs] == [(1, 4, 8, 8), (1, 4, 16, 16)]
    assert jobs[1].branches is jobs[0].branches and jobs[1].weights == [1.0, 0.8]


def test_and_with_the_refiner_from_both_sides(monkeypatch):
    """forge_tpu's refiner pass gets its own 64-wide conds beside the base's
    128-wide AND branch (1280 and 2048 at full size); the port refuses. A
    prompt the refiner would encode with `[from:to:when]` is refused too,
    before the base pass: forge_tpu encodes the brackets as text."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts
    from test_torch_refiner import BASE_G, _tiny_refiner_checkpoint
    from test_torch_sdxl import _jax_engine, _port_engine, _tiny_sdxl_checkpoint
    import jax.numpy as jnp

    from forge_tpu.models.unet import UNetConfig as JCfg
    from forge_tpu.pipeline.engine import load_engine as jload

    sd = _tiny_sdxl_checkpoint()
    jbase, tbase = _jax_engine(sd), _port_engine(sd)
    jref = jload(_tiny_refiner_checkpoint(BASE_G), dtype=jnp.float32)
    jref.unet_cfg = JCfg(context_dim=64, num_heads=4, use_linear_projection=True,
                         adm_in_channels=2560)
    fields = dict(REQUEST, prompt="a cat AND a red hat :0.8", refiner_switch_at=0.5)
    passes = _record_reference_passes(monkeypatch, jproc)
    p = jproc.Processing(**fields)
    p._refiner_engine = jref
    jproc.process_images(jbase, p)
    base_pass, refiner_pass = passes
    assert refiner_pass["cond"]["context"].shape[-1] == 64
    assert [b["context"].shape[-1] for b in refiner_pass["branches"]] == [128]

    tref = object()  # refused before the refiner is reached
    for prompt, match in (("a cat AND a red hat :0.8", "AND or regional prompts with the refiner"),
                          ("a [cat:dog:0.5]", r"AND or \[from:to:when\]")):
        q = tproc.Processing(**dict(fields, prompt=prompt))
        q._refiner_engine = tref
        with opts.override({"save_write_params_txt": False}):
            with pytest.raises(NotImplementedError, match=match):
                tproc.process_images(tbase, q)


def test_flux_branches_fail_in_the_reference():
    """forge_tpu adds Flux's guidance to cond and uncond only, so its AND
    branches lack the key the batched call joins (the port refuses AND and
    regional prompts on Flux before sampling)."""
    import jax.numpy as jnp

    from forge_tpu.sampling import cfg as jcfg

    cond = {"context": jnp.ones((1, 4, 3)), "guidance": jnp.ones((1,))}
    branch = {"context": jnp.zeros((1, 4, 3))}
    fn = jcfg.make_cfg_model_fn(lambda x, s, c: x, cond, dict(cond), 3.0,
                                cond_branches=[branch], branch_weights=[1.0, 0.5])
    with pytest.raises(KeyError, match="guidance"):
        fn(jnp.ones((1, 2, 2, 16)), jnp.float32(1.0))


# -- chip_smoke's prompts phase at full width, traced on the meta device -------------------


def test_prompts_phase_launch_counts_and_bodies():
    """Each of chip_smoke's prompts requests through `prepare`'s txt2img
    step and `sample` on the full-width SDXL engine (its UNet recording the
    batch of each call): (a) 20 calls at batch 2 with per-step conds and CFG
    rescale, (b) 20 at batch 3, (c) 20 at batch 4 with the regional maps,
    (d) 11 at batch 2 then 9 at batch 1 (s_min_uncond 1.0); one forward
    traced at each batch (70 flash: 10 at 4096 tokens, 60 at 1024; 34
    convs) and the 1024² decode (1 flash, 28 convs): 1401 flash and 708
    conv a request, as chip_smoke counts them, every call tensor-core."""
    import chip_smoke
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.runtime.options import opts
    from forge_tpu_torch.sampling.cfg import PerStep

    engine = meta_sdxl_engine()
    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        calls["conv"].append((tuple(x.shape), w.shape[0],
                              fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)))
        return _meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    steps = chip_smoke.PROMPTS_STEPS
    cond = {"context": _meta((1, 77, 2048)), "y": _meta((1, 2816))}
    per_step = {k: PerStep(_meta((steps,) + tuple(v.shape))) for k, v in cond.items()}
    mask = _meta((1, 1, 128, 128), torch.float32)
    requests = {  # name: (cond, branches, weights, masks, fields, options)
        "(a) editing + TI + style + rescale": (per_step, None, None, None,
                                               dict(cfg_rescale=0.7), {}),
        "(b) AND": (cond, [cond], [1.0, 0.8], None, {}, {}),
        "(c) regional": (cond, [cond, cond], [1.0, 1.0, 1.0], [None, mask, mask], {}, {}),
        "(d) NGMS": (cond, None, None, None, {}, {"s_min_uncond": chip_smoke.PROMPTS_NGMS}),
    }
    forwards, batches = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        for b in (1, 2, 3, 4):
            calls.update(flash=[], conv=[])
            engine.unet_apply_fn()(engine.loaded.unet, _meta((b, 4, 128, 128)),
                                   torch.zeros((b,), device="meta"), _meta((b, 77, 2048)),
                                   y=_meta((b, 2816)))
            forwards[b] = dict(calls)
        calls.update(flash=[], conv=[])
        engine.decode_dispatch(_meta((1, 4, 128, 128), torch.float32))
        decode = dict(calls)

        unet_calls = []

        def unet(params, x, t, context, y=None):
            assert context.shape[0] == y.shape[0] == x.shape[0]
            unet_calls.append(x.shape[0])
            return torch.empty_like(x)

        mp.setattr(engine, "unet_apply_fn", lambda hooks=None, controlnets=None: unet)
        for name, (c, branches, weights, masks, fields, options) in requests.items():
            p = proc.Processing(width=1024, height=1024, cfg_scale=7.0, steps=steps, seed=1,
                                sampler_name="DPM++ 2M", scheduler="karras", **fields)
            proc._resolve_seeds(p)
            job = proc._prep_txt2img(engine, p, [1], [1], c, cond, engine.loaded.unet, {})
            job.branches, job.weights, job.masks = branches, weights, masks
            unet_calls.clear()
            with opts.override(options):
                proc.sample(engine, job, {})
            batches[name] = _count([(b,) for b in unet_calls])
            flash_n = sum(len(forwards[b]["flash"]) for b in unet_calls) + len(decode["flash"])
            conv_n = sum(len(forwards[b]["conv"]) for b in unet_calls) + len(decode["conv"])
            assert {"flash_attention": flash_n, "gn_silu_conv3x3": conv_n,
                    "dequant_matmul": 0} == chip_smoke.PROMPTS_PER_REQUEST, name

    assert batches == {"(a) editing + TI + style + rescale": {(2,): 20}, "(b) AND": {(3,): 20},
                       "(c) regional": {(4,): 20}, "(d) NGMS": {(2,): 11, (1,): 9}}
    for b in (1, 2, 3, 4):
        assert _count(forwards[b]["flash"]) == {((b, 10, 4096, 64), 4096): 10,
                                                ((b, 20, 1024, 64), 1024): 60}
        # each (C, O) pair's calls a forward, at its latent size
        assert _count([(c[0][1], c[1], c[0][2]) for c in forwards[b]["conv"]]) == {
            (320, 320): 7, (640, 320): 2, (960, 320): 1, (320, 640): 1, (640, 640): 6,
            (960, 640): 1, (1280, 640): 1, (1920, 640): 1, (640, 1280): 1, (1280, 1280): 10,
            (1920, 1280): 1, (2560, 1280): 2}
        assert {c[0][2] for c in forwards[b]["conv"]} == {128, 64, 32}
    assert decode["flash"] == [((1, 1, 16384, 512), 16384, "wgmma")]
    assert len(decode["conv"]) == 28
    assert all(body == "wgmma" for part in list(forwards.values()) + [decode]
               for kind in part.values() for *_, body in kind)
    # every flash shape and conv pair a request here launches is one chip_smoke times
    timed = {shape for shape, _, _ in chip_smoke.FLASH_SHAPES}
    assert {c[0] for b in (1, 3) for c in forwards[b]["flash"]} <= timed
    timed_conv = {(shape, o) for shape, o in chip_smoke.GN_CONV_SHAPES}
    assert {(c[0], c[1]) for b in (1, 2, 3, 4) for c in forwards[b]["conv"]} <= timed_conv

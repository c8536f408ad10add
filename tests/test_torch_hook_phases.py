"""`Processing.hook_phases` and `deferred_hooks` in forge_tpu_torch against
forge_tpu (CPU, f32): the step loop split into segments with the phases'
hooks merged onto the base manifest (DPM++ 2M on the tiny SDXL with an
empty segment and a seam at a `[from:to:when]` edit, Euler a on the tiny
SD1.5, phases that end early), the base hooks restored after, the interrupt
between segments, the deferred hooks run once with the per-request
weight override, and the departures from both sides: the refiner with hook
phases and img2img with hook phases (the reference drops the phases in
both; the port refuses), the other families and serving (refused). Slices
at PSNR ≥ 80 dB with the reference's infotexts (torch_controls_cases.py).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice,  # noqa: E402
                                  init_and_mask, processing, run_both, sd15_engines,
                                  sdxl_engines)

# elementwise hooks, the same on NCHW (the port) and NHWC (the reference)
BASE = {"middle_block_patch": (lambda h, bid: h * 1.05,)}
A = {"middle_block_patch": (lambda h, bid: h - 0.02,),
     "output_block_patch_after": (lambda h, bid: h * 1.1,)}
B = {"input_block_patch": (lambda h, bid: h * 0.9 + 0.01,)}


@pytest.fixture(scope="module")
def engines():
    return {"sdxl": sdxl_engines(), "sd15": sd15_engines()}


def test_merge_hooks_matches():
    from forge_tpu.pipeline.processing import _merge_hooks as jmerge
    from forge_tpu_torch.pipeline.processing import _merge_hooks

    replace = {"attn1_replace_all": object()}
    for base, extra in ((BASE, A), (None, B), (dict(BASE, **replace), {"attn1_replace_all": 1}),
                        (A, BASE)):
        assert _merge_hooks(base, extra) == jmerge(base, extra)
    merged = _merge_hooks(BASE, A)
    assert merged["middle_block_patch"] == BASE["middle_block_patch"] + A["middle_block_patch"]


CASES = {  # name: (model, the request's fields, the phases)
    "DPM++ 2M, an empty segment, a seam at a prompt edit": (
        "sdxl", dict(prompt="a [cat:dog:0.5] on a hill", steps=4),
        [(0.0, {}), (0.5, A), (0.5, {}), (1.0, B)]),
    "Euler a": ("sd15", dict(steps=4), [(0.25, A), (1.0, {})]),
    "phases that end early": ("sdxl", dict(steps=4), [(0.5, B)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hook_phases_match_forge_tpu(engines, case):
    model, fields, phases = CASES[case]
    request = dict(SDXL_REQUEST if model == "sdxl" else SD15_REQUEST, **fields)

    def attach(package, p):
        p.unet_hooks = dict(BASE)
        p.hook_phases = list(phases)

    got, want, tp = run_both(engines[model], request, attach)
    print(case, assert_slice(got, want))
    assert tp.unet_hooks == BASE  # restored after the segments
    plain = processing("forge_tpu_torch").process_images(
        engines[model][1], processing("forge_tpu_torch").Processing(**request, unet_hooks=BASE))
    assert not np.array_equal(got.images[0], plain.images[0])


def test_hook_phases_interrupt_between_segments(engines):
    """An interrupt in the first segment ends its loop at the step boundary
    and no later segment runs."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from forge_tpu_torch.runtime.state import state

    calls = {"first": 0, "second": 0}

    def first(h, bid):
        if bid == ("middle", 0):
            calls["first"] += 1
            state.interrupted = True
        return h

    def second(h, bid):
        calls["second"] += 1
        return h

    p = Processing(**dict(SDXL_REQUEST, steps=4), hook_phases=[
        (0.5, {"middle_block_patch": (first,)}), (1.0, {"middle_block_patch": (second,)})])
    state.begin("hook phases")
    try:
        res = process_images(engines["sdxl"][1], p)
    finally:
        state.end()
    assert calls == {"first": 1, "second": 0} and res.images[0].shape == (64, 64, 3)


def _bias_override(tree):
    """A copy of the tree with the UNet's last bias moved (both layouts)."""
    out = dict(tree["out"])
    out["2"] = dict(out["2"], bias=out["2"]["bias"] + 0.05)
    return dict(tree, out=out)


def test_deferred_hooks_and_the_weight_override_match_forge_tpu(engines):
    """Each deferred hook runs once a request, after the first batch's conds are
    encoded, with (engine, p, cond, uncond); its hooks and the weight
    override act on every batch; the engine's weights are not written."""
    seen = {"forge_tpu": [], "forge_tpu_torch": []}

    def attach(package, p):
        def build(engine, pp, cond, uncond):
            seen[package].append((engine, pp, sorted(cond), sorted(uncond)))
            proc = processing(package)
            pp.unet_hooks = proc._merge_hooks(pp.unet_hooks, A)
            pp._unet_param_override = _bias_override

        p.deferred_hooks = [build]

    teng = engines["sdxl"][1]
    before = teng.loaded.unet["out"]["2"]["bias"].clone()
    got, want, tp = run_both(engines["sdxl"], dict(SDXL_REQUEST, n_iter=2), attach)
    assert_slice(got, want)
    assert [len(v) for v in seen.values()] == [1, 1]
    engine, pp, cond_keys, uncond_keys = seen["forge_tpu_torch"][0]
    assert engine is teng and pp is tp and cond_keys == ["context", "y"] == uncond_keys
    assert torch.equal(teng.loaded.unet["out"]["2"]["bias"], before)
    plain = processing("forge_tpu_torch").process_images(
        teng, processing("forge_tpu_torch").Processing(**SDXL_REQUEST, unet_hooks=A))
    assert not np.array_equal(got.images[0], plain.images[0])


def test_refiner_with_hook_phases_from_both_sides(engines):
    """The reference's refiner branch comes first and drops the phases
    without a word (the same image as without them); the port refuses."""
    jeng, teng = engines["sdxl"]
    phased = dict(SDXL_REQUEST, refiner_switch_at=0.5, hook_phases=[(0.5, A), (1.0, B)])
    images = []
    for fields in (phased, dict(phased, hook_phases=None)):
        p = processing("forge_tpu").Processing(**fields)
        p._refiner_engine = jeng
        images.append(processing("forge_tpu").process_images(jeng, p).images[0])
    assert np.array_equal(images[0], images[1])
    p = processing("forge_tpu_torch").Processing(**phased)
    p._refiner_engine = teng
    with pytest.raises(NotImplementedError, match="hook_phases with the refiner"):
        processing("forge_tpu_torch").process_images(teng, p)


def test_img2img_with_hook_phases_from_both_sides(engines):
    """The reference's img2img never reads the phases (the same image as
    without them); the port refuses."""
    jeng, teng = engines["sdxl"]
    init, mask = init_and_mask()
    fields = dict(SDXL_REQUEST, init_images=[init], inpaint_mask=mask, denoising_strength=0.8,
                  hook_phases=[(0.5, A), (1.0, {})])
    jproc = processing("forge_tpu")
    images = [jproc.process_images(jeng, jproc.Processing(**dict(fields, hook_phases=h))).images[0]
              for h in (fields["hook_phases"], None)]
    assert np.array_equal(images[0], images[1])
    with pytest.raises(NotImplementedError, match="hook_phases on img2img"):
        processing("forge_tpu_torch").process_images(
            teng, processing("forge_tpu_torch").Processing(**fields))


@pytest.mark.parametrize("family", ["sd20", "sd3", "playground", "chroma", "flux"])
def test_other_families_refuse_hook_phases_and_deferred_hooks(family):
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from test_torch_cfg_hooks import _family_engine

    if family == "flux":
        from test_torch_flux import _port_engine as flux_port_engine
        from test_torch_flux import _tiny_flux_checkpoint

        eng = flux_port_engine(dict(_tiny_flux_checkpoint()))
    else:
        eng = _family_engine(family)
    request = dict(prompt="a fox", seed=1, steps=2, width=32, height=32)
    refused = {"hook_phases": [(0.5, {})], "deferred_hooks": [lambda *a: None]}
    for field, value in refused.items():
        if family == "flux" and field == "deferred_hooks":
            continue
        with pytest.raises(NotImplementedError, match=f"{field} on {family}"):
            process_images(eng, Processing(**request, **{field: value}))


def test_serving_refuses_hook_phases_and_deferred_hooks(engines):
    from forge_tpu_torch.pipeline.processing import Processing
    from forge_tpu_torch.runtime.serving import ServingPipeline

    pipe = ServingPipeline(engines["sdxl"][1], depth=2)
    try:
        futures = [pipe.submit(Processing(**SDXL_REQUEST, **{field: value})) for field, value in (
            ("hook_phases", [(0.5, A), (1.0, {})]), ("deferred_hooks", [lambda *a: None]))]
        for fut in futures:
            with pytest.raises(NotImplementedError, match="serving with"):
                fut.result(timeout=60)
    finally:
        pipe.close()


def test_rest_payload_refuses_hook_phases_and_deferred_hooks():
    """A JSON payload cannot carry Python hooks: 422; null values are dropped
    as the reference's defaults."""
    from forge_tpu_torch.api.server import ApiError, _processing_from_payload

    for field, value in (("hook_phases", [[0.5, {}]]), ("deferred_hooks", ["not a hook"])):
        with pytest.raises(ApiError) as err:
            _processing_from_payload({"prompt": "a fox", field: value})
        assert err.value.status == 422 and field in str(err.value)
        assert getattr(_processing_from_payload({"prompt": "a fox", field: None}), field) is None

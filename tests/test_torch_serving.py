"""The port's serving pipeline and config 5's launch counts.

`serve_throughput` and `ServingPipeline` on the tiny SDXL checkpoint of
tests/test_torch_sdxl.py (CPU, f32; 64², DPM++ 2M Karras, 3 steps, CFG 7,
batch 2, with the tiny IP-Adapter of tests/test_torch_ipadapter.py): a
served request gives the bytes `process_images` gives on the same
`Processing` (tests/test_serving.py holds forge_tpu to the same), seeds
differ and repeat, `close()` drains and then rejects, a failed request
fails its own future only (a NaN too), each stage runs without grad, and
concurrent clients under a short switch interval get their sequential
twins. The launch-count test traces config 5 at full width on the meta
device: a served request (SDXL at CFG batch 4, 1024², 20 steps, the IP
hooks) and a MultiDiffusion 2048² upscale (9 tiles of 96 latent pixels, 3
model calls, the VAE encode and decode at 2048²).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ipadapter import _ip_hooks, ip_trees  # noqa: E402,F401
from test_torch_sdxl import REQUEST, _port_engine, _tiny_sdxl_checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def engine():
    return _port_engine(_tiny_sdxl_checkpoint())


@pytest.fixture(scope="module")
def hooks(ip_trees):  # noqa: F811
    return _ip_hooks(ip_trees)[1]


def _p(seed, hooks=None, **kw):
    from forge_tpu_torch.pipeline.processing import Processing

    return Processing(**dict(REQUEST, seed=seed, batch_size=2, unet_hooks=hooks, **kw))


def test_serving_matches_process_images(engine, hooks):
    from forge_tpu_torch.pipeline.processing import process_images
    from forge_tpu_torch.runtime.serving import serve_throughput

    ref = process_images(engine, _p(7, hooks))
    out = serve_throughput(engine, [_p(7, hooks)])
    assert out["n_images"] == 2 and out["images_per_s"] > 0
    served = out["outputs"][0]
    assert served["seeds"] == ref.seeds == [7, 8]
    assert all(np.array_equal(a, b) for a, b in zip(served["images"], ref.images))
    assert {"lora", "cond", "noise", "prep", "denoise", "decode_dispatch",
            "finish"} <= set(served["timings"])


def test_served_sde_request_matches_process_images(engine):
    """A "DPM++ SDE" request (second order, Brownian step noise made in the
    prep stage) gives the bytes its sequential twin gives."""
    from forge_tpu_torch.pipeline.processing import process_images
    from forge_tpu_torch.runtime.serving import serve_throughput

    kw = dict(sampler_name="DPM++ SDE", scheduler="karras")
    ref = process_images(engine, _p(5, **kw))
    served = serve_throughput(engine, [_p(5, **kw)])["outputs"][0]
    assert served["seeds"] == ref.seeds == [5, 6]
    assert all(np.array_equal(a, b) for a, b in zip(served["images"], ref.images))
    assert not np.array_equal(ref.images[0], process_images(engine, _p(5)).images[0])


@pytest.mark.parametrize("prompt, options", [
    ("a photograph of an astronaut AND a red horse :0.7", {}),
    ("a photograph of an [astronaut:diver:0.5] riding a horse", {}),
    ("a photograph of an astronaut riding a horse", {"s_min_uncond": 3.0}),
], ids=["AND", "prompt editing", "NGMS"])
def test_served_prompt_features_match_process_images(engine, prompt, options):
    """An AND request (UNet batch 6 at batch size 2), a prompt-editing one
    (per-step conds) and an NGMS one (the tail at batch 2) give the bytes and
    infotexts their sequential twins give; the infotext records the NGMS
    threshold where it acted."""
    from forge_tpu_torch.pipeline.processing import process_images
    from forge_tpu_torch.runtime.options import opts
    from forge_tpu_torch.runtime.serving import serve_throughput

    # an override is the calling thread's: the serving threads read the set value
    opts.set("s_min_uncond", options.get("s_min_uncond", 0.0))
    try:
        with opts.override({"save_write_params_txt": False}):
            ref = process_images(engine, _p(9, prompt=prompt))
        served = serve_throughput(engine, [_p(9, prompt=prompt)])["outputs"][0]
    finally:
        opts.set("s_min_uncond", 0.0)
    assert served["seeds"] == ref.seeds == [9, 10]
    assert all(np.array_equal(a, b) for a, b in zip(served["images"], ref.images))
    assert served["infotexts"] == ref.infotexts and len(ref.infotexts) == 2
    assert ("NGMS: 3.0" in ref.infotexts[0]) == bool(options)
    assert ["Seed: 9," in ref.infotexts[0], "Seed: 10," in ref.infotexts[1]] == [True, True]


def test_serving_pipelines_multiple_requests(engine, hooks):
    from forge_tpu_torch.runtime.serving import serve_throughput

    res = serve_throughput(engine, [_p(1, hooks), _p(3, hooks), _p(5)])
    assert res["n_images"] == 6
    imgs = [o["images"][0] for o in res["outputs"]]
    assert not np.array_equal(imgs[0], imgs[1])  # seeds differ
    again = serve_throughput(engine, [_p(1, hooks)])["outputs"][0]["images"][0]
    assert np.array_equal(imgs[0], again)  # a repeated seed through the pipeline


def test_pipeline_close_drains_and_rejects(engine):
    """close() lets submitted work through every stage and ends the threads;
    a failing request fails its own future only; submit() afterwards raises."""
    from forge_tpu_torch.pipeline.processing import Processing
    from forge_tpu_torch.runtime.serving import ServingPipeline

    pipe = ServingPipeline(engine, depth=2)
    good = pipe.submit(_p(1))
    bad = pipe.submit(_p(2, sampler_name="no_such_sampler"))
    img2img = pipe.submit(_p(3, init_images=[np.zeros((64, 64, 3), np.uint8)]))
    good2 = pipe.submit(_p(4))
    pipe.close()
    for t in pipe._threads:
        assert not t.is_alive()
    assert good.result(timeout=0)["images"][0].shape == (64, 64, 3)
    with pytest.raises(KeyError, match="no_such_sampler"):  # unknown, as in forge_tpu
        bad.result(timeout=0)
    with pytest.raises(NotImplementedError, match="txt2img"):
        img2img.result(timeout=0)
    assert len(good2.result(timeout=0)["images"]) == 2
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(Processing(prompt="late", seed=4, steps=1, width=64, height=64))
    pipe.close()  # a second close is a no-op


def test_nans_fail_the_request(engine):
    """A NaN in the UNet's output reaches `decode_finish` as the UNet's NaN
    error, through the future; the pipeline serves the next request."""
    from forge_tpu_torch.pipeline.engine import NansException
    from forge_tpu_torch.runtime.serving import ServingPipeline

    def poison(out, extra):
        return out * float("nan")

    with ServingPipeline(engine) as pipe:
        bad = pipe.submit(_p(1, {"attn2_output_patch": [poison]}))
        good = pipe.submit(_p(2))
        with pytest.raises(NansException, match="UNet"):
            bad.result(timeout=300)
        assert len(good.result(timeout=300)["images"]) == 2


def test_decode_finish_raises_on_nans(engine, monkeypatch):
    from forge_tpu_torch.models import vae as vae_mod
    from forge_tpu_torch.pipeline.engine import NansException

    latent = torch.zeros((1, 4, 8, 8))
    images = engine.decode_finish(engine.decode_dispatch(latent))
    assert images.shape == (1, 64, 64, 3) and images.dtype == np.uint8
    latent[0, 0, 0, 0] = float("nan")
    with pytest.raises(NansException, match="UNet"):
        engine.decode_finish(engine.decode_dispatch(latent))
    monkeypatch.setattr(vae_mod, "vae_decode", lambda p, z: torch.full((1, 3, 64, 64), float("inf")))
    with pytest.raises(NansException, match="VAE"):
        engine.decode_finish(engine.decode_dispatch(torch.zeros((1, 4, 8, 8))))


def test_serving_stages_run_without_grad(engine, monkeypatch):
    """Grad mode is thread-local: the prep thread (text encode) and the
    denoise thread (every UNet forward) each run with it off."""
    from forge_tpu_torch.runtime.serving import serve_throughput

    seen = {"prep": set(), "denoise": set()}
    encode = engine.get_learned_conditioning

    def spy_encode(*args, **kwargs):
        seen["prep"].add((threading.current_thread().name, torch.is_grad_enabled()))
        return encode(*args, **kwargs)

    def spy_attention(q, k, v, extra):
        seen["denoise"].add((threading.current_thread().name, torch.is_grad_enabled()))
        return q, k, v

    monkeypatch.setattr(engine, "get_learned_conditioning", spy_encode)
    # a prompt no earlier request encoded: the cond cache would answer for one
    serve_throughput(engine, [_p(1, {"attn1_patch": [spy_attention]},
                                 prompt="a prompt only the grad check encodes")])
    assert seen == {"prep": {("serve-prep", False)}, "denoise": {("serve-denoise", False)}}


def test_concurrent_clients_get_their_sequential_images(engine, hooks):
    """Three client threads submit two requests each to one pipeline under a
    short switch interval; every result equals its request run alone."""
    from forge_tpu_torch.pipeline.processing import process_images
    from forge_tpu_torch.runtime.serving import ServingPipeline

    seeds = [[11, 12], [13, 14], [15, 16]]
    want = {s: process_images(engine, _p(s, hooks if s % 2 else None)).images
            for group in seeds for s in group}
    got, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ServingPipeline(engine, depth=2) as pipe:
            def client(group):
                try:
                    futs = {s: pipe.submit(_p(s, hooks if s % 2 else None)) for s in group}
                    got.update({s: f.result(timeout=300)["images"] for s, f in futs.items()})
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(g,)) for g in seeds]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert sorted(got) == sorted(want)
    for s, images in got.items():
        assert all(np.array_equal(a, b) for a, b in zip(images, want[s])), s


# -- config 5's launch counts at full width, traced on the meta device --------------------


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def meta_sdxl_engine():
    """A full-width SDXL engine whose every weight is a meta tensor."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.loader import LoadedCheckpoint, convert_open_clip
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_checkpoint
    from forge_tpu_torch.pipeline.engine import DiffusionEngine

    g = guess.guess(synth_sdxl_checkpoint(fill=DeviceFill("cpu")))

    def tree(sd):
        return nest({k: _meta(v.shape) for k, v in sd.items()})

    tes = {"clip_l": tree(g.text_encoders["clip_l"]),
           "clip_g": tree(convert_open_clip(g.text_encoders["open_clip_g"]))}
    loaded = LoadedCheckpoint("sdxl", "eps", 2048, tree(g.unet), tree(g.vae), tes)
    return DiffusionEngine(loaded, "meta", torch.bfloat16)


def config5_calls():
    """Every flash and fused-conv call of config 5's parts, each through
    `processing.denoise` and the engine's encode and decode: one step of a
    served request (one model call of DPM++ 2M), the served batch's decode,
    one model call of the upscale (MultiDiffusion over 9 tiles), and the
    upscale's encode and decode → {part: {kernel: [call]}}, a flash call as
    (q shape, Lk, body), a conv call as (x shape, O, body)."""
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.synth import DeviceFill, synth_ip_adapter_sd
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv
    from forge_tpu_torch.ops.flash_attention import flash_body
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.ipadapter import IPAdapterState

    engine = meta_sdxl_engine()
    adapter = nest({k: _meta(v.shape) for k, v in synth_ip_adapter_sd(fill=DeviceFill("cpu")).items()})
    ip = IPAdapterState(adapter, _meta((2, 4, 2048)), 0.6, uncond_tokens=_meta((2, 4, 2048)))
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

    def one_call(p, x):
        sigmas = np.array([14.6, 0.0], np.float32)  # one model call
        job = proc.Job(p, x, sigmas, None, cond(x.shape[0]), cond(x.shape[0]), engine.loaded.unet)
        return proc.denoise(engine, job)

    served = proc.Processing(width=1024, height=1024, batch_size=2, cfg_scale=7.0,
                             sampler_name="DPM++ 2M", unet_hooks=ip.build_hooks())
    upscale = proc.Processing(width=2048, height=2048, cfg_scale=7.0, sampler_name="Euler",
                              tiled_diffusion={"tile": 96, "overlap": 16})
    parts = {
        "served step": lambda: one_call(served, _meta((2, 4, 128, 128), torch.float32)),
        "served decode": lambda: engine.decode_dispatch(_meta((2, 4, 128, 128), torch.float32)),
        "upscale call": lambda: one_call(upscale, _meta((1, 4, 256, 256), torch.float32)),
        "upscale encode": lambda: engine.encode_first_stage(_meta((1, 3, 2048, 2048),
                                                                   torch.float32)),
        "upscale decode": lambda: engine.decode_dispatch(_meta((1, 4, 256, 256), torch.float32)),
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        for name, run in parts.items():
            calls.update(flash=[], conv=[])
            run()
            out[name] = dict(calls)
    return out


def _count(calls):
    counts = {}
    for c in calls:
        counts[c[:2]] = counts.get(c[:2], 0) + 1
    return counts


def test_config5_launch_counts_and_bodies():
    """A served request: 20 model calls (DPM++ 2M over 20 Karras steps), each
    one UNet forward at CFG batch 4 on 128² latents: 70 self-attentions (10
    at 4096 tokens, 10 heads; 60 at 1024, 20 heads; the IP hooks' extra
    attentions have 4 keys: no kernel) and 34 ResBlock convs; then the 1024²
    decode of both images: 1401 flash, 708 conv. An upscale: strength 0.35
    of 8 Euler steps keeps 3 model calls, each 9 tiles of 96² at CFG batch 2
    (2304 and 576 tokens), then the 2048² encode and decode (one head of 512
    over 65536 tokens each; 20 and 28 convs): 1892 flash, 966 conv. Every
    call on the tensor-core body."""
    from forge_tpu_torch.sampling.schedules import get_sigmas
    from forge_tpu_torch.sampling.prediction import DiscretePrediction

    pred = DiscretePrediction()
    steps = len(get_sigmas("karras", 20, pred)) - 1
    t_enc = min(int(0.35 * 8), 8 - 1)
    upscale_calls = len(get_sigmas("normal", 8, pred)[8 - t_enc - 1:]) - 1
    assert (steps, upscale_calls) == (20, 3)
    c = config5_calls()
    assert all(body == "wgmma" for part in c.values() for kind in part.values()
               for *_, body in kind)
    step, decode = c["served step"], c["served decode"]
    assert _count(step["flash"]) == {((4, 10, 4096, 64), 4096): 10, ((4, 20, 1024, 64), 1024): 60}
    assert decode["flash"] == [((2, 1, 16384, 512), 16384, "wgmma")]
    assert (len(step["conv"]), len(decode["conv"])) == (34, 28)
    assert steps * len(step["flash"]) + len(decode["flash"]) == 1401
    assert steps * len(step["conv"]) + len(decode["conv"]) == 708
    call, enc, dec = c["upscale call"], c["upscale encode"], c["upscale decode"]
    assert _count(call["flash"]) == {((2, 10, 2304, 64), 2304): 9 * 10,
                                     ((2, 20, 576, 64), 576): 9 * 60}
    assert enc["flash"] == dec["flash"] == [((1, 1, 65536, 512), 65536, "wgmma")]
    assert (len(call["conv"]), len(enc["conv"]), len(dec["conv"])) == (9 * 34, 20, 28)
    assert upscale_calls * len(call["flash"]) + len(enc["flash"]) + len(dec["flash"]) == 1892
    assert upscale_calls * len(call["conv"]) + len(enc["conv"]) + len(dec["conv"]) == 966
    # the UNet's twelve (C, O) pairs by level, on the 128² latent's levels at batch 4
    # and on a 96² tile's at batch 2
    pairs = {(320, 320, 0), (960, 320, 0), (640, 320, 0), (320, 640, 1), (640, 640, 1),
             (1920, 640, 1), (1280, 640, 1), (960, 640, 1), (640, 1280, 2), (1280, 1280, 2),
             (2560, 1280, 2), (1920, 1280, 2)}
    for part, side in ((step, 128), (call, 96)):
        assert {(x[1], o, x[2]) for x, o in _count(part["conv"])} == {
            (c_, o, side >> level) for c_, o, level in pairs}
    # the 2048² level of the decoder (up.0: 256 → 128, then five 128 → 128) and the encoder (4)
    convs = _count(enc["conv"] + dec["conv"])
    assert convs[((1, 256, 2048, 2048), 128)] == 1 and convs[((1, 128, 2048, 2048), 128)] == 9

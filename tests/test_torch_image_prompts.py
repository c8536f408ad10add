"""The image-prompt family's modules against forge_tpu (CPU, f32).

FaceID and FaceID-Plus projections, InstantID's tokens and its ControlNet's
`context_override`, Revision's embed and cond rewrite, reference-only's
recording noise and its capture/consume hooks on one UNet forward, and
PhotoMaker's id encoder, fuse and trigger, each on weights made from a seed
(tests/torch_image_prompt_cases.py) through both packages: agreement within
1e-4 of the output's scale (f32 on both sides), the noise bit for bit. Also
the PhotoMaker crop fault from both sides (the reference reads the
full-frame face box (x, y, w, h) as corners), the refusals, and the
ControlNet unit modules the port now takes.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_ipadapter import (CV_WIDTH, _run_unets, _unet_inputs,  # noqa: E402, F401
                                  tiny_clip_vision_sd, unet_trees)
from test_torch_sdxl import ADM, CTX, GW, _assert_close  # noqa: E402
from torch_image_prompt_cases import (REF_WEIGHT, face_embed, jax_tree, photo,  # noqa: E402
                                      port_tree, tiny_faceid_sd, tiny_instantid_sd,
                                      tiny_photomaker_sd, tiny_revision_sd)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


# -- pipeline/ipadapter.py: FaceID, FaceID-Plus, InstantID --------------------------------


@pytest.mark.parametrize("plus,clip,shortcut", [(False, False, False), (True, False, False),
                                                 (True, True, False), (True, True, True)])
def test_project_faceid_embeds_matches(plus, clip, shortcut):
    """The MLP and LayerNorm; FaceID-Plus's perceiver over CLIP-vision hidden
    states (without them: the MLP's tokens), v2's shortcut at scale 0.7."""
    from forge_tpu.pipeline.ipadapter import project_faceid_embeds as jproject
    from forge_tpu_torch.pipeline.ipadapter import is_faceid_adapter, project_faceid_embeds

    sd = tiny_faceid_sd(plus=plus)
    jtree, tree = jax_tree(sd), port_tree(sd)
    fe = face_embed(n=2)
    hidden = (np.random.default_rng(1).standard_normal((2, 50, CV_WIDTH)).astype(np.float32)
              if clip else None)
    want = jproject(jtree, jnp.asarray(fe), None if hidden is None else jnp.asarray(hidden),
                    scale=0.7, shortcut=shortcut)
    with torch.no_grad():
        got = project_faceid_embeds(tree, torch.from_numpy(fe),
                                    None if hidden is None else torch.from_numpy(hidden),
                                    scale=0.7, shortcut=shortcut)
    assert got.shape == (2, 4, CTX)
    _assert_close(got.numpy(), want)
    assert is_faceid_adapter(tree) and not is_faceid_adapter(port_tree(tiny_instantid_sd()))


@pytest.mark.parametrize("plus", [False, True])
def test_faceid_hooks_on_a_unet_forward_match(unet_trees, plus):
    """build_faceid_hooks' manifest (the layers numbered 0, 1, 2, …, by
    attn_index) on one forward of the tiny UNet at [cond, uncond]."""
    from forge_tpu.pipeline.ipadapter import build_faceid_hooks as jbuild
    from forge_tpu_torch.pipeline.ipadapter import build_faceid_hooks

    sd, cv = tiny_faceid_sd(plus=plus), tiny_clip_vision_sd()
    kw = dict(image=photo(80, 96), weight=0.8, batch_size=1, faceid_v2=plus, weight_v2=0.6)
    jhooks = jbuild(jax_tree(sd), face_embed()[0], clip_vision_params=jax_tree(cv), **kw)
    thooks = build_faceid_hooks(port_tree(sd), face_embed()[0],
                                clip_vision_params=port_tree(cv), **kw)
    got, want = _run_unets(unet_trees, jhooks, thooks)
    _assert_close(got, want)
    plain, _ = _run_unets(unet_trees, None, None)
    assert np.abs(got - plain).max() > 1e-3
    if plus:  # the perceiver reads the face's CLIP-vision hidden states
        with pytest.raises(ValueError, match="FaceID-Plus needs"):
            build_faceid_hooks(port_tree(sd), face_embed()[0])


def test_instantid_tokens_and_controlnet_override_match(unet_trees):
    """InstantID's 4 tokens through the tiny Resampler as the UNet's IP tokens,
    and its ControlNet reading [cond‖uncond] tokens in place of the text:
    the residuals at the CFG batch and under skip-uncond (the cond rows)."""
    from forge_tpu.models import controlnet as jcn
    from forge_tpu.pipeline.ipadapter import build_instantid as jbuild
    from forge_tpu_torch.models import controlnet as tcn
    from forge_tpu_torch.pipeline.ipadapter import build_instantid
    from test_torch_controlnet import _inputs, _nhwc, jcfg, tcfg, tiny_controlnet_sd

    sd, cldm = tiny_instantid_sd(), tiny_controlnet_sd()
    x, t, ctx, y, hint = _inputs()
    jstate = jcn.ControlNetState(params=jax_tree(cldm), hint=_nhwc(hint), cfg=jcfg())
    tstate = tcn.ControlNetState(params=port_tree(cldm), hint=torch.from_numpy(hint), cfg=tcfg())
    jhooks, jstate = jbuild(jax_tree(sd), face_embed()[0], controlnet_state=jstate, weight=0.9)
    thooks, tstate = build_instantid(port_tree(sd), face_embed()[0], controlnet_state=tstate,
                                     weight=0.9)
    assert tuple(tstate.context_override.shape) == (2, 4, CTX)
    _assert_close(tstate.context_override.numpy(), jstate.context_override)
    got, want = _run_unets(unet_trees, jhooks, thooks)
    _assert_close(got, want)
    for rows in (2, 1):  # the CFG batch, then skip-uncond: the override's first rows
        want = jcn.run_controlnets([jstate], _nhwc(x[:rows]), jnp.asarray(t[:rows]),
                                   jnp.asarray(np.float32(0.3)), jnp.asarray(ctx[:rows]),
                                   y=jnp.asarray(y[:rows]))
        with torch.no_grad():
            got = tcn.run_controlnets([tstate], torch.from_numpy(x[:rows]),
                                      torch.from_numpy(t[:rows]), 0.3,
                                      torch.from_numpy(ctx[:rows]), y=torch.from_numpy(y[:rows]))
            text = tcn.run_controlnets([tcn.ControlNetState(params=tstate.params,
                                                            hint=tstate.hint, cfg=tcfg())],
                                       torch.from_numpy(x[:rows]), torch.from_numpy(t[:rows]),
                                       0.3, torch.from_numpy(ctx[:rows]),
                                       y=torch.from_numpy(y[:rows]))
        for g, w in zip(got["output"] + got["middle"], want["output"] + want["middle"]):
            _assert_close(g.numpy(), _nchw(w))
        assert np.abs(got["middle"][0].numpy() - text["middle"][0].numpy()).max() > 1e-4


# -- pipeline/revision.py ---------------------------------------------------------------


def test_revision_embed_and_apply_match():
    """Two units' embeds (weights 0.8 and 0.5) summed into y[:, :GW] of the
    cond and zeros in the uncond's slot; the second unit's "ignore prompt"
    zeroes both contexts. The port writes new tensors: the cond dict's
    inputs (what the cond cache holds) stay as they were."""
    from forge_tpu.pipeline import revision as jrev
    from forge_tpu_torch.pipeline import revision as trev

    sd = tiny_revision_sd()
    jcv, tcv = jax_tree(sd), port_tree(sd)
    r = np.random.default_rng(7)
    y, uy = (r.standard_normal((2, ADM)).astype(np.float32) for _ in range(2))
    ctx, uctx = (r.standard_normal((2, 77, CTX)).astype(np.float32) for _ in range(2))
    jp = types.SimpleNamespace(extra_generation_params={})
    tp = types.SimpleNamespace(extra_generation_params={})
    jcond, juncond = dict(y=jnp.asarray(y), context=jnp.asarray(ctx)), dict(
        y=jnp.asarray(uy), context=jnp.asarray(uctx))
    inputs = dict(y=torch.from_numpy(y.copy()), context=torch.from_numpy(ctx.copy()))
    tcond = dict(inputs)
    tuncond = dict(y=torch.from_numpy(uy.copy()), context=torch.from_numpy(uctx.copy()))
    for img, weight, ignore in ((photo(64, 80, 1), 0.8, False), (photo(96, 64, 2), 0.5, True)):
        jemb = jrev.encode_revision_embed(jcv, img, weight)
        temb = trev.encode_revision_embed(tcv, img, weight)
        assert temb.shape == (1, GW)
        _assert_close(temb.numpy(), jemb)
        jrev.apply_revision(jp, jcond, juncond, jemb, ignore)
        trev.apply_revision(tp, tcond, tuncond, temb, ignore)
        for got, want in ((tcond, jcond), (tuncond, juncond)):
            for key in ("y", "context"):
                _assert_close(got[key].numpy(), want[key])
        if not ignore:
            assert np.abs(tcond["context"].numpy() - ctx).max() == 0
    assert np.abs(tcond["y"][:, GW:].numpy() - y[:, GW:]).max() == 0
    assert np.abs(tuncond["y"][:, :GW].numpy()).max() == 0
    assert np.abs(tcond["context"].numpy()).max() == 0
    assert np.array_equal(inputs["y"].numpy(), y) and np.array_equal(inputs["context"].numpy(), ctx)
    assert tp.extra_generation_params == jp.extra_generation_params == {"Revision": "enabled"}
    with pytest.raises(ValueError, match="SDXL"):
        trev.apply_revision(types.SimpleNamespace(extra_generation_params={}),
                            {"context": tcond["context"]}, {}, temb, False)


@pytest.mark.parametrize("width,patch,layers", [(64, 32, 2), (128, 32, 1), (1024, 14, 1)])
def test_revision_clip_vision_towers_match(width, patch, layers):
    """The projected embed through towers at widths where the port's
    `ClipVisionConfig.for_width` and the reference take the same heads and
    activation (width // 64, quick_gelu; at 1024 OpenAI's ViT-L/14). ViT-H
    and bigG differ on purpose (tests/test_torch_ipadapter.py)."""
    from forge_tpu.pipeline.revision import encode_revision_embed as jencode
    from forge_tpu_torch.pipeline.revision import encode_revision_embed

    sd = tiny_clip_vision_sd(width=width, layers=layers, mlp=4 * width, patch=patch,
                             projection=GW, seed=width)
    img = photo(72, 56, 3)
    _assert_close(encode_revision_embed(port_tree(sd), img, 1.0).numpy(),
                  jencode(jax_tree(sd), img, 1.0))


# -- pipeline/reference_only.py ---------------------------------------------------------


def _reference_states(module, latent, fidelity=0.4):
    from forge_tpu.pipeline.reference_only import ReferenceState as JState
    from forge_tpu_torch.pipeline.reference_only import ReferenceState

    flags = dict(use_attn="attn" in module or module == "reference_only",
                 use_adain="adain" in module, style_fidelity=fidelity, weight=REF_WEIGHT,
                 seed=12)
    return (JState(latent=jnp.asarray(latent.transpose(0, 2, 3, 1)), **flags),
            ReferenceState(latent=torch.from_numpy(latent), **flags))


def test_reference_step_noise_is_bit_equal():
    """Philox Generator(seed + 1), one (C, h, w) draw a step: the port's NCHW
    draws are the reference's NHWC steps transposed, bit for bit."""
    from forge_tpu.pipeline.reference_only import reference_step_noise as jnoise
    from forge_tpu_torch.pipeline.reference_only import reference_step_noise

    latent = np.zeros((1, 4, 12, 10), np.float32)
    jstate, state = _reference_states("reference_only", latent)
    got = reference_step_noise(state, 5)
    assert got.shape == (5, 1, 4, 12, 10) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jnoise(jstate, 5)).transpose(0, 1, 4, 2, 3))


@pytest.mark.parametrize("skip_uncond", [False, True])
@pytest.mark.parametrize("module", ["reference_only", "reference_adain", "reference_adain+attn"])
def test_reference_hooks_on_a_unet_forward_match(unet_trees, module, skip_uncond):
    """The capture hooks on a batch-1 forward, then the consume hooks on the
    CFG batch [cond, uncond] (or the cond alone under skip-uncond): attention
    over the joined keys, the uncond's blend at style fidelity 0.4, AdaIN on
    the block outputs."""
    from forge_tpu.pipeline.reference_only import build_reference_hooks as jbuild
    from forge_tpu_torch.pipeline.reference_only import build_reference_hooks

    x, t, ctx, y = _unet_inputs()
    rows = 1 if skip_uncond else 2
    jstate, state = _reference_states(module, x[:1])
    jcap, jcon = jbuild(jstate, None, 1, skip_uncond)
    tcap, tcon = build_reference_hooks(state, None, 1, skip_uncond)
    r = np.random.default_rng(9)
    recorded = (r.standard_normal((1, 4, 8, 8)).astype(np.float32), t[:1], ctx[:1], y[:1])
    got, want = _run_unets(unet_trees, jcap, tcap, inputs=recorded)
    _assert_close(got, want)
    got, want = _run_unets(unet_trees, jcon, tcon, inputs=(x[:rows], t[:rows], ctx[:rows],
                                                           y[:rows]))
    _assert_close(got, want)
    plain, _ = _run_unets(unet_trees, None, None, inputs=(x[:rows], t[:rows], ctx[:rows],
                                                          y[:rows]))
    assert np.abs(got - plain).max() > 5e-4  # five times the tolerance: the hooks act


def test_concatenated_keys_are_contiguous():
    """The recorded k and v reach the consume pass broadcast (`expand`), and
    `torch.cat` joins them into contiguous storage: the flash wrapper's
    `aligned` then copies only what any attention's head transpose makes it
    copy, nothing for the broadcast."""
    from forge_tpu_torch.pipeline.reference_only import build_reference_hooks
    from forge_tpu_torch.pipeline import reference_only

    _, state = _reference_states("reference_only", np.zeros((1, 4, 8, 8), np.float32))
    seen = []
    orig = reference_only.attention
    reference_only.attention = lambda q, k, v, heads: seen.append((k, v)) or orig(q, k, v, heads)
    try:
        cap, con = build_reference_hooks(state, None, 1, False)
        extra = {"block": ("input", 4), "block_index": 0, "n_heads": 2}
        q = torch.randn(1, 16, 64)
        cap["attn1_replace_all"](q, q, q, extra)
        seen.clear()
        q2 = torch.randn(2, 16, 64)
        con["attn1_replace_all"](q2, q2, q2, extra)
    finally:
        reference_only.attention = orig
    joined = [k for k, _ in seen if k.shape[1] == 32] + [v for _, v in seen if v.shape[1] == 32]
    assert len(joined) == 4 and all(a.is_contiguous() for a in joined)


# -- pipeline/photomaker.py -------------------------------------------------------------


def _tokenizer_engines():
    from forge_tpu.text.tokenizer import default_tokenizer as jtok
    from forge_tpu_torch.text.tokenizer import default_tokenizer

    return [types.SimpleNamespace(text_engines={"clip_l": types.SimpleNamespace(tokenizer=tok())})
            for tok in (jtok, default_tokenizer)]


def test_find_trigger_position_matches():
    """BOS + the tokens before "img"; no trigger or two raise in both packages."""
    from forge_tpu.pipeline.photomaker import find_trigger_position as jfind
    from forge_tpu_torch.pipeline.photomaker import find_trigger_position

    jeng, teng = _tokenizer_engines()
    for prompt in ("a photo of a person img, smiling", "img", "portrait of img in a garden"):
        assert find_trigger_position(teng, prompt) == jfind(jeng, prompt)
    assert find_trigger_position(teng, "a photo of a person img, smiling") == 6
    for prompt, match in (("a photo of a person", "Cannot find"), ("img img", "multiple")):
        for fn, eng in ((jfind, jeng), (find_trigger_position, teng)):
            with pytest.raises(ValueError, match=match):
                fn(eng, prompt)


@pytest.mark.parametrize("qformer", [False, True])
def test_encode_id_images_and_fuse_match(qformer):
    """The id encoder (its CLIP tower's pooled embed projected; with the
    qformer, its tokens over two face embeds around that projection), then
    the fuse and splice at the trigger, and the cond transform with a
    start_merge_ratio."""
    from forge_tpu.pipeline import photomaker as jpm
    from forge_tpu_torch.models.clipvision import preprocess
    from forge_tpu_torch.pipeline import photomaker as tpm

    sd = tiny_photomaker_sd(qformer=qformer)
    jtree, tree = jax_tree(sd), port_tree(sd)
    pixels = torch.cat([preprocess(photo(64, 64, s)) for s in (1, 2)])
    fe = face_embed(n=2) if qformer else None
    want = jpm.encode_id_images(jtree, None, jnp.asarray(pixels.numpy().transpose(0, 2, 3, 1)),
                                face_embeds=None if fe is None else jnp.asarray(fe))
    got = tpm.encode_id_images(tree, None, pixels,
                               face_embeds=None if fe is None else torch.from_numpy(fe))
    assert got.shape == (2, 2 if qformer else 1, CTX)
    _assert_close(got.numpy(), want)
    ctx = np.random.default_rng(3).standard_normal((2, 77, CTX)).astype(np.float32)
    fused = tpm.fuse_id_embeds(tree, torch.from_numpy(ctx), got, 6)
    _assert_close(fused.numpy(), jpm.fuse_id_embeds(jtree, jnp.asarray(ctx), want, 6))
    assert np.array_equal(fused[:, :6].numpy(), ctx[:, :6])
    assert np.array_equal(fused[:, 6 + got.shape[0] * got.shape[1]:].numpy(),
                          ctx[:, 7:77 - got.shape[0] * got.shape[1] + 1])
    jeng, teng = _tokenizer_engines()
    prompt = "a photo of a person img, smiling"
    jt = jpm.build_cond_transform(jeng, jtree, prompt,
                                  id_pixels=pixels.numpy().transpose(0, 2, 3, 1), face_embeds=fe,
                                  start_merge_ratio=0.3)
    tt = tpm.build_cond_transform(teng, tree, prompt, id_pixels=pixels, face_embeds=fe,
                                  start_merge_ratio=0.3)
    y = np.ones((2, ADM), np.float32)
    got = tt({"context": torch.from_numpy(ctx), "y": torch.from_numpy(y)})
    want = jt({"context": jnp.asarray(ctx), "y": jnp.asarray(y)})
    _assert_close(got["context"].numpy(), want["context"])
    assert np.array_equal(got["y"].numpy(), y)


def test_photomaker_crop_from_both_sides(monkeypatch, tmp_path):
    """The fault. With no detector file, the face box is the full-frame
    square (x, y, w, h) = (32, 0, 64, 64) of a 64×128 photo. The reference
    reads it as corners (x0, y0, x1, y1), pads by int(0.4 · 64) = 25 and
    crops columns 7..89 (64 × 82); the port pads the box it means and crops
    columns 7..121 (64 × 114). A square photo's box is the whole frame,
    which both read right."""
    import forge_tpu.models.clipvision as jclip
    from forge_tpu.pipeline.photomaker import id_pixels_from_images as jpixels
    from forge_tpu.postprocessing import faces
    from forge_tpu_torch.models.clipvision import preprocess
    from forge_tpu_torch.pipeline.photomaker import fullframe_face_box, id_pixels_from_images

    monkeypatch.chdir(tmp_path)  # no models/facedetection: the full-frame rule on both sides
    faces._detector.cache_clear()
    img = photo(64, 128, 5)
    assert faces.detect_faces(img) == [fullframe_face_box(64, 128)] == [(32, 0, 64, 64)]
    crops = []
    monkeypatch.setattr(jclip, "preprocess", lambda im: crops.append(im) or np.zeros((1, 2)))
    jpixels([img])
    faces._detector.cache_clear()
    (ref_crop,) = crops
    x, y, w, h = 32, 0, 64, 64
    pad = int(0.4 * max(w, h))
    box = img[max(0, y - pad):min(64, y + h + pad), max(0, x - pad):min(128, x + w + pad)]
    assert box.shape == (64, 114, 3)
    assert ref_crop.shape == (64, 82, 3) and np.array_equal(ref_crop, img[:, 7:89])
    assert np.array_equal(id_pixels_from_images([img]).numpy(), preprocess(box).numpy())
    square = photo(64, 64, 6)  # a square photo: both crop the whole frame
    crops.clear()
    jpixels([square])
    faces._detector.cache_clear()
    assert np.array_equal(crops[0], square)
    assert np.array_equal(id_pixels_from_images([square]).numpy(), preprocess(square).numpy())


def test_photomaker_refusals(monkeypatch, tmp_path):
    """A detector file under models/facedetection (YuNet, Haar need OpenCV)
    and a checkpoint's lora_weights raise, naming their ROADMAP items; a
    dict without id_encoder keys is not a PhotoMaker file."""
    from forge_tpu_torch.pipeline.photomaker import id_pixels_from_images, load_photomaker

    monkeypatch.chdir(tmp_path)
    (tmp_path / "models" / "facedetection").mkdir(parents=True)
    (tmp_path / "models" / "facedetection" / "yunet.onnx").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 9"):
        id_pixels_from_images([photo()])
    sd = tiny_photomaker_sd(qformer=False)
    with pytest.raises(NotImplementedError, match="6 \\(d\\)"):
        load_photomaker(dict(sd, **{"lora_weights.unet.x.lora_down.weight":
                                    np.zeros((4, 4), np.float32)}), device="cpu")
    with pytest.raises(ValueError, match="id_encoder"):
        load_photomaker({"x.weight": np.zeros((4, 4), np.float32)}, device="cpu")
    tree = load_photomaker(sd, device="cpu")
    assert tree["id_encoder"]["visual_projection"]["weight"].dtype == torch.float32


# -- extensions/controlnet.py: the modules taken ----------------------------------------


@pytest.mark.parametrize("module", ["reference_only", "reference_adain", "reference_adain+attn",
                                    "CLIP-G (Revision)", "revision_clipvision",
                                    "CLIP-G (Revision ignore prompt)", "revision_ignore_prompt"])
def test_unit_modules_give_deferred_hooks(module, tmp_path, monkeypatch):
    """The reference and Revision modules need no control model: each unit is
    a deferred hook in both packages. Revision without CLIP vision weights
    raises FileNotFoundError in both."""
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu_torch.extensions.controlnet import build_unit_state

    monkeypatch.chdir(tmp_path)
    unit = {"module": module, "image": photo(), "weight": 1.0}
    if "revision" in module.lower():
        for fn in (jcn.build_unit_state, build_unit_state):
            with pytest.raises(FileNotFoundError, match="CLIP-ViT-bigG"):
                fn(unit, 64, 64)
        unit["clip_vision_path"] = str(tmp_path / "cv.safetensors")
    assert callable(jcn.build_unit_state(unit, 64, 64))
    assert callable(build_unit_state(unit, 64, 64, device="cpu"))


@pytest.mark.parametrize("module", ["ip-adapter_clip_sdxl", "InsightFace (InstantID)",
                                    "ip-adapter_face_id"])
def test_ip_adapter_modules_stay_refused(module):
    """The IP-Adapter, FaceID and InstantID come through the 'ip-adapter'
    always-on script; as a ControlNet unit's module (the reference has no
    such preprocessor) the port raises, naming the script and 6 (d)."""
    from forge_tpu_torch.extensions.controlnet import build_unit_state

    with pytest.raises(NotImplementedError, match="ip-adapter.*6 \\(d\\)"):
        build_unit_state({"module": module, "image": photo()}, 64, 64, device="cpu")


def test_image_prompt_fields_refused_on_other_families():
    """`reference_state` and `cond_transform` are among the features no test
    holds on SD2, SD3, Playground, Chroma and Flux."""
    from forge_tpu_torch.pipeline import processing as proc

    for family in ("sd20", "sd3", "playground", "chroma", "flux"):
        for field in proc.IMAGE_PROMPT_FIELDS:
            p = proc.Processing(**{field: (lambda c: c) if field == "cond_transform"
                                   else object()})
            with pytest.raises(NotImplementedError, match=field):
                proc._refuse_for_family(types.SimpleNamespace(family=family), p)


def test_rest_payload_refuses_image_prompt_objects():
    """A JSON payload cannot carry a ReferenceState or a cond transform: 422
    naming always-on scripts; null values are dropped."""
    from forge_tpu_torch.api.server import ApiError, _processing_from_payload

    for field in ("reference_state", "cond_transform"):
        with pytest.raises(ApiError) as err:
            _processing_from_payload({"prompt": "a fox", field: {"latent": [0.0]}})
        assert err.value.status == 422 and field in str(err.value)
        assert "alwayson_scripts" in str(err.value)
        assert getattr(_processing_from_payload({"prompt": "a fox", field: None}), field) is None


def test_serving_refuses_image_prompt_fields():
    from forge_tpu_torch.pipeline.processing import Processing
    from forge_tpu_torch.runtime.serving import ServingPipeline

    for field in ("reference_state", "cond_transform"):
        p = Processing(prompt="a fox", **{field: (lambda c: c) if field == "cond_transform"
                                          else object()})
        with pytest.raises(NotImplementedError, match=f"serving with {field}"):
            ServingPipeline._prep(types.SimpleNamespace(engine=None), p, {})

"""The port's Spaces on SD1.5 engines (forge_tpu_torch/spaces/illusion_diffusion.py,
iclight.py, geowizard.py) against the reference apps' own classes
(extensions-builtin/forge_space_*/forge_app.py, loaded with importlib) on
the CPU.

The pure parts are equal: Illusion's short-side crop and IC-Light's cover
crop (Pillow's LANCZOS, then the float box Pillow rounds), the lighting
gradients, the merged stem's values (axis 2 of HWIO, axis 1 of OIHW) with
the offset in diffusers' keys, GeoWizard's class embedding and its DDIM
timesteps. GeoWizard's DDIM latent, depth and normals match at f32 rel
1e-4. Both packages load the same safetensors files with their own loaders
(`from_files`); the small requests (tests/fixtures.py's tiny SD1.5, test_controlnet's
cldm, tests/test_spaces.py's GeoWizard) are within one level on 98 % of the
values or more, the largest difference stated. Both sides refuse a control
model that is not a cldm with the same ValueError, and answer an IC-Light
request with an empty U²-Net directory with the same RuntimeError.

Each Space is launched once as a child with `--device cpu` on a file
(tests/torch_space_apps_cases.py's fast SD1.5 for Illusion and IC-Light),
and its POST /process answer, at the app's default size where the body
leaves it to the app, is held to the reference app's `process` on the same
body in-process, which runs while the child works.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
PIL = pytest.importorskip("PIL")
cv2 = pytest.importorskip("cv2")

from torch_space_apps_cases import (Children, fast_cldm_sd, fast_sd15_sd, iclight_offset_sd,  # noqa: E402
                                    image, near, pixels, png_b64, reference_app, save)

ILLUSION = "forge_space_illusion_diffusion"
ICLIGHT = "forge_space_iclight"
GEOWIZARD = "forge_space_geowizard"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from fixtures import make_sd15_checkpoint
    from test_controlnet import make_cldm_sd
    from test_spaces import _tiny_geowizard_ckpt
    from torch_spaces_cases import write

    d = tmp_path_factory.mktemp("sd15_spaces")
    return {"sd15": save(make_sd15_checkpoint(0), d / "sd15.safetensors"),
            "cldm": save(make_cldm_sd(), d / "cldm.safetensors"),
            "fast": save(fast_sd15_sd(), d / "fast_sd15.safetensors"),
            "fast_cldm": save(fast_cldm_sd(), d / "fast_cldm.safetensors"),
            "offset": save(iclight_offset_sd(), d / "iclight_sd15_fc.safetensors"),
            "lora": save({"lora_controlnet": np.zeros(1, np.float32)},
                         d / "control_lora.safetensors"),
            "u2net": write(str(d), "u2net"), "empty": str(d / "no_u2net"),
            "geowizard": _tiny_geowizard_ckpt(d), "root": str(d)}


@pytest.fixture(scope="module")
def children(files, tmp_path_factory):
    """The three Spaces as children, launched at once before the in-process tests run."""
    kids = Children(tmp_path_factory.mktemp("children"), (ILLUSION, ICLIGHT, GEOWIZARD))
    try:
        kids.launch({ILLUSION: ["--ckpt", files["fast"], "--controlnet", files["fast_cldm"]],
                     ICLIGHT: ["--ckpt", files["fast"], "--iclight", files["offset"],
                               "--u2net-dir", files["u2net"]],
                     GEOWIZARD: ["--ckpt", files["geowizard"]]})
        yield kids
    finally:
        kids.close()


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def test_diffusers_unet_to_ldm_moved_and_equal():
    from forge_tpu.core.state_dict import diffusers_unet_to_ldm as ref
    from forge_tpu_torch.core.state_dict import diffusers_unet_to_ldm
    from forge_tpu_torch.preprocessors import marigold

    assert marigold.diffusers_unet_to_ldm is diffusers_unet_to_ldm
    sd = iclight_offset_sd()
    got, want = diffusers_unet_to_ldm(sd), ref(sd)
    assert got.keys() == want.keys() and all(got[k] is want[k] for k in got)
    from forge_tpu_torch.core.synth import synth_unet_sd
    from torch_space_apps_cases import FAST_UNET

    assert set(got) == set(synth_unet_sd(**FAST_UNET, context_dim=64, in_channels=8, prefix=""))


@pytest.mark.parametrize("shape", [(40, 48), (48, 40), (37, 61), (64, 64)])
def test_crops_equal(shape):
    from forge_tpu_torch.spaces import iclight, illusion_diffusion

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    ill, icl = reference_app(ILLUSION), reference_app(ICLIGHT)
    for size in (32, 51, 512):
        assert np.array_equal(illusion_diffusion.center_crop(img, size), ill.center_crop(img, size))
    for tw, th in ((32, 32), (33, 21), (64, 48), (96, 80), (512, 512), (77, 64)):
        got, want = iclight.resize_and_center_crop(img, tw, th), icl.resize_and_center_crop(
            img, tw, th)
        assert got.shape == want.shape and np.array_equal(got, want), (tw, th)


def test_gradients_equal():
    from forge_tpu_torch.spaces import iclight

    ref = reference_app(ICLIGHT)
    assert iclight.BG_SOURCES == ref.BG_SOURCES
    for source in ref.BG_SOURCES + ("",):
        for w, h in ((32, 32), (512, 512), (77, 45)):
            got, want = iclight.gradient_bg(source, w, h), ref.gradient_bg(source, w, h)
            assert (got is None and want is None) or np.array_equal(got, want), source
    for mod in (iclight, ref):
        with pytest.raises(ValueError, match="unknown bg source 'Sideways'"):
            mod.gradient_bg("Sideways", 8, 8)


def test_merge_iclight_unet_equal(files):
    """The stem widened 4 → 8 with zeros, then every leaf + offset in f32: the port's
    OIHW tree equals forge_tpu's HWIO one, leaf by leaf."""
    from forge_tpu.core.state_dict import load_state_dict as jload
    from forge_tpu.pipeline.engine import load_engine as jengine
    from forge_tpu_torch.core.convert import flatten, params_from_jax
    from forge_tpu_torch.core.state_dict import load_state_dict
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.spaces.iclight import merge_iclight_unet

    ref = reference_app(ICLIGHT)
    jeng, teng = jengine(jload(files["fast"])), load_engine(files["fast"], device="cpu")
    want = ref.merge_iclight_unet(jeng.loaded.unet, jload(files["offset"]))
    got = merge_iclight_unet(teng.loaded.unet, load_state_dict(files["offset"]))
    want, got = flatten(params_from_jax(want)), flatten(got)
    assert want.keys() == got.keys()
    stem = got["input_blocks.0.0.weight"]
    assert stem.shape[1] == 8 and stem.dtype == torch.float32
    base = teng.loaded.unet["input_blocks"]["0"]["0"]["weight"]
    offset = torch.from_numpy(np.array(load_state_dict(files["offset"])["conv_in.weight"]))
    assert torch.equal(stem[:, 4:], offset[:, 4:])  # zeros + offset
    assert torch.equal(stem[:, :4], (base.float() + offset[:, :4].float()))
    for key in got:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def test_illusion_strength_and_passes(files):
    """The port alone at the tiny size (32² → 64²): the hint resized to each pass's size
    (the regression tests/test_spaces.py pins) and strength 0 moving the image. The child
    test holds the app's own size against the reference."""
    from forge_tpu_torch.spaces.illusion_diffusion import IllusionPipeline

    pipe = IllusionPipeline.from_files(files["sd15"], files["cldm"], device="cpu")
    pattern = np.zeros((40, 48, 3), np.uint8)
    pattern[10:30, 10:30] = 255
    kw = dict(seed=5, base_size=32, steps=2, upscaler_strength=0.6)
    out = pipe.run(pattern, "cat", "blurry", **kw)
    weak = pipe.run(pattern, "cat", "blurry", strength=0.0, **kw)
    assert out.shape == weak.shape == (64, 64, 3)
    assert not np.array_equal(weak, out), "the illusion strength moved nothing"


def test_illusion_refuses_a_control_lora(files):
    from forge_tpu_torch.spaces.illusion_diffusion import IllusionPipeline

    ref = reference_app(ILLUSION)
    text = f"{files['lora']} is a control_lora, need a cldm ControlNet"
    with pytest.raises(ValueError) as want:
        ref.IllusionPipeline.from_files(files["fast"], files["lora"])
    with pytest.raises(ValueError) as got:
        IllusionPipeline.from_files(files["fast"], files["lora"], device="cpu")
    assert str(got.value) == str(want.value) == text


@pytest.fixture(scope="module")
def iclight(files):
    from forge_tpu_torch.spaces.iclight import ICLightPipeline

    ref = reference_app(ICLIGHT)
    return (ref.ICLightPipeline.from_files(files["fast"], files["offset"], files["u2net"]),
            ICLightPipeline.from_files(files["fast"], files["offset"], files["u2net"],
                                       device="cpu"))


def test_iclight_request(iclight):
    """64² → 128², txt2img then img2img: the U²-Net composite and x_concat on both passes
    (the child test holds the gradient's img2img at the app's size); a lighting gradient
    moves the port's image."""
    jpipe, tpipe = iclight
    fg = image(48, 40, seed=3)
    kw = dict(width=64, height=64, seed=3, steps=2)
    want, got = jpipe.run(fg, "a lamp", **kw), tpipe.run(fg, "a lamp", **kw)
    assert got.shape == want.shape == (128, 128, 3)
    print("iclight (largest difference, share):", near(got, want))
    lit = tpipe.run(fg, "a lamp", bg_source="Left Light", **kw)
    assert lit.shape == got.shape and not np.array_equal(lit, got)


def test_iclight_without_u2net_weights(files):
    """A U²-Net directory with no weights: both build the matter, and both requests raise
    its RuntimeError before any step."""
    from forge_tpu_torch.spaces.iclight import ICLightPipeline

    ref = reference_app(ICLIGHT)
    jpipe = ref.ICLightPipeline.from_files(files["fast"], files["offset"], files["empty"])
    tpipe = ICLightPipeline.from_files(files["fast"], files["offset"], files["empty"],
                                       device="cpu")
    assert jpipe.matter is not None and tpipe.matter is not None
    fg = image(32, 32, seed=4)
    for pipe in (jpipe, tpipe):
        with pytest.raises(RuntimeError, match=f"no u2net checkpoint under {files['empty']}"):
            pipe.run(fg, "a lamp", width=64, height=64, steps=1)


@pytest.fixture(scope="module")
def geowizard(files):
    from forge_tpu_torch.spaces.geowizard import GeoWizardPipeline

    ref = reference_app(GEOWIZARD)
    return (ref.GeoWizardPipeline.from_file(files["geowizard"]),
            GeoWizardPipeline.from_file(files["geowizard"], device="cpu"))


def test_geowizard_embedding_and_timesteps():
    import jax.numpy as jnp

    from forge_tpu_torch.spaces.geowizard import DOMAINS, GeoWizardPipeline, ddim_timesteps

    ref = reference_app(GEOWIZARD)
    assert DOMAINS == ref.DOMAINS
    for domain in DOMAINS:
        got = GeoWizardPipeline._class_embedding(domain)
        assert got.dtype == torch.float32 and got.shape == (2, 10)
        assert got.numpy().tobytes() == np.asarray(ref.GeoWizardPipeline._class_embedding(
            domain)).tobytes()
    for steps in (1, 2, 3, 4, 7, 10, 13, 20, 25, 50):
        want = np.asarray(jnp.linspace(999.0, 0.0, steps).round().astype(jnp.int32))
        assert np.array_equal(ddim_timesteps(steps), want), steps


def test_geowizard_ddim_matches(geowizard, monkeypatch):
    """The DDIM loop's last latent (what the decode reads), the depth and the normals at
    f32 rel 1e-4 (forge_tpu's jitted inference, its decode input recorded by a callback)."""
    import jax

    from forge_tpu.models import vae as jvae

    jpipe, tpipe = geowizard
    seen, steps = [], 2
    decode = jvae.vae_decode

    def recording(p, z):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), z)
        return decode(p, z)

    monkeypatch.setattr(jvae, "vae_decode", recording)
    r = np.random.default_rng(steps)
    rgb = r.uniform(-1.0, 1.0, (1, 64, 64, 3)).astype(np.float32)
    noise = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    emb = jpipe._class_embedding("outdoor")
    jdepth, jnormal = jax.jit(jpipe._infer_fn, static_argnames=("steps",))(
        jpipe.unet, jpipe.vae, jpipe.clipvision, rgb, noise, emb, steps=steps)
    trace = []
    depth, normal = tpipe.infer(torch.from_numpy(rgb.transpose(0, 3, 1, 2).copy()),
                                torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()),
                                tpipe._class_embedding("outdoor"), steps, trace=trace)
    assert len(trace) == steps and len(seen) == 1
    latent = (trace[-1] / 0.18215).numpy().transpose(0, 2, 3, 1)

    def close(got, want):
        err = np.abs(got - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1.0), err

    close(latent, seen[0])
    close(depth.numpy(), np.asarray(jdepth))
    close(normal.numpy().transpose(1, 2, 0), np.asarray(jnormal))


@pytest.mark.parametrize("domain", ["indoor", "object"])
def test_geowizard_run(geowizard, domain):
    jpipe, tpipe = geowizard
    img = image(48, 40, seed=6)
    want = jpipe.run(img, domain=domain, denoise_steps=2, seed=1, processing_res=64)
    got = tpipe.run(img, domain=domain, denoise_steps=2, seed=1, processing_res=64)
    for g, w, name in zip(got, want, ("depth", "normal")):
        assert g.dtype == np.uint8 and g.shape == w.shape
        print(f"geowizard {domain} {name} (largest difference, share):", near(g, w))


def _held(children, folder, body, reference):
    """The child's /process answer against the reference app's `process` on the same body
    in-process, run while the child works → {key: the child's pixels}."""
    (status, got), want = children.post_while(folder, body, reference)
    assert status == 200, got
    assert got.keys() == want.keys()
    out = {key: pixels(got[key]) for key in want}
    print(folder, "child vs the reference in-process (largest difference, share):",
          {key: near(out[key], pixels(want[key])) for key in want})
    return out


def test_illusion_child(children, files):
    """The child at the app's size: 512² with the ControlNet, then 1024² (15 + 20 steps)."""
    ref = reference_app(ILLUSION)
    pipe = ref.IllusionPipeline.from_files(files["fast"], files["fast_cldm"])
    pattern = np.zeros((300, 360, 3), np.uint8)
    pattern[60:240, 90:270] = 255
    body = {"image": png_b64(pattern), "prompt": "a village", "negative": "blurry", "seed": 11}
    held = _held(children, ILLUSION, body, lambda: ref.process(body, pipe))
    assert held["image"].shape == (1024, 1024, 3)


def test_iclight_child(children, files):
    """The child at the app's size (512², then 768²), Left Light, the U²-Net mask on."""
    ref = reference_app(ICLIGHT)
    pipe = ref.ICLightPipeline.from_files(files["fast"], files["offset"], files["u2net"])
    body = {"image": png_b64(image(96, 80, seed=8)), "prompt": "a lamp", "seed": 21,
            "bg_source": "Left Light"}
    held = _held(children, ICLIGHT, body, lambda: ref.process(body, pipe))
    assert held["image"].shape == (768, 768, 3)


def test_geowizard_child(children, geowizard):
    ref = reference_app(GEOWIZARD)
    body = {"image": png_b64(image(72, 56, seed=9)), "domain": "outdoor", "steps": 2, "seed": 3,
            "processing_res": 64}
    held = _held(children, GEOWIZARD, body, lambda: ref.process(body, geowizard[0]))
    assert held["depth"].shape == (72, 56) and held["normal"].shape == (72, 56, 3)


def test_children_pages(children):
    import urllib.request

    for folder in (ILLUSION, ICLIGHT, GEOWIZARD):
        page = urllib.request.urlopen(children.urls[folder], timeout=10).read().decode()
        assert page == reference_app(folder).PAGE

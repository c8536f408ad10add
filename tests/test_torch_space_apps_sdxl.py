"""The port's Spaces on SDXL engines (forge_tpu_torch/spaces/animagine_xl_31.py,
photo_maker_v2.py, idm_vton.py) against the reference apps' own classes
(extensions-builtin/forge_space_*/forge_app.py, loaded with importlib) on
the CPU.

The tables and the pure parts are equal: Animagine's quality tags, styles
and aspect ratios, `apply_preset` and `pick_size`; PhotoMaker's styles,
aspects and `apply_style`; IDM-VTON's `default_mask`. One IDM-VTON Euler
step (the garment pass, the cond and uncond try-on passes, CFG) matches
forge_tpu's jitted step at f32 rel 1e-4. The reference runs both UNets at
`UNetConfig()`'s 8 heads of any width where the port runs SDXL's heads of 64:
the port's step at 8 heads matches the reference as it is, and the
reference at SDXL's heads (forge_tpu's `unet_apply` given SDXL's config)
matches the port; every other IDM-VTON comparison here gives the reference
SDXL's heads. Animagine's hires path (the 1.5× "Latent (nearest-exact)"
upscale) is within one level of the reference at 64² → 96² on
tests/test_torch_sdxl.py's tiny SDXL, the largest difference stated.

Each Space is launched once as a child with `--device cpu` on a file, and
its POST /process answer is held to the reference app's `process` on the
same body in-process (run while the child works): Animagine at its default
896×1152, 28 Euler a steps, on tests/torch_space_apps_cases.py's fast SDXL;
PhotoMaker V2 (tests/torch_image_prompt_cases.py's tiny PhotoMaker with the
v2 qformer and a face embedding; a square face photo, where the
reference's corner-read face box crops as the port's does) and IDM-VTON
(with a mask upload, Pillow's "L") at the 64² the body asks for. IDM-VTON's
answer is byte-equal to the person photo outside its mask. chip_smoke's
phase 25 counts (`diffusion_counts`) and its rows in phase 2 are pinned.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
PIL = pytest.importorskip("PIL")
cv2 = pytest.importorskip("cv2")

from torch_space_apps_cases import (Children, fast_sdxl_sd, idm_vton_sd, image, near,  # noqa: E402
                                    pixels, png_b64, reference_app, save)

ANIMAGINE = "forge_space_animagine_xl_31"
PHOTOMAKER = "forge_space_photo_maker_v2"
IDM_VTON = "forge_space_idm_vton"
TOL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from test_torch_sdxl import _tiny_sdxl_checkpoint
    from torch_image_prompt_cases import tiny_photomaker_sd

    d = tmp_path_factory.mktemp("sdxl_spaces")
    return {"sdxl": save(_tiny_sdxl_checkpoint(), d / "sdxl.safetensors"),
            "fast": save(fast_sdxl_sd(), d / "fast_sdxl.safetensors"),
            "photomaker": save(tiny_photomaker_sd(), d / "photomaker-v2.safetensors"),
            "idm_vton": save(idm_vton_sd(), d / "idm_vton.safetensors")}


@pytest.fixture(scope="module")
def children(files, tmp_path_factory):
    """The three Spaces as children, launched at once."""
    kids = Children(tmp_path_factory.mktemp("children"), (ANIMAGINE, PHOTOMAKER, IDM_VTON))
    try:
        kids.launch({ANIMAGINE: ["--ckpt", files["fast"]],
                     PHOTOMAKER: ["--ckpt", files["sdxl"], "--photomaker", files["photomaker"]],
                     IDM_VTON: ["--ckpt", files["idm_vton"]]})
        yield kids
    finally:
        kids.close()


@pytest.fixture(scope="module")
def sdxl_heads():
    """forge_tpu's `unet_apply` at SDXL's geometry where its caller names no config
    (IDM-VTON's two UNets)."""
    from forge_tpu.models import unet as junet

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(junet, "unet_apply", functools.partial(
            junet.unet_apply, cfg=junet.UNetConfig.for_family("sdxl")))
        yield


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def test_animagine_tables_equal():
    from forge_tpu_torch.spaces import animagine_xl_31 as port

    ref = reference_app(ANIMAGINE)
    assert port.QUALITY_TAGS == ref.QUALITY_TAGS and port.STYLES == ref.STYLES
    assert port.ASPECT_RATIOS == ref.ASPECT_RATIOS and port.PAGE == ref.PAGE
    for table in ("QUALITY_TAGS", "STYLES"):
        for name in list(getattr(ref, table)) + ["no such preset"]:
            for negative in ("", "bad hands", ", blurry, "):
                assert (port.apply_preset(getattr(port, table), name, "1girl, solo", negative)
                        == ref.apply_preset(getattr(ref, table), name, "1girl, solo", negative))
    for aspect in ref.ASPECT_RATIOS + ["7 x 9"]:
        for w, h in ((1024, 1024), (513, 511), (7, 3), (0, 0)):
            assert port.pick_size(aspect, w, h) == ref.pick_size(aspect, w, h), (aspect, w, h)


def test_photomaker_tables_equal():
    from forge_tpu_torch.spaces import photo_maker_v2 as port

    ref = reference_app(PHOTOMAKER)
    assert port.STYLES == ref.STYLES and port.ASPECTS == ref.ASPECTS and port.PAGE == ref.PAGE
    for name in list(ref.STYLES) + ["no such style"]:
        for negative in ("", "lowres", " ugly "):
            assert (port.apply_style(name, "a man img", negative)
                    == ref.apply_style(name, "a man img", negative))


def test_default_mask_equal():
    from forge_tpu_torch.spaces.idm_vton import IdmVtonPipeline

    ref = reference_app(IDM_VTON)
    for h, w in ((1024, 768), (64, 48), (33, 17), (7, 5), (512, 512)):
        got, want = IdmVtonPipeline.default_mask(h, w), ref.IdmVtonPipeline.default_mask(h, w)
        assert got.dtype == want.dtype and np.array_equal(got, want), (h, w)


def test_animagine_upscale_request(files):
    """Custom 64², 2 Euler a steps, the 1.5× "Latent (nearest-exact)" hires pass at
    strength 0.55 → 96²."""
    from forge_tpu_torch.spaces.animagine_xl_31 import AnimaginePipeline

    ref = reference_app(ANIMAGINE)
    kw = dict(seed=7, steps=2, aspect="Custom", custom_width=64, custom_height=64,
              style="Anime", use_upscaler=True)
    want = ref.AnimaginePipeline.from_file(files["sdxl"]).run("1girl", "bad hands", **kw)
    pipe = AnimaginePipeline.from_file(files["sdxl"], device="cpu")
    got = pipe.run("1girl", "bad hands", **kw)
    assert got.shape == want.shape == (96, 96, 3)
    print("animagine upscale (largest difference, share):", near(got, want))
    plain = pipe.run("1girl", "bad hands", **dict(kw, use_upscaler=False))
    assert plain.shape == (64, 64, 3)


@pytest.fixture(scope="module")
def idm_pipes(files, sdxl_heads):
    from forge_tpu_torch.spaces.idm_vton import IdmVtonPipeline

    ref = reference_app(IDM_VTON)
    return ref.IdmVtonPipeline.from_file(files["idm_vton"]), IdmVtonPipeline.from_file(
        files["idm_vton"], device="cpu")


def _step_inputs(jpipe, tpipe, seed=3):
    """The same step's inputs for both packages (NHWC for forge_tpu, NCHW for the port)."""
    import jax.numpy as jnp

    r = np.random.default_rng(seed)
    x = r.standard_normal((1, 8, 8, 4)).astype(np.float32) * 3.0
    extra = r.standard_normal((1, 8, 8, 9)).astype(np.float32)
    cloth = r.standard_normal((1, 8, 8, 4)).astype(np.float32)
    out = []
    for eng, to in ((jpipe.engine, jnp.asarray),
                    (tpipe.engine, lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy()))):
        conds = [eng.get_learned_conditioning([p], 64, 64, is_negative=neg) for p, neg in (
            ("model is wearing a red shirt", False), ("monochrome, lowres", True),
            ("a photo of a red shirt", False))]
        out.append((to(x), to(extra), to(cloth), conds))
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), err
    return err


def test_idm_vton_step(idm_pipes):
    """One Euler step at σ 2.5 → 1.9, CFG 2: rel 1e-4 against forge_tpu at SDXL's heads."""
    import jax.numpy as jnp

    jpipe, tpipe = idm_pipes
    (jx, jextra, jcloth, jconds), (tx, textra, tcloth, tconds) = _step_inputs(jpipe, tpipe)
    want = jpipe._step(jpipe.engine.loaded.unet, jpipe.garment, jx, jnp.asarray(2.5, jnp.float32),
                       jnp.asarray(1.9, jnp.float32), jextra, jcloth, *jconds,
                       jnp.asarray(2.0, jnp.float32))
    got = tpipe.step(tx, 2.5, 1.9, textra, tcloth, *tconds, 2.0)
    err = _close(got.numpy().transpose(0, 2, 3, 1), want)
    print(f"idm-vton step: largest difference {err:.3g}")


def test_idm_vton_heads_both_sides(idm_pipes):
    """forge_tpu's own step (8 heads of 4 and 8 at the tiny widths) = the port's step at
    `UNetConfig()`; at SDXL's heads the two differ."""
    import dataclasses

    import jax.numpy as jnp

    from forge_tpu_torch.models.unet import UNetConfig

    from forge_tpu.models import unet as junet

    jpipe, tpipe = idm_pipes
    (jx, jextra, jcloth, jconds), (tx, textra, tcloth, tconds) = _step_inputs(jpipe, tpipe)
    with pytest.MonkeyPatch.context() as mp:  # `sdxl_heads` undone: the reference as it is
        mp.setattr(junet, "unet_apply", junet.unet_apply.func)
        want = jpipe._step_fn(jpipe.engine.loaded.unet, jpipe.garment, jx,
                              jnp.asarray(2.5, jnp.float32), jnp.asarray(1.9, jnp.float32),
                              jextra, jcloth, *jconds, jnp.asarray(2.0, jnp.float32))
    sdxl = tpipe.step(tx, 2.5, 1.9, textra, tcloth, *tconds, 2.0)
    cfg = tpipe.engine.unet_cfg
    tpipe.engine.unet_cfg = dataclasses.replace(UNetConfig(), context_dim=cfg.context_dim)
    try:
        eight = tpipe.step(tx, 2.5, 1.9, textra, tcloth, *tconds, 2.0)
    finally:
        tpipe.engine.unet_cfg = cfg
    _close(eight.numpy().transpose(0, 2, 3, 1), want)
    # against the step's own move, which the heads change
    apart = np.abs(sdxl.numpy() - eight.numpy()).max() / np.abs(eight.numpy() - tx.numpy()).max()
    print(f"idm-vton step: SDXL's heads against 8, {apart:.3g} of the step's move")
    assert apart > 100 * TOL


def test_animagine_child(children, files):
    """The child at the app's default: 896×1152, 28 Euler a steps, CFG 7."""
    ref = reference_app(ANIMAGINE)
    pipe = ref.AnimaginePipeline.from_file(files["fast"])
    body = {"prompt": "1girl, souryuu asuka langley", "negative": "lowres", "seed": 12,
            "style": "Manga", "aspect": "896 x 1152", "use_upscaler": False}
    (status, got), want = children.post_while(ANIMAGINE, body, lambda: ref.process(body, pipe))
    assert status == 200, got
    a, b = pixels(got["image"]), pixels(want["image"])
    assert a.shape == (1152, 896, 3)
    print("animagine child vs the reference in-process (largest difference, share):", near(a, b))


def test_photomaker_child(children, files):
    """The child at the body's 64², 2 Euler steps, a square face photo and a face embedding
    for the v2 qformer."""
    from torch_image_prompt_cases import face_embed, photo

    ref = reference_app(PHOTOMAKER)
    pipe = ref.PhotoMakerPipeline.from_files(files["sdxl"], files["photomaker"])
    body = {"images": [png_b64(photo(48, 48))], "prompt": "a photo of a man img",
            "style": "Cinematic", "steps": 2, "seed": 9, "width": 64, "height": 64,
            "face_embeds": face_embed().tolist()}
    (status, got), want = children.post_while(PHOTOMAKER, body, lambda: ref.process(body, pipe))
    assert status == 200, got
    a, b = pixels(got["image"]), pixels(want["image"])
    assert a.shape == (64, 64, 3)
    print("photomaker child vs the reference in-process (largest difference, share):",
          near(a, b))
    bare = dict(body, face_embeds=None)
    status, other = children.post_while(PHOTOMAKER, bare, lambda: None)[0]
    assert status == 200 and not np.array_equal(pixels(other["image"]), a)


def test_idm_vton_child(children, idm_pipes):
    """The child at the body's 64², 2 steps, with a mask upload: within one level of the
    reference, and byte-equal to the person photo outside the mask."""
    ref = reference_app(IDM_VTON)
    person, garment = image(64, 64, seed=21), image(70, 50, seed=22)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:52, 12:50] = 255
    body = {"person": png_b64(person), "garment": png_b64(garment), "mask": png_b64(mask),
            "desc": "a red shirt", "steps": 2, "seed": 4, "width": 64, "height": 64}
    (status, got), want = children.post_while(IDM_VTON, body,
                                              lambda: ref.process(body, idm_pipes[0]))
    assert status == 200, got
    a, b = pixels(got["image"]), pixels(want["image"])
    assert a.shape == person.shape
    print("idm-vton child vs the reference in-process (largest difference, share):", near(a, b))
    assert np.array_equal(a[mask == 0], person[mask == 0]) and not np.array_equal(a, person)
    own = idm_pipes[1].run(person, garment, "a red shirt", mask=mask, steps=2, seed=4,
                           width=64, height=64)
    assert np.array_equal(own, a)  # the child = the same call in-process


def test_idm_vton_default_mask_composite(idm_pipes):
    """Without a mask, the torso box: the person photo wherever it is 0."""
    tpipe = idm_pipes[1]
    person, garment = image(64, 48, seed=23), image(64, 48, seed=24)
    out = tpipe.run(person, garment, "a coat", steps=2, seed=5, width=48, height=64)
    outside = tpipe.default_mask(64, 48) == 0
    assert np.array_equal(out[outside], person[outside])
    assert not np.array_equal(out, person)


def test_phase_25_counts():
    """chip_smoke's phase 25: its flash rows in phase 2's list, and `diffusion_counts` at the
    whole run's 4 steps and at the apps' own (a forward's flash launches: SD1's 10 at 512², 15
    at 768² and 1024², its cldm 4 and 6; SDXL's 70 at each size the Spaces take)."""
    import chip_smoke

    for row in [((2, 8, 1024, 160), 1024, True), ((2, 8, 576, 160), 576, True),
                ((1, 10, 3072, 64), 6144, True), ((1, 1, 36288, 512), 36288, True)]:
        assert row in chip_smoke.FLASH_SHAPES
    assert [chip_smoke.sd15_flash(s, s) for s in (64, 96, 128)] == [10, 15, 15]
    assert [chip_smoke.sd15_flash(s, s, cldm=True) for s in (64, 128)] == [4, 6]
    assert {chip_smoke.sdxl_flash(h, w) for h, w in ((128, 128), (144, 112), (216, 168),
                                                     (128, 96))} == {70}
    four = chip_smoke.diffusion_counts(4)
    assert {k: (v["flash_attention"], v["gn_silu_conv3x3"]) for k, v in four.items()} == {
        "animagine": (281, 164), "animagine upscale": (491, 266), "photomaker": (281, 164),
        "illusion": (540, 1820), "iclight None": (120, 512), "iclight Left Light": (121, 532),
        "geowizard": (62, 224), "idm_vton": (844, 496)}
    apps = chip_smoke.diffusion_counts(chip_smoke.DIFFUSION_APP_STEPS)
    assert apps["photomaker"]["flash_attention"] == 30 * 70 + 1
    assert apps["illusion"]["flash_attention"] == 29 * 14 + 21 * 21 + 1
    assert apps["idm_vton"] == {"flash_attention": 3 * 20 * 70 + 4,
                                "gn_silu_conv3x3": 3 * 20 * 34 + 88, "dequant_matmul": 0}
    assert set(chip_smoke.DIFFUSION_SPACE_NAMES) == {
        ANIMAGINE, PHOTOMAKER, IDM_VTON, "forge_space_illusion_diffusion", "forge_space_iclight",
        "forge_space_geowizard"}


def test_children_pages(children):
    import urllib.request

    for folder in (ANIMAGINE, PHOTOMAKER, IDM_VTON):
        page = urllib.request.urlopen(children.urls[folder], timeout=10).read().decode()
        assert page == reference_app(folder).PAGE

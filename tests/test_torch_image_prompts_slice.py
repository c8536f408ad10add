"""Revision, FaceID, FaceID-Plus, InstantID and PhotoMaker through both
packages' process_images (CPU, f32).

The tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M Karras, 3 steps,
CFG 7) with each image prompt attached the way a user attaches it: Revision
as a ControlNet unit ("revision_clipvision", "revision_ignore_prompt") with
a CLIP vision file; FaceID and FaceID-Plus v2 through the IP-Adapter's
`attach` from adapter files; InstantID through `build_instantid` with its
keypoint ControlNet reading the face tokens; PhotoMaker's cond transform.
Each image at the slice bar (80 dB) with equal infotexts, and unlike the
request without it. The Revision fault from both sides: at n_iter 2 the
reference's second image is the one without Revision; the port's is
Revision's at that seed.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from forge_tpu_torch.core.save import save_safetensors  # noqa: E402
from test_torch_ipadapter import tiny_clip_vision_sd  # noqa: E402
from test_torch_sdxl import _psnr  # noqa: E402
from torch_controls_cases import (SDXL_REQUEST, SLICE_BAR, assert_slice, processing,  # noqa: E402
                                  run_both, sdxl_engines)
from torch_image_prompt_cases import (face_embed, jax_tree, photo, port_tree,  # noqa: E402
                                      tiny_faceid_sd, tiny_instantid_sd, tiny_photomaker_sd,
                                      tiny_revision_sd)

PACKAGES = ("forge_tpu", "forge_tpu_torch")


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The adapters and CLIP vision towers as safetensors files, as both
    packages' loaders read them."""
    root = tmp_path_factory.mktemp("image_prompts")
    out = {}
    for name, sd in (("faceid", tiny_faceid_sd()), ("faceid_plus", tiny_faceid_sd(plus=True)),
                     ("instantid", tiny_instantid_sd()), ("bigG", tiny_revision_sd()),
                     ("vit_h", tiny_clip_vision_sd())):
        out[name] = str(root / f"{name}.safetensors")
        save_safetensors(sd, out[name])
    return out


def _plain(engine, **fields):
    proc = processing("forge_tpu_torch")
    return proc.process_images(engine, proc.Processing(**{**SDXL_REQUEST, **fields})).images


def _units(*units):
    def attach(package, p):
        importlib.import_module(f"{package}.extensions.controlnet").attach_units(p, list(units))

    return attach


@pytest.fixture(scope="module")
def revision_runs(engines, files):
    """Revision at n_iter 2 and the request without it, in each package."""
    unit = {"module": "revision_clipvision", "image": photo(80, 64, 8), "weight": 1.0,
            "clip_vision_path": files["bigG"]}
    fields = dict(SDXL_REQUEST, n_iter=2)
    got, want, p = run_both(engines, fields, _units(unit))
    plain = [processing(pkg).process_images(eng, processing(pkg).Processing(**fields))
             for pkg, eng in zip(PACKAGES, engines)]
    return got, want, p, plain, unit


def test_revision_matches_forge_tpu(revision_runs):
    """The first batch (the second is the fault below): the pooled slot of y
    carries the image embed."""
    got, want, p, (jplain, tplain), _ = revision_runs
    value = _psnr(got.images[0], want.images[0])
    print("Revision", value)
    assert value >= SLICE_BAR
    assert got.infotexts[0].split("Version:")[0] == want.infotexts[0].split("Version:")[0]
    assert not np.array_equal(got.images[0], tplain.images[0])
    assert "Revision: enabled" in got.infotexts[0]


def test_revision_every_batch_from_both_sides(engines, revision_runs):
    """The fault: the reference rewrites the conds of the first batch only,
    so its second image is byte for byte the one without Revision. The
    port's second image is Revision's at that seed, byte for byte the
    single request's."""
    got, want, _, (jplain, tplain), unit = revision_runs
    assert np.array_equal(want.images[1], jplain.images[1])
    assert not np.array_equal(want.images[0], jplain.images[0])
    assert not np.array_equal(got.images[1], tplain.images[1])
    proc = processing("forge_tpu_torch")
    single = proc.Processing(**dict(SDXL_REQUEST, seed=SDXL_REQUEST["seed"] + 1))
    _units(unit)("forge_tpu_torch", single)
    assert np.array_equal(got.images[1], proc.process_images(engines[1], single).images[0])


def test_revision_ignore_prompt_matches_forge_tpu(engines, files):
    unit = {"module": "revision_ignore_prompt", "image": photo(80, 64, 8), "weight": 0.7,
            "clip_vision_path": files["bigG"]}
    got, want, _ = run_both(engines, SDXL_REQUEST, _units(unit))
    print("Revision, ignore prompt", assert_slice(got, want))
    assert not np.array_equal(got.images[0], _plain(engines[1])[0])


@pytest.mark.parametrize("plus", [False, True])
def test_faceid_attach_matches_forge_tpu(engines, files, plus):
    """The IP-Adapter's `attach` with a FaceID file and a precomputed face
    embed; FaceID-Plus v2 with the face image and a CLIP-ViT-H file."""
    unit = {"adapter_path": files["faceid_plus" if plus else "faceid"],
            "face_embeds": face_embed()[0].tolist(), "weight": 0.8}
    if plus:
        unit.update(image=photo(96, 80, 9), clip_vision_path=files["vit_h"], faceid_v2=True,
                    weight_v2=0.6)

    def attach(package, p):
        mod = importlib.import_module(f"{package}.pipeline.ipadapter")
        mod.attach(p, unit, device="cpu") if package == "forge_tpu_torch" else mod.attach(p, unit)

    got, want, _ = run_both(engines, SDXL_REQUEST, attach)
    print("FaceID-Plus v2" if plus else "FaceID", assert_slice(got, want))
    assert not np.array_equal(got.images[0], _plain(engines[1])[0])


def test_instantid_with_its_controlnet_matches_forge_tpu(engines):
    """InstantID's tokens in the UNet and its keypoint ControlNet (the tiny
    cldm, a hint made from a seed) reading them in place of the text."""
    from forge_tpu.models.controlnet import ControlNetState as JState
    from forge_tpu.pipeline.ipadapter import build_instantid as jbuild
    from forge_tpu_torch.models.controlnet import ControlNetState
    from forge_tpu_torch.pipeline.ipadapter import build_instantid
    from test_torch_controlnet import _nhwc, jcfg, tcfg, tiny_controlnet_sd

    sd, cldm = tiny_instantid_sd(), tiny_controlnet_sd()
    hint = np.random.default_rng(10).uniform(size=(1, 3, 64, 64)).astype(np.float32)

    def attach(package, p):
        if package == "forge_tpu":
            state = JState(params=jax_tree(cldm), hint=_nhwc(hint), cfg=jcfg(), strength=0.8)
            hooks, state = jbuild(jax_tree(sd), face_embed()[0], controlnet_state=state)
        else:
            state = ControlNetState(params=port_tree(cldm), hint=torch.from_numpy(hint),
                                    cfg=tcfg(), strength=0.8)
            hooks, state = build_instantid(port_tree(sd), face_embed()[0], controlnet_state=state)
        p.unet_hooks, p.controlnets = hooks, [state]

    got, want, _ = run_both(engines, SDXL_REQUEST, attach)
    print("InstantID", assert_slice(got, want))
    assert not np.array_equal(got.images[0], _plain(engines[1])[0])


def test_instantid_attach_matches_forge_tpu(engines, files):
    """The API's entry: `attach` with instant_id, the tokens alone (its
    ControlNet coupling is the library call above, as in the reference)."""
    unit = {"adapter_path": files["instantid"], "face_embeds": face_embed()[0].tolist(),
            "instant_id": True, "weight": 0.9}

    def attach(package, p):
        mod = importlib.import_module(f"{package}.pipeline.ipadapter")
        mod.attach(p, unit, device="cpu") if package == "forge_tpu_torch" else mod.attach(p, unit)

    got, want, _ = run_both(engines, SDXL_REQUEST, attach)
    print("InstantID attach", assert_slice(got, want))


def test_photomaker_matches_forge_tpu(engines):
    """PhotoMaker's cond transform from a square face photo (both packages
    crop it whole) with the qformer's face embeds, the trigger in the prompt."""
    sd = tiny_photomaker_sd()
    prompt = "a photograph of a person img riding a horse"

    def attach(package, p):
        pm = importlib.import_module(f"{package}.pipeline.photomaker")
        engine = engines[PACKAGES.index(package)]
        tree = jax_tree(sd) if package == "forge_tpu" else pm.load_photomaker(sd, device="cpu")
        p.cond_transform = pm.build_cond_transform(engine, tree, prompt,
                                                   id_images=[photo(72, 72, 11)],
                                                   face_embeds=face_embed()[0])

    got, want, _ = run_both(engines, dict(SDXL_REQUEST, prompt=prompt), attach)
    print("PhotoMaker", assert_slice(got, want))
    assert not np.array_equal(got.images[0], _plain(engines[1], prompt=prompt)[0])

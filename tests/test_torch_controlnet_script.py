"""`ControlNetScript`, `list_controlnet_models` and the preprocessor registry
against forge_tpu's (CPU, f32).

A canny unit on the tiny SDXL ControlNet of tests/test_torch_controlnet.py
through a ScriptRunner holding each package's ControlNetScript, the unit in
`p.controlnet_units` and in the script's own `units`: the image at the slice
bar (80 dB) with equal infotexts, and in the port byte-equal to the same unit
through `attach_units`; a runner without units leaves the request as it is;
a unit the port refuses (a module it does not run, a missing model) raises
out of `process_images` through the script, where the reference's runner
prints a missing model's error and answers without the ControlNet.
`preprocessor_names()`, every key of the registry in order and each entry's
sliders, tags and resolution equal forge_tpu's; "none" and "canny" give
forge_tpu's maps (the other ported entries: tests/test_torch_cv2_np.py and
tests/test_torch_annotator_entries.py); the one entry the port does not
run (DWPose) raises NotImplementedError naming ROADMAP item 9, as a unit
with its module does, and a unit whose annotator has no checkpoint raises
the annotator's RuntimeError. `list_controlnet_models`
lists a directory as forge_tpu's does.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_control_units import _save  # noqa: E402
from test_torch_controlnet import tiny_controlnet_sd  # noqa: E402
from torch_controls_cases import (PACKAGES, SDXL_REQUEST, assert_slice, init_and_mask,  # noqa: E402
                                  processing, sdxl_engines)


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ControlNet")
    _save(tiny_controlnet_sd(seed=23), d / "cldm_tiny_xl.safetensors")
    return str(d)


def _unit():
    img, _ = init_and_mask(64, seed=5)
    img = img.copy()
    img[20:44, 8:30] = 250
    return dict(module="canny", model="cldm_tiny_xl", image=img, weight=1.4, guidance_end=0.8)


@pytest.fixture
def model_dirs(model_dir):
    exts = [importlib.import_module(f"{pk}.extensions.controlnet") for pk in PACKAGES]
    for ext in exts:
        ext.set_model_dirs([model_dir])
    yield exts
    for ext in exts:
        ext.set_model_dirs(["models/ControlNet", "models/controlnet"])
        ext._MODEL_CACHE.clear()


def _runner(package, **kw):
    scripts = importlib.import_module(f"{package}.runtime.scripts")
    cn = importlib.import_module(f"{package}.extensions.controlnet")
    if package == "forge_tpu_torch":
        kw["device"] = "cpu"
    runner = scripts.ScriptRunner()
    runner.register(cn.ControlNetScript(**kw))
    return runner


@pytest.mark.parametrize("where", ["p.controlnet_units", "the script's units"])
def test_controlnet_script_matches_reference(engines, model_dirs, where):
    unit = _unit()
    out = []
    for package, engine in zip(PACKAGES, engines):
        proc = processing(package)
        if where == "p.controlnet_units":
            p = proc.Processing(**SDXL_REQUEST, scripts=_runner(package))
            p.controlnet_units = [unit]
        else:
            p = proc.Processing(**SDXL_REQUEST, scripts=_runner(package, units=[unit]))
        out.append((proc.process_images(engine, p), p))
    (want, jp), (got, tp) = out
    assert len(jp.controlnets) == len(tp.controlnets) == 1
    assert_slice(got, want)
    tproc = processing("forge_tpu_torch")
    p = tproc.Processing(**SDXL_REQUEST)
    model_dirs[1].attach_units(p, [unit], "cpu")
    direct = tproc.process_images(engines[1], p)
    assert np.array_equal(direct.images[0], got.images[0])
    plain = tproc.process_images(engines[1], tproc.Processing(**SDXL_REQUEST))
    assert not np.array_equal(plain.images[0], got.images[0])


def test_controlnet_script_without_units(engines):
    """No units anywhere: the script attaches nothing, in both packages."""
    for package in PACKAGES:
        proc = processing(package)
        p = proc.Processing(**SDXL_REQUEST, scripts=_runner(package))
        p.scripts.process(p)
        assert p.controlnets is None and p.deferred_hooks is None
    assert processing("forge_tpu_torch").Processing().controlnet_units is None


@pytest.mark.parametrize("module, model, error, match", [
    ("dw_openpose_full", "cldm_tiny_xl", NotImplementedError, "item 9"),
    ("ip-adapter_clip_sdxl", "cldm_tiny_xl", NotImplementedError, "6 \\(d\\)"),
    ("canny", "no_such_model", FileNotFoundError, "no_such_model")])
def test_controlnet_script_refusals_reach_the_caller(engines, model_dirs, module, model, error,
                                                     match, capsys):
    unit = dict(_unit(), module=module, model=model)
    tproc = processing("forge_tpu_torch")
    p = tproc.Processing(**SDXL_REQUEST, scripts=_runner("forge_tpu_torch"))
    p.controlnet_units = [unit]
    with pytest.raises(error, match=match):
        tproc.process_images(engines[1], p)
    assert p.controlnets is None
    if error is FileNotFoundError:  # the reference's side: printed, and no ControlNet attached
        jproc = processing("forge_tpu")
        jp = jproc.Processing(**SDXL_REQUEST, scripts=_runner("forge_tpu"))
        jp.controlnet_units = [unit]
        jp.scripts.process(jp)
        assert jp.controlnets is None
        out = capsys.readouterr().out
        assert "script controlnet.process failed:" in out and "no_such_model" in out


def test_preprocessor_registry_matches_reference():
    from forge_tpu import preprocessors as jpre
    from forge_tpu_torch import preprocessors as tpre

    assert tpre.preprocessor_names() == jpre.preprocessor_names()
    assert len(tpre.preprocessor_names()) == 52
    assert list(tpre.PREPROCESSORS) == list(jpre.PREPROCESSORS)
    for key, want in jpre.PREPROCESSORS.items():
        got = tpre.PREPROCESSORS[key]
        assert (got.name, got.slider_a, got.slider_b, got.resolution_default, got.tags,
                got.needs_weights) == (want.name, want.slider_a, want.slider_b,
                                       want.resolution_default, want.tags, want.needs_weights)
        assert tpre.get_preprocessor(key.upper().replace("_", " ")) is got
    with pytest.raises(KeyError) as want:
        jpre.get_preprocessor("no such")
    with pytest.raises(KeyError) as got:
        tpre.get_preprocessor("no such")
    assert str(got.value) == str(want.value)


PORTED = ("none", "invert", "canny", "blur_gaussian", "shuffle", "lineart_standard",
          "scribble_xdog", "threshold", "tile_resample", "recolor_luminance",
          "recolor_intensity", "t2ia_color_grid", "threshold_binary", "reference_only",
          "reference_adain", "reference_adain+attn", "CLIP-G (Revision)",
          "CLIP-G (Revision ignore prompt)", "inpaint_global_harmonious", "inpaint_only",
          "inpaint_only+lama", "depth_midas", "openpose", "openpose_hand", "openpose_face",
          "openpose_faceonly", "openpose_full", "softedge_hed", "softedge_hedsafe", "scribble_hed",
          "lineart_realistic", "lineart_coarse", "lineart_anime", "softedge_pidinet",
          "softedge_pidisafe", "scribble_pidinet", "mlsd", "depth_anything_v2", "softedge_teed",
          "lineart_anime_denoise", "depth_leres", "seg_anime_face", "normalbae",
          "mediapipe_face", "seg_ufade20k", "depth_zoe", "depth_marigold",
          "densepose (pruple bg & purple torso)", "densepose_parula (black bg & blue torso)",
          "seg_ofade20k", "seg_ofcoco")
PASS_THROUGH = PORTED[13:20]  # the reference, Revision and inpaint entries


@pytest.mark.parametrize("name", ["none", "canny"])
def test_ported_entries_match_reference(name):
    from forge_tpu import preprocessors as jpre
    from forge_tpu_torch import preprocessors as tpre

    img = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img[10:30, 20:40] = 250
    for res, a, b in ((32, 0, 0), (48, 50, 150)):
        want = jpre.get_preprocessor(name)(img, res, a, b)
        got = tpre.get_preprocessor(name)(img, res, a, b)
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_unported_entries_refused():
    from forge_tpu_torch import preprocessors as tpre
    from forge_tpu_torch.extensions import controlnet as tcn

    img = np.zeros((16, 16, 3), np.uint8)
    assert [n for n in tpre.preprocessor_names() if tpre.PREPROCESSORS[n].ported] == list(PORTED)
    refused = [n for n in tpre.preprocessor_names() if n not in PORTED]
    assert len(refused) == 52 - len(PORTED)
    for name in refused:
        with pytest.raises(NotImplementedError, match="item 9"):
            tpre.get_preprocessor(name)(img, 16, 0, 0)
    for name in PASS_THROUGH:  # the image as it is, as the reference's entries give it
        assert np.array_equal(tpre.get_preprocessor(name)(img, 16, 0, 0),
                              tpre.get_preprocessor("none")(img, 16, 0, 0))
    p = processing("forge_tpu_torch").Processing(**SDXL_REQUEST)
    for module in ("dw_openpose_full",):
        with pytest.raises(NotImplementedError, match="item 9"):
            tcn.attach_units(p, [dict(module=module, model="x", image=img)], "cpu")


def test_list_controlnet_models_matches_reference(tmp_path, monkeypatch):
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu_torch.extensions import controlnet as tcn

    for d, names in (("a", ("b_model.safetensors", "a_model.pth", "readme.md")),
                     ("b", ("c.ckpt", "d.bin", "e.pt"))):
        (tmp_path / d).mkdir()
        for n in names:
            (tmp_path / d / n).write_bytes(b"")
    dirs = [str(tmp_path / "a"), str(tmp_path / "missing"), str(tmp_path / "b")]
    for mod in (jcn, tcn):
        monkeypatch.setattr(mod, "_MODEL_DIRS", dirs)
    assert tcn.list_controlnet_models() == jcn.list_controlnet_models() == [
        "a_model", "b_model", "c", "d", "e"]

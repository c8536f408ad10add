"""The annotators in a request, through both packages (CPU, f32): the tiny
SDXL and tiny ControlNet of tests/test_torch_controlnet_script.py, the tiny
annotators of tests/torch_annotator_cases.py.

A depth_anything_v2 unit through each package's ControlNetScript, and an
openpose_full unit through each server's always-on `controlnet` script
(POST /sdapi/v1/txt2img): the hints (the unit's map at the request's size)
differ by at most one level in at most 0.5 % of their pixels, the images
meet the 40 dB bar (ROADMAP's), and the unit moved the image.
GET /controlnet/module_list answers the same list in both, which holds the
newly ported names; a unit with a module still unported is refused with
NotImplementedError naming ROADMAP item 9.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_api import _call, _png_b64, _serve  # noqa: E402
from test_torch_control_units import _save  # noqa: E402
from test_torch_controlnet import tiny_controlnet_sd  # noqa: E402
from test_torch_sdxl import _psnr  # noqa: E402
from torch_annotator_cases import image, install, write_all  # noqa: E402
from torch_controls_cases import PACKAGES, SDXL_REQUEST, processing, sdxl_engines  # noqa: E402

BAR = 40.0  # dB at f32


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = write_all(str(tmp_path_factory.mktemp("annotators")))
    cn_dir = tmp_path_factory.mktemp("ControlNet")
    _save(tiny_controlnet_sd(seed=24), cn_dir / "cldm_tiny_xl.safetensors")
    exts = [importlib.import_module(f"{pk}.extensions.controlnet") for pk in PACKAGES]
    for ext in exts:
        ext.set_model_dirs([str(cn_dir)])
    with install(root):
        yield sdxl_engines()
    for ext in exts:
        ext.set_model_dirs(["models/ControlNet", "models/controlnet"])
        ext._MODEL_CACHE.clear()


def _hint(state, package):
    h = state.hint
    h = h.detach().cpu().numpy() if hasattr(h, "detach") else np.asarray(h)
    return h[0].transpose(1, 2, 0) if package == "forge_tpu_torch" else h[0]


def _levels_close(got, want):
    d = np.abs(np.rint(got * 255.0) - np.rint(want * 255.0))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())


def test_depth_anything_unit_through_controlnet_script(setup):
    unit = dict(module="depth_anything_v2", model="cldm_tiny_xl", image=image(7, 64, 64),
                weight=1.4, guidance_end=0.8)
    out = []
    for package, engine in zip(PACKAGES, setup):
        scripts = importlib.import_module(f"{package}.runtime.scripts")
        cn = importlib.import_module(f"{package}.extensions.controlnet")
        runner = scripts.ScriptRunner()
        runner.register(cn.ControlNetScript(**({"device": "cpu"} if package == "forge_tpu_torch"
                                               else {})))
        proc = processing(package)
        p = proc.Processing(**SDXL_REQUEST, scripts=runner)
        p.controlnet_units = [unit]
        out.append((proc.process_images(engine, p), p))
    (want, jp), (got, tp) = out
    _levels_close(_hint(tp.controlnets[0], "forge_tpu_torch"), _hint(jp.controlnets[0],
                                                                        "forge_tpu"))
    assert _psnr(got.images[0], want.images[0]) >= BAR
    tproc = processing("forge_tpu_torch")
    plain = tproc.process_images(setup[1], tproc.Processing(**SDXL_REQUEST))
    assert not np.array_equal(plain.images[0], got.images[0])


@pytest.fixture(scope="module")
def servers(setup):
    from forge_tpu.api.server import create_server as jcreate
    from forge_tpu.runtime.models import ModelManager as JManager
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.runtime.models import ModelManager

    jmm, tmm = JManager(), ModelManager(device="cpu")
    jmm.set_engine(setup[0])
    tmm.set_engine(setup[1])
    jsrv, tsrv = jcreate(jmm, "127.0.0.1", 0), create_server(tmm, "127.0.0.1", 0)
    yield _serve(jsrv), _serve(tsrv)
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.server_close()
    tmm.close()


def test_openpose_full_unit_through_the_api(servers):
    import base64
    import io

    from PIL import Image

    unit = dict(module="openpose_full", model="cldm_tiny_xl", image=_png_b64(image(8, 96, 96)),
                weight=1.2, processor_res=96)
    images = []
    for base in servers:
        payload = dict(SDXL_REQUEST, alwayson_scripts={"controlnet": {"args": [unit]}})
        status, body, _ = _call(base, "/sdapi/v1/txt2img", payload)
        assert status == 200, body
        images.append(np.asarray(Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
                                 .convert("RGB")))
    assert _psnr(images[1], images[0]) >= BAR
    status, body, _ = _call(servers[1], "/sdapi/v1/txt2img", dict(SDXL_REQUEST))
    plain = np.asarray(Image.open(io.BytesIO(base64.b64decode(body["images"][0]))).convert("RGB"))
    assert not np.array_equal(plain, images[1])


def test_module_list_and_refusals(servers):
    from forge_tpu_torch.extensions.controlnet import build_unit_state

    lists = [_call(base, "/controlnet/module_list")[1]["module_list"] for base in servers]
    assert lists[0] == lists[1]
    for name in ("invert", "depth_midas", "depth_anything_v2", "openpose_full", "softedge_hed",
                 "softedge_pidinet", "softedge_teed", "lineart_anime", "lineart_anime_denoise",
                 "mlsd", "normalbae", "t2ia_color_grid", "threshold_binary"):
        assert name in lists[1]
    unit = dict(module="dw_openpose_full", model="cldm_tiny_xl", image=image(9, 32, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        build_unit_state(unit, 64, 64, device="cpu")

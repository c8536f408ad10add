"""The API's script surface (forge_tpu_torch/api/server.py) against
forge_tpu's server, both over the tiny SDXL of tests/test_torch_sdxl.py
(CPU, f32), and the events the port fires outside process_images.

GET /sdapi/v1/scripts and /sdapi/v1/script-info answer what forge_tpu's
answer (a Script registered on both packages' txt2img runner listed too);
POST txt2img with `script_name` "Prompt matrix" and positional
`script_args`, and img2img with "Loopback", give images at the slice bar
(80 dB) and equal infotexts; an img2img inpaint with the always-on "Soft
inpainting" likewise, its infotext naming it; /sdapi/v1/xyz-grid's grid
meets the bar outside the label strips and equals the port's own
`run_xyz_grid` byte for byte; an unknown script_name answers 422 in both,
and an axis value the port refuses (steps 7.5) answers 422 where forge_tpu
truncates it. `model_loaded` (ModelManager.set_engine), `app_started`
(create_server), `infotext_pasted` (parse_generation_parameters) and
`script_unloaded` (serve, once it stops) fire in both packages as in the
reference.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64
import importlib
import io
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from test_torch_api import _call, _png_b64, _serve  # noqa: E402
from test_torch_sdxl import REQUEST, _psnr  # noqa: E402
from torch_controls_cases import PACKAGES, SLICE_BAR, init_and_mask, sdxl_engines  # noqa: E402

TXT2IMG = dict(REQUEST)


@pytest.fixture(scope="module")
def servers():
    from forge_tpu.api.server import create_server as jcreate
    from forge_tpu.runtime.models import ModelManager as JManager
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.runtime.models import ModelManager
    from forge_tpu_torch.runtime.options import opts

    jeng, teng = sdxl_engines()
    jmm, tmm = JManager(), ModelManager(device="cpu")
    jmm.set_engine(jeng)
    tmm.set_engine(teng)
    jsrv, tsrv = jcreate(jmm, "127.0.0.1", 0), create_server(tmm, "127.0.0.1", 0)
    params_txt = opts.get("save_write_params_txt")
    opts.set("save_write_params_txt", False)
    yield _serve(jsrv), _serve(tsrv), teng
    opts.set("save_write_params_txt", params_txt)
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.server_close()
    tmm.close()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _both(servers, route, payload, status=200):
    answers = []
    for base in servers[:2]:
        got, body, _ = _call(base, route, payload)
        assert got == status, body
        answers.append(body)
    return answers


def _scripts(package):
    return importlib.import_module(f"{package}.runtime.scripts")


def test_script_listings_match_forge_tpu(servers):
    for package in PACKAGES:
        mod = _scripts(package)
        mod.scripts_txt2img.register(type("Listed", (mod.Script,), {"name": "listed"})())
    try:
        want, got = _both(servers, "/sdapi/v1/scripts", None)
        assert got == want and "listed" in got["txt2img"] and "listed" not in got["img2img"]
        assert "Loopback" in got["img2img"] and "Loopback" not in got["txt2img"]
        assert "soft inpainting" in got["txt2img"]
    finally:
        for package in PACKAGES:
            _scripts(package).scripts_txt2img.scripts.pop()
    want, got = _both(servers, "/sdapi/v1/script-info", None)
    assert got == want and len(got) == 2 * 11 + 8


def _assert_answers(want, got, n):
    assert len(got["images"]) == len(want["images"]) == n
    for w, g in zip(want["images"], got["images"]):
        assert _psnr(_decode(g), _decode(w)) >= SLICE_BAR
    wi, gi = json.loads(want["info"]), json.loads(got["info"])
    assert [t.split("Version:")[0] for t in gi["infotexts"]] == [
        t.split("Version:")[0] for t in wi["infotexts"]]
    return gi


def test_txt2img_script_name_matches_forge_tpu(servers):
    payload = dict(TXT2IMG, prompt="a castle|on a hill|at night", script_name="Prompt matrix",
                   script_args=[False, True, "positive", "comma", 2])
    want, got = _both(servers, "/sdapi/v1/txt2img", payload)
    info = _assert_answers(want, got, 5)
    assert info["all_seeds"] == [1, 2, 3, 4]
    assert _decode(got["images"][0]).shape == (130, 130, 3)


def test_img2img_scripts_match_forge_tpu(servers):
    init, mask = init_and_mask()
    payload = dict(TXT2IMG, init_images=[_png_b64(init)], denoising_strength=0.6,
                   script_name="loopback", script_args=[2, 0.5])
    _assert_answers(*_both(servers, "/sdapi/v1/img2img", payload), 2)
    payload = dict(TXT2IMG, init_images=[_png_b64(init)], denoising_strength=0.75, mask_blur=2,
                   mask=_png_b64(np.repeat((mask * 255).astype(np.uint8)[..., None], 3, -1)),
                   alwayson_scripts={"Soft inpainting": {"args": [{"Schedule bias": 1.5}]}})
    info = _assert_answers(*_both(servers, "/sdapi/v1/img2img", payload), 1)
    assert "Soft inpainting: True, Soft inpainting schedule bias: 1.5" in info["infotexts"][0]


def test_unknown_script_name_answers_422(servers):
    want, got = _both(servers, "/sdapi/v1/txt2img", dict(TXT2IMG, script_name="No such"), 422)
    assert got == want and "unknown script 'No such'" in got["detail"]


def test_xyz_grid_matches_forge_tpu(servers):
    from forge_tpu_torch.extensions.xyz_grid import Axis, run_xyz_grid
    from forge_tpu_torch.pipeline.processing import Processing

    axes = dict(x_axis={"field": "cfg_scale", "values": [5, 7]},
                y_axis={"field": "prompt_sr", "values": ["astronaut", "cat"],
                        "search": "astronaut"})
    want, got = _both(servers, "/sdapi/v1/xyz-grid", dict(TXT2IMG, **axes))
    g, w = _decode(got["images"][0]), _decode(want["images"][0])
    outside = np.ones(g.shape[:2], bool)
    outside[0:15], outside[64:79] = False, False
    assert g.shape == w.shape == (128, 128, 3) and _psnr(g[outside], w[outside]) >= SLICE_BAR
    own = run_xyz_grid(servers[2], Processing(**TXT2IMG), Axis("cfg_scale", [5, 7]),
                       Axis("prompt_sr", ["astronaut", "cat"], search="astronaut"))[0]
    assert np.array_equal(g, own)
    bad = dict(TXT2IMG, x_axis={"field": "steps", "values": [2, 7.5]})
    assert _call(servers[0], "/sdapi/v1/xyz-grid", bad)[0] == 200  # forge_tpu: steps 7
    status, body, _ = _call(servers[1], "/sdapi/v1/xyz-grid", bad)
    assert status == 422 and "truncated to 7" in body["detail"]
    status, body, _ = _call(servers[1], "/sdapi/v1/xyz-grid", dict(TXT2IMG))
    assert status == 422 and "x_axis" in body["detail"]


def test_events_fire_as_in_forge_tpu(monkeypatch):
    """model_loaded with the engine, app_started with the server,
    infotext_pasted with (text, the parsed dict), which a callback may edit."""
    text = "a cat\nNegative prompt: blurry\nSteps: 3, Sampler: Euler a, CFG scale: 7, Seed: 5"
    for package in PACKAGES:
        mod = _scripts(package)
        seen = []
        mod.on("model_loaded", lambda e: seen.append(("model_loaded", e)))
        mod.on("app_started", lambda s: seen.append(("app_started", s)))
        mod.on("infotext_pasted", lambda x, res: (seen.append(("infotext_pasted", x)),
                                                  res.update(Steps="9")))
        try:
            manager = importlib.import_module(f"{package}.runtime.models").ModelManager()
            engine = object()
            manager.set_engine(engine)
            server = importlib.import_module(f"{package}.api.server").create_server(
                manager, "127.0.0.1", 0)
            server.server_close()
            parsed = importlib.import_module(f"{package}.pipeline.infotext")\
                .parse_generation_parameters(text)
        finally:
            mod.clear()
            if hasattr(manager, "close"):
                manager.close()
        assert seen == [("model_loaded", engine), ("app_started", server),
                        ("infotext_pasted", text)], package
        assert parsed["Steps"] == "9"


def test_serve_fires_script_unloaded(monkeypatch):
    from forge_tpu_torch.api import server as api
    from forge_tpu_torch.runtime import queue as queue_mod
    from forge_tpu_torch.runtime.models import ModelManager

    made, seen = [], []
    real_create = api.create_server
    monkeypatch.setattr(api, "create_server",
                        lambda *a, **k: made.append(real_create(*a, **k)) or made[-1])
    fresh = queue_mod.WorkQueue()  # serve() stops the queue it ends with
    monkeypatch.setattr(api, "work_queue", fresh)
    _scripts("forge_tpu_torch").on("script_unloaded", lambda: seen.append("unloaded"))
    try:
        with ModelManager(device="cpu") as manager:
            thread = threading.Thread(target=api.serve, args=(manager, "127.0.0.1", 0),
                                      daemon=True)
            thread.start()
            deadline = time.time() + 30
            while not made and time.time() < deadline:
                time.sleep(0.01)
            assert seen == []
            made[0].shutdown()
            thread.join(30)
    finally:
        _scripts("forge_tpu_torch").clear()
    assert not thread.is_alive() and seen == ["unloaded"]

"""The REST API's always-on scripts against forge_tpu's, over HTTP (CPU, f32).

Both servers bind port 0 on 127.0.0.1 over the tiny SDXL of
tests/test_torch_sdxl.py, one engine in each package. The same txt2img
payload (64², DPM++ 2M Karras, 3 steps, CFG 7) with each `alwayson_scripts`
goes to both: a ControlNet reference_only unit, an IP-Adapter FaceID file
with a face embedding, and one each of the PR 16–17 extensions that take
only JSON (FreeU, PAG, dynamic thresholding, Kohya HRFix) and "lora"
(accepted, nothing to do). The decoded images reach the slice bar (80 dB),
the infotexts are equal, and each image is unlike the payload's without
scripts (FreeU's: the dispatch fixes its model channels at SDXL's 320, which
the tiny UNet's 32 never match, so it acts on neither side). The two
together show the IP layer counter's fault from both sides; the port's PNG
is its own `process_images` image, pixel for pixel, with its infotext as
"parameters". An unknown always-on script (a selectable script's name too)
and what an extension refuses answer 422.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from forge_tpu_torch.core.save import save_safetensors  # noqa: E402
from test_torch_api import _call, _png_b64, _serve  # noqa: E402
from test_torch_sdxl import REQUEST, _psnr  # noqa: E402
from torch_controls_cases import SLICE_BAR, sdxl_engines  # noqa: E402
from torch_image_prompt_cases import REF_WEIGHT, face_embed, photo, tiny_faceid_sd  # noqa: E402

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


@pytest.fixture(scope="module")
def faceid_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("faceid") / "faceid.safetensors")
    save_safetensors(tiny_faceid_sd(), path)
    return path


def _decode(answer):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(answer["images"][0]))).convert("RGB"))


def _both(servers, payload):
    jbase, tbase, _ = servers
    answers = []
    for base in (jbase, tbase):
        status, body, _ = _call(base, "/sdapi/v1/txt2img", payload)
        assert status == 200, body
        answers.append(body)
    return answers


@pytest.fixture(scope="module")
def plain(servers):
    return _decode(_both(servers, TXT2IMG)[1])


def _scripts(name, faceid_file):
    unit = {"module": "reference_only", "image": _png_b64(photo(80, 72, 7)), "weight": REF_WEIGHT,
            "threshold_a": 0.5}
    reference = {"controlnet": {"args": [unit]}}
    faceid = {"IP-Adapter": {"args": [{"adapter_path": faceid_file, "weight": 0.8,
                                       "face_embeds": face_embed()[0].tolist()}]}}
    return {
        "controlnet reference_only": reference,
        "ip-adapter faceid": faceid,
        "reference_only + faceid": {**reference, **faceid},
        "freeu": {"FreeU": {"args": [1.3, 1.4, 0.9, 0.2]}},
        "pag": {"PAG": {"args": [{"scale": 3.0}]}},
        "dynamic thresholding": {"Dynamic Thresholding (CFG Scale Fix)": {
            "args": [{"mimic_scale": 5.0, "threshold_percentile": 0.95}]}},
        "kohya hrfix": {"Kohya HRFix": {"args": [{"block_number": 1, "downscale_factor": 1.5,
                                                   "end_percent": 0.5}]}},
    }[name]


@pytest.mark.parametrize("name", ["controlnet reference_only", "ip-adapter faceid", "freeu",
                                  "pag", "dynamic thresholding", "kohya hrfix"])
def test_alwayson_scripts_match_forge_tpu(servers, faceid_file, plain, name):
    payload = dict(TXT2IMG, alwayson_scripts=_scripts(name, faceid_file))
    if name == "dynamic thresholding":
        payload["cfg_scale"] = 12.0
    want, got = _both(servers, payload)
    g, w = _decode(got), _decode(want)
    value = _psnr(g, w)
    print(name, value)
    assert value >= SLICE_BAR
    assert [t.split("Version:")[0] for t in json.loads(got["info"])["infotexts"]] == [
        t.split("Version:")[0] for t in json.loads(want["info"])["infotexts"]]
    assert np.array_equal(g, plain) == (name == "freeu")


def test_reference_only_with_faceid_from_both_sides(servers, faceid_file, monkeypatch):
    """The fault: the reference's IP-Adapter picks its layers by a counter
    that only grows (`forge_tpu/pipeline/ipadapter.py:127-139`), so in one
    trace the reference-only recording pass takes the adapter's layers and
    the CFG pass runs past them: its image is, byte for byte here, the
    port's with FaceID in the recording pass alone. The port picks layers by
    `attn_index` and applies FaceID in both passes."""
    from forge_tpu_torch.api.server import _apply_alwayson_scripts
    from forge_tpu_torch.pipeline import reference_only
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    scripts = _scripts("reference_only + faceid", faceid_file)
    want, got = _both(servers, dict(TXT2IMG, alwayson_scripts=scripts))
    build = reference_only.build_reference_hooks

    def recording_pass_only(ref, base, rows, skip_uncond):
        capture, consume = build(ref, base, rows, skip_uncond)
        consume.pop("attn2_replace_all")
        return capture, consume

    monkeypatch.setattr(reference_only, "build_reference_hooks", recording_pass_only)
    p = Processing(**TXT2IMG)
    _apply_alwayson_scripts(p, scripts, "cpu", torch.float32)
    like_reference = process_images(servers[2], p).images[0]
    value, apart = _psnr(like_reference, _decode(want)), _psnr(_decode(got), _decode(want))
    print("reference-only + FaceID", value, apart)
    assert value >= SLICE_BAR and apart < 60.0


def test_api_image_is_process_images_image(servers, faceid_file):
    """The chip's request: reference_only and FaceID over HTTP give the PNG
    of `process_images` on the same request, its infotext as "parameters"."""
    from forge_tpu_torch.api.server import _apply_alwayson_scripts
    from forge_tpu_torch.pipeline import images as images_mod
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    _, tbase, teng = servers
    scripts = _scripts("reference_only + faceid", faceid_file)
    status, body, _ = _call(tbase, "/sdapi/v1/txt2img", dict(TXT2IMG, alwayson_scripts=scripts))
    assert status == 200
    pixels, text = images_mod.decode_png(base64.b64decode(body["images"][0]))
    p = Processing(**TXT2IMG)
    _apply_alwayson_scripts(p, scripts, "cpu", torch.float32)
    want = process_images(teng, p)
    assert np.array_equal(images_mod.to_rgb(pixels), want.images[0])
    assert text["parameters"] == want.infotexts[0]
    assert "Reference: reference_only" in want.infotexts[0]


def test_lora_script_is_accepted(servers, plain):
    _, got = _both(servers, dict(TXT2IMG, alwayson_scripts={"LoRA": {"args": []}}))
    assert np.array_equal(_decode(got), plain)


@pytest.mark.parametrize("scripts,detail", [
    ({"x/y/z plot": {"args": [{}]}}, "unknown alwayson_scripts 'x/y/z plot'"),
    ({"Prompt matrix": {"args": []}}, "unknown alwayson_scripts 'Prompt matrix'"),
    ({"no such script": {"args": []}}, "unknown alwayson_scripts.*supported:.* controlnet,"),
    ({"controlnet": {"args": [{"module": "ip-adapter_clip_sdxl", "image": "x"}]}},
     "'ip-adapter' always-on script"),
])
def test_alwayson_scripts_refused(servers, scripts, detail):
    import re

    _, tbase, _ = servers
    status, body, _ = _call(tbase, "/sdapi/v1/txt2img", dict(TXT2IMG, alwayson_scripts=scripts))
    assert status == 422 and re.search(detail, body["detail"]), body

"""The port's REST API against forge_tpu's, over HTTP (CPU, f32).

Both servers bind port 0 on 127.0.0.1: forge_tpu's `create_server` over
`make_tiny_engine(0)`, the port's over the same checkpoint
(tests/fixtures.py `make_sd15_checkpoint(0)`). The same txt2img payload
(32², Euler a, 3 steps, CFG 7) and img2img payload (a seeded 64×48 init
image, a box mask, "original" fill, strength 0.6, `vae_always_tiled` with
the tiles made small on both engines) go to both: the decoded images reach
PSNR ≥ 40 dB, `info`'s seeds and infotexts are equal, and the port's PNG
carries the infotext as "parameters". GET samplers, schedulers and
latent-upscale-modes answer the same JSON. An unported field answers 422,
a bundled Space the port does not
run yet 501, a JPEG 415; progress, interrupt, options, the model
manager's routes, basic auth and CORS answer as forge_tpu's do, and the
launcher leaves server-stop off unless `--api-server-stop` is passed.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64
import functools
import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402

TXT2IMG = {"prompt": "a cat", "negative_prompt": "blurry", "seed": 5, "subseed": 11, "steps": 3,
           "width": 32, "height": 32, "sampler_name": "Euler a", "cfg_scale": 7.0}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _call(base, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json",
                                                     **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw else None), dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else None), dict(e.headers)


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _raw_png(w, h, idat):
    """An 8-bit RGB PNG of IHDR size w×h around the IDAT bytes `idat`."""
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _small_tiles(eng):
    eng.decode_first_stage_tiled = functools.partial(eng.decode_first_stage_tiled,
                                                     tile=4, overlap=1)
    eng.encode_first_stage_tiled = functools.partial(eng.encode_first_stage_tiled,
                                                     tile=32, overlap=8)
    return eng


@pytest.fixture(scope="module")
def servers():
    from forge_tpu.api.server import create_server as jcreate
    from forge_tpu.runtime.models import ModelManager as JManager
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.runtime.models import ModelManager
    from forge_tpu_torch.runtime.options import opts

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    jmm, tmm = JManager(), ModelManager(device="cpu")
    jmm.set_engine(_small_tiles(make_tiny_engine(0)))
    tmm.set_engine(_small_tiles(teng))
    jsrv, tsrv = jcreate(jmm, "127.0.0.1", 0), create_server(tmm, "127.0.0.1", 0)
    params_txt = opts.get("save_write_params_txt")
    opts.set("save_write_params_txt", False)
    yield _serve(jsrv), _serve(tsrv)
    opts.set("save_write_params_txt", params_txt)
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.server_close()
    tmm.close()


@pytest.fixture(scope="module")
def txt2img(servers):
    """Both servers' answers to TXT2IMG, previews every step on the port's."""
    jbase, tbase = servers
    want = _call(jbase, "/sdapi/v1/txt2img", TXT2IMG)
    got = _call(tbase, "/sdapi/v1/txt2img",
                dict(TXT2IMG, override_settings={"show_progress_every_n_steps": 1}))
    progress = _call(tbase, "/sdapi/v1/progress")
    return want, got, progress


def _image(answer):
    from forge_tpu_torch.pipeline.images import decode_png

    return decode_png(base64.b64decode(answer["images"][0]))


def test_txt2img_matches_forge_tpu(txt2img):
    (jst, want, _), (tst, got, _), _ = txt2img
    assert jst == tst == 200
    pixels, text = _image(got)
    ref = np.asarray(Image.open(io.BytesIO(base64.b64decode(want["images"][0]))).convert("RGB"))
    assert pixels.shape == ref.shape == (32, 32, 3)
    assert _psnr(pixels, ref) >= 40.0, _psnr(pixels, ref)
    jinfo, tinfo = json.loads(want["info"]), json.loads(got["info"])
    for key in ("seed", "all_seeds", "all_subseeds", "infotexts"):
        assert tinfo[key] == jinfo[key], key
    assert text == {"parameters": tinfo["infotexts"][0]}
    assert got["parameters"]["prompt"] == "a cat"


def test_progress_after_a_request(txt2img):
    """The request ran between state.begin and state.end: 3 of 3 steps, a
    preview at each (the port's PNG, at latent size), no job left."""
    from forge_tpu_torch.pipeline.images import decode_png

    status, prog, _ = txt2img[2]
    assert status == 200 and prog["progress"] == 1.0 and prog["eta_relative"] == 0.0
    assert {k: prog["state"][k] for k in ("job", "sampling_step", "sampling_steps", "interrupted",
                                          "skipped")} == {
        "job": "", "sampling_step": 3, "sampling_steps": 3, "interrupted": False,
        "skipped": False}
    pixels, _ = decode_png(base64.b64decode(prog["current_image"]))
    assert pixels.shape == (4, 4, 3)


def test_img2img_matches_forge_tpu(servers):
    """Inpainting over HTTP under `vae_always_tiled`: both encode and decode
    in tiles (made small on both engines)."""
    jbase, tbase = servers
    init = _png_b64(np.random.default_rng(8).integers(0, 256, (48, 64, 3), dtype=np.uint8))
    mask = np.zeros((48, 64, 3), np.uint8)
    mask[12:36, 16:48] = 255
    payload = dict(TXT2IMG, prompt="a dog", seed=9, width=64, height=48, init_images=[init],
                   mask=_png_b64(mask), denoising_strength=0.6, inpainting_fill=1,
                   override_settings={"vae_always_tiled": True})
    jst, want, _ = _call(jbase, "/sdapi/v1/img2img", payload)
    tst, got, _ = _call(tbase, "/sdapi/v1/img2img", payload)
    assert jst == tst == 200, got
    pixels, text = _image(got)
    ref = np.asarray(Image.open(io.BytesIO(base64.b64decode(want["images"][0]))).convert("RGB"))
    assert pixels.shape == ref.shape == (48, 64, 3)
    assert _psnr(pixels, ref) >= 40.0, _psnr(pixels, ref)
    jinfo, tinfo = json.loads(want["info"]), json.loads(got["info"])
    assert tinfo == jinfo and text == {"parameters": tinfo["infotexts"][0]}
    assert "Denoising strength: 0.6" in tinfo["infotexts"][0]


@pytest.mark.parametrize("route", ["samplers", "schedulers", "latent-upscale-modes"])
def test_listings_match_forge_tpu(servers, route):
    jbase, tbase = servers
    want, got = _call(jbase, f"/sdapi/v1/{route}"), _call(tbase, f"/sdapi/v1/{route}")
    assert want[0] == got[0] == 200 and got[1] == want[1] and len(got[1]) > 5


def test_refusals(servers, monkeypatch):
    """An unported field 422 with Processing's text; a field of the reference
    the port lacks passes at the port's behaviour (tiling off); an
    unknown script 422 (a known one and soft inpainting are answered,
    tests/test_torch_scripts_api.py; `save_images` is answered,
    tests/test_torch_surface_api.py); a bundled diffusion Space without its
    checkpoint the reference's 500 naming the child's exit; a JPEG 415, a
    PNG past the reader's pixel limit 413 and a truncated one 422; an
    unknown route 404; an unported option 422."""
    _, tbase = servers
    status, body, _ = _call(tbase, "/sdapi/v1/txt2img", dict(TXT2IMG, tiling=True))
    assert status == 422 and "tiling" in body["detail"] and "not ported" in body["detail"]
    status, _, _ = _call(tbase, "/sdapi/v1/txt2img", dict(TXT2IMG, steps=1, tiling=False,
                                                          restore_faces=False))
    assert status == 200
    for key, value, detail in (("script_name", "x/y/z plot", "unknown script 'x/y/z plot'"),
                               ("alwayson_scripts", {"soft inpainting x": {}}, "alwayson_scripts")):
        status, body, _ = _call(tbase, "/sdapi/v1/txt2img", dict(TXT2IMG, **{key: value}))
        assert status == 422 and detail in body["detail"], (key, body)
    status, body, _ = _call(tbase, "/sdapi/v1/interrogate", {"image": ""})
    assert status == 404 and body["detail"] == "Image not found"
    # a bundled diffusion Space without its checkpoint: the child exits in setup, and the
    # route answers the reference's 500 (forge_tpu's manager given an OS-picked port: its scan
    # from 7870 can take a port another test's Space is about to open, and connect to that)
    from forge_tpu.runtime import spaces as jspaces
    from forge_tpu_torch.runtime.spaces import find_free_port

    monkeypatch.setattr(jspaces, "find_free_port", lambda host="127.0.0.1": find_free_port(host))
    launched = [_call(base, "/sdapi/v1/spaces/launch", {"name": "forge_space_iclight"})[:2]
                for base in servers]
    assert launched[1] == launched[0] == (500, {"detail": "space 'forge_space_iclight' "
                                                          "exited with 1"})
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "JPEG")
    status, body, _ = _call(tbase, "/sdapi/v1/img2img", dict(
        TXT2IMG, init_images=[base64.b64encode(buf.getvalue()).decode()]))
    assert status == 415 and "JPEG" in body["detail"]
    big = _raw_png(20000, 20000, zlib.compress(b""))  # refused before its data inflates
    truncated = _raw_png(8, 8, zlib.compress(b"\0" * 10))
    for data, want in ((big, 413), (truncated, 422)):
        status, body, _ = _call(tbase, "/sdapi/v1/img2img", dict(
            TXT2IMG, init_images=[base64.b64encode(data).decode()]))
        assert status == want, (want, body)
    assert _call(tbase, "/sdapi/v1/no-such-route")[0] == 404
    status, body, _ = _call(tbase, "/sdapi/v1/options", {"cross_attention_optimization": "x"})
    assert status == 422 and "not ported" in body["detail"]


def test_options_png_info_and_status_routes(servers, txt2img):
    from forge_tpu_torch.runtime.options import opts

    _, tbase = servers
    status, options, _ = _call(tbase, "/sdapi/v1/options")
    assert status == 200 and options["show_progress_type"] == "Approx cheap"
    assert set(options) == set(opts._registry)
    try:
        assert _call(tbase, "/sdapi/v1/options", {"s_noise": 0.9})[0] == 200
        assert _call(tbase, "/sdapi/v1/options")[1]["s_noise"] == 0.9
    finally:
        opts.set("s_noise", 1.0)
    image = txt2img[1][1]["images"][0]
    status, info, _ = _call(tbase, "/sdapi/v1/png-info", {"image": image})
    assert status == 200 and info["info"] == json.loads(txt2img[1][1]["info"])["infotexts"][0]
    assert info["parameters"]["Seed"] == "5" and info["parameters"]["Prompt"] == "a cat"
    assert _call(tbase, "/sdapi/v1/parse-infotext", {"text": info["info"]})[1] == {
        "parameters": info["parameters"]}
    assert _call(tbase, "/sdapi/v1/token-count", {"text": "a cat AND a dog"})[1] == {
        "count": 2, "max": 75}
    memory = _call(tbase, "/sdapi/v1/memory")[1]
    assert memory["ram"]["total"] >= memory["ram"]["free"] > 0 and "cuda" not in memory
    assert _call(tbase, "/internal/ping") == (200, {}, _call(tbase, "/internal/ping")[2])
    assert _call(tbase, "/internal/sysinfo")[1]["torch"] == torch.__version__
    # an interrupt while idle is cleared by the next request's begin
    assert _call(tbase, "/sdapi/v1/interrupt", {})[:2] == (200, {})
    status, answer, _ = _call(tbase, "/sdapi/v1/txt2img", dict(TXT2IMG, steps=2))
    assert status == 200 and _call(tbase, "/sdapi/v1/progress")[1]["state"]["sampling_step"] == 2


def test_model_manager_routes(tmp_path, monkeypatch):
    """The checkpoint directory's files list; POST options with
    sd_model_checkpoint loads one through the manager (on the CPU here), with
    its name and hash for the infotext; reload keeps the engine, unload drops
    it; basic auth and CORS as the reference's."""
    from forge_tpu_torch.api import server as api
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.runtime.models import CheckpointInfo, ModelManager
    from forge_tpu_torch.runtime.options import opts

    ckpts = tmp_path / "Stable-diffusion"
    ckpts.mkdir()
    save_safetensors(make_sd15_checkpoint(0), str(ckpts / "tiny.safetensors"))
    mm = ModelManager(checkpoint_dirs=[str(ckpts)], vae_dirs=[str(tmp_path / "VAE")],
                      device="cpu")
    monkeypatch.setitem(api.CMD_FLAGS, "cors_allow_origins", "http://ok.example")
    srv = api.create_server(mm, "127.0.0.1", 0, api_auth="user:pass")
    base = _serve(srv)
    auth = {"Authorization": "Basic " + base64.b64encode(b"user:pass").decode()}
    try:
        assert _call(base, "/internal/ping")[0] == 401
        assert _call(base, "/internal/ping", headers={"Authorization": "Basic eDp5"})[0] == 401
        status, _, headers = _call(base, "/internal/ping",
                                   headers={**auth, "Origin": "http://ok.example"})
        assert status == 200 and headers.get("Access-Control-Allow-Origin") == "http://ok.example"
        _, _, headers = _call(base, "/internal/ping", headers={**auth, "Origin": "http://x.example"})
        assert "Access-Control-Allow-Origin" not in headers
        models = _call(base, "/sdapi/v1/sd-models", headers=auth)[1]
        assert [m["model_name"] for m in models] == ["tiny.safetensors"]
        assert _call(base, "/sdapi/v1/sd-modules", headers=auth)[1] == []
        status, _, _ = _call(base, "/sdapi/v1/options", {"sd_model_checkpoint": "tiny"},
                             headers=auth)
        assert status == 200 and mm.engine is not None and mm.engine.device.type == "cpu"
        eng = mm.engine
        assert eng.checkpoint_name == "tiny.safetensors"
        assert eng.checkpoint_hash == CheckpointInfo(str(ckpts / "tiny.safetensors")).short_hash()
        assert len(eng.checkpoint_hash) == 10
        assert _call(base, "/sdapi/v1/reload-checkpoint", {}, headers=auth)[0] == 200
        assert mm.engine is eng
        assert _call(base, "/sdapi/v1/unload-checkpoint", {}, headers=auth)[0] == 200
        assert mm.engine is None
        (ckpts / "other.safetensors").write_bytes(b"x")
        assert _call(base, "/sdapi/v1/refresh-checkpoints", {}, headers=auth)[0] == 200
        assert sorted(mm.checkpoints) == ["other.safetensors", "tiny.safetensors"]
        status, body, _ = _call(base, "/sdapi/v1/options", {"sd_model_checkpoint": "absent"},
                                headers=auth)
        assert status == 404 and "absent" in body["detail"]
    finally:
        opts.set("sd_model_checkpoint", None)
        srv.shutdown()
        srv.server_close()
        mm.close()


def test_launcher_flags():
    """The launcher reads the flags of the API-only path; any other raises
    with its name."""
    from forge_tpu_torch.webui import parse_args

    args = parse_args(["--port", "0", "--listen", "--ckpt", "a.safetensors",
                       "--api-auth", "u:p", "--vae-dtype", "float32", "--device", "cpu"])
    assert (args.port, args.listen, args.ckpt, args.api_auth, args.vae_dtype, args.device) == (
        0, True, "a.safetensors", "u:p", "float32", "cpu")
    for flag in ("--api", "--xformers", "--unet-offload", "--medvram"):
        with pytest.raises(SystemExit, match=flag):
            parse_args([flag])


@pytest.mark.parametrize("allowed", [False, True])
def test_launcher_server_stop(tmp_path, monkeypatch, allowed):
    """As the reference launcher's, `/sdapi/v1/server-stop` and `server-kill`
    answer 404 unless `--api-server-stop` is passed; with it, server-stop ends
    the launcher."""
    from forge_tpu_torch import webui
    from forge_tpu_torch.api import server as api
    from forge_tpu_torch.runtime import queue as queue_mod

    made = []

    def create_server(*args, **kwargs):
        made.append(real_create(*args, **kwargs))
        return made[-1]

    real_create = api.create_server
    monkeypatch.setattr(api, "create_server", create_server)
    monkeypatch.setattr(api, "CMD_FLAGS", {})
    fresh = queue_mod.WorkQueue()  # serve() stops the queue it ends with
    monkeypatch.setattr(api, "work_queue", fresh)
    monkeypatch.setattr(queue_mod, "work_queue", fresh)
    argv = ["--port", "0", "--device", "cpu", "--config", str(tmp_path / "config.json"),
            "--ckpt-dir", str(tmp_path)] + (["--api-server-stop"] if allowed else [])
    launcher = threading.Thread(target=webui.main, args=(argv,), daemon=True)
    launcher.start()
    deadline = time.time() + 30
    while not made and launcher.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    base = f"http://127.0.0.1:{made[0].server_address[1]}"
    try:
        if allowed:
            assert _call(base, "/sdapi/v1/server-stop", {})[0] == 200
            launcher.join(30)
            assert not launcher.is_alive()
        else:
            for route in ("server-stop", "server-kill"):
                status, body, _ = _call(base, f"/sdapi/v1/{route}", {})
                assert status == 404 and "--api-server-stop" in body["detail"]
            assert _call(base, "/internal/ping")[0] == 200
    finally:
        made[0].shutdown()
        launcher.join(30)


def test_progress_without_live_previews(servers):
    """Reference-side fault: forge_tpu ticks `state.sampling_step` only inside
    its live-preview callback, so with `live_previews_enable` off /progress
    stays at step 0 while a request runs and after it. The port's model calls
    tick whatever the option."""
    jbase, tbase = servers
    payload = dict(TXT2IMG, override_settings={"live_previews_enable": False})
    steps = []
    for base in (jbase, tbase):
        assert _call(base, "/sdapi/v1/txt2img", payload)[0] == 200
        prog = _call(base, "/sdapi/v1/progress")[1]
        steps.append((prog["state"]["sampling_step"], prog["progress"], prog["current_image"]))
    assert steps == [(0, 0.0, None), (3, 1.0, None)]

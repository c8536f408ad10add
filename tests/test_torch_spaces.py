"""The port's Forge Spaces (forge_tpu_torch/runtime/spaces.py,
runtime/space_harness.py, forge_tpu_torch/spaces/) on the CPU.

The manager's lifecycle on a stdlib-only Space a test writes (discovery,
launch on a free port, the URL tracked, terminate), the reference's
RuntimeError for a folder without forge_app.py, and NotImplementedError
naming ROADMAP item 9 for each bundled Space built on a diffusion engine.
The harness answers GET with the page, POST with `process`'s JSON and any
exception with 500 and {"error": …}. Each of the four port Spaces
(example, sapiens_normal, birefnet, florence_2) is launched as a child
(`python -m forge_tpu_torch.spaces.<name> --device cpu`) through the
manager over extensions-builtin/, on small networks
(tests/torch_spaces_cases.py, tests/torch_interrogate_cases.py), and its
page and POST /process answer what the reference app's own `process` gives
in-process on the same weights (forge_tpu's networks; Pillow decoding its
PNG): the greeting, the caption and tags equal, the images within one
level on 2 % of the values or fewer (tests/test_torch_sapiens.py `near`).
A JPEG upload answers the harness's 500 naming ROADMAP item 7. Every
launch and request has a timeout, and every child is terminated. The
Sapiens Space is given the U²-Net weights, and its masked answer differs
from its unmasked one. Two launches at once take two ports, and one Space
launched twice at once starts one child.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64
import importlib.util
import io
import json
import os
import shutil
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
PIL = pytest.importorskip("PIL")

from test_torch_sapiens import near  # noqa: E402
from torch_spaces_cases import image, write  # noqa: E402

LAUNCH_TIMEOUT = 120.0
REQUEST_TIMEOUT = 120.0


def _make_space(root, name):
    d = root / name
    d.mkdir(parents=True)
    (d / "space_meta.json").write_text(json.dumps({"title": "Tiny Space", "tag": "test"}))
    (d / "forge_app.py").write_text(textwrap.dedent("""\
        import argparse
        from http.server import BaseHTTPRequestHandler, HTTPServer

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"tiny space ok")
            def log_message(self, *a):
                pass

        ap = argparse.ArgumentParser()
        ap.add_argument("--host", default="127.0.0.1")
        ap.add_argument("--port", type=int, required=True)
        a = ap.parse_args()
        HTTPServer((a.host, a.port), H).serve_forever()
    """))
    return d


def _child_env(**extra):
    """The children's environment: one OpenMP thread each, the model directories given."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    return env


def _post(url, body):
    req = urllib.request.Request(url + "/process", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(img, fmt="PNG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def _pixels(b64):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _reference_app(folder):
    """A bundled Space's forge_app.py under a module name of its own."""
    name = f"reference_{folder}"
    path = os.path.join("extensions-builtin", folder, "forge_app.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_discovery_and_lifecycle(tmp_path):
    from forge_tpu_torch.runtime.spaces import SpaceManager

    _make_space(tmp_path, "forge_space_tiny")
    (tmp_path / "not_a_space").mkdir()
    mgr = SpaceManager([str(tmp_path)])
    infos = mgr.list()
    assert [i["name"] for i in infos] == ["forge_space_tiny"]
    assert infos[0]["installed"] and not infos[0]["running"] and infos[0]["url"] is None
    url = mgr.launch("forge_space_tiny", timeout=LAUNCH_TIMEOUT)
    try:
        assert urllib.request.urlopen(url, timeout=10).read() == b"tiny space ok"
        assert mgr.list()[0]["running"] and mgr.list()[0]["url"] == url
        assert mgr.launch("forge_space_tiny") == url  # running: the same URL
    finally:
        mgr.terminate_all()
    assert not mgr.list()[0]["running"] and mgr.list()[0]["url"] is None


def test_uninstalled_unported_and_free_port(tmp_path):
    from forge_tpu.runtime import spaces as ref
    from forge_tpu_torch.runtime.spaces import PORT_APPS, UNPORTED_SPACES, SpaceManager

    d = tmp_path / "forge_space_empty"
    d.mkdir()
    (d / "space_meta.json").write_text("{}")
    for manager in (ref.SpaceManager([str(tmp_path)]), SpaceManager([str(tmp_path)])):
        assert manager.list() == [{"name": "forge_space_empty", "title": "forge_space_empty",
                                   "tag": "", "installed": False, "running": False, "url": None}]
        with pytest.raises(RuntimeError, match="has no forge_app.py"):
            manager.launch("forge_space_empty")
    bundled = SpaceManager(["extensions-builtin"])
    assert sorted(bundled.spaces) == sorted(ref.SpaceManager(["extensions-builtin"]).spaces)
    assert sorted(bundled.spaces) == sorted(list(PORT_APPS) + list(UNPORTED_SPACES))
    for name in UNPORTED_SPACES:
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 9"):
            bundled.launch(name)
        assert not bundled.spaces[name].running
    import socket

    from forge_tpu_torch.runtime.spaces import find_free_port

    port = find_free_port()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", port))  # free when it returns
    assert 1024 <= port < 65536


def test_harness_answers():
    from http.server import ThreadingHTTPServer

    from forge_tpu_torch.runtime.space_harness import make_handler

    def process(body, state):
        if body.get("fail"):
            raise ValueError("bad input")
        return {"echo": body, "state": state}

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler("<p>page</p>", process, 7))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert urllib.request.urlopen(url, timeout=10).read() == b"<p>page</p>"
        assert _post(url, {"a": 1}) == (200, {"echo": {"a": 1}, "state": 7})
        assert _post(url, {"fail": True}) == (500, {"error": "bad input"})
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The small Sapiens, U²-Net, BLIP (with a seeded vocab.txt) and
    DeepDanbooru (40 tag names) under one models root."""
    from torch_interrogate_cases import write as write_interrogate

    from forge_tpu_torch.core.synth_annotators import synth_deepbooru_tags, synth_wordpieces

    root = str(tmp_path_factory.mktemp("models"))
    write(root, "sapiens")
    write(root, "u2net")
    write_interrogate(root, "blip")
    with open(os.path.join(root, "BLIP", "vocab.txt"), "w") as f:
        f.write("\n".join(synth_wordpieces()) + "\n")
    tags = synth_deepbooru_tags(40)
    write_interrogate(root, "deepbooru", tags=tags)
    return root, tags


@pytest.fixture(scope="module")
def manager():
    from forge_tpu_torch.runtime.spaces import SpaceManager

    mgr = SpaceManager(["extensions-builtin"])
    yield mgr
    mgr.terminate_all()


def _launch(manager, name, **env):
    url = manager.launch(name, timeout=LAUNCH_TIMEOUT, env=_child_env(**env),
                         args=["--device", "cpu"])
    assert manager.spaces[name].running and manager.spaces[name].url == url
    return url


def _stop(manager, name):
    manager.terminate(name)
    assert not manager.spaces[name].running


def test_example_space(manager):
    app = _reference_app("forge_space_example")
    url = _launch(manager, "forge_space_example")
    try:
        assert urllib.request.urlopen(url, timeout=10).read().decode() == app.PAGE
        for body in ({"name": "forge", "intensity": 3}, {}):
            assert _post(url, body) == (200, app.process(body, None))
    finally:
        _stop(manager, "forge_space_example")


@pytest.fixture(autouse=True)
def no_ipp():
    import cv2

    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def test_sapiens_normal_space(manager, models):
    from forge_tpu.models.sapiens import SapiensNormal

    app = _reference_app("forge_space_sapiens_normal")
    model_dir = os.path.join(models[0], "sapiens")
    mask_dir = os.path.join(models[0], "u2net")
    url = _launch(manager, "forge_space_sapiens_normal", SAPIENS_MODEL_DIR=model_dir,
                  U2NET_MODEL_DIR=mask_dir)
    try:
        assert "Normal Estimation (Sapiens)" in urllib.request.urlopen(url, timeout=10).read().decode()
        net = SapiensNormal(model_dir=model_dir, mask_model_dir=mask_dir)
        answers = []
        for body in ({"image": _png(image(21, 96, 80))}, {"image": _png(image(21, 96, 80)),
                                                         "mask": False},
                     {"image": _png(image(22, 64, 96)), "mask": False}):
            status, got = _post(url, body)
            want = app.process(body, net)
            assert status == 200 and near(_pixels(got["image"]), _pixels(want["image"]))
            answers.append(_pixels(got["image"]))
        assert not np.array_equal(answers[0], answers[1])  # the U²-Net mask was applied
        status, got = _post(url, {"image": _png(image(23, 32, 32), "JPEG")})
        assert status == 500 and "JPEG" in got["error"]
        assert "ROADMAP.md queue 1 item 7" in got["error"]
    finally:
        _stop(manager, "forge_space_sapiens_normal")


def test_birefnet_space(manager, models):
    from forge_tpu.models.u2net import U2NetMatter

    app = _reference_app("forge_space_birefnet")
    model_dir = os.path.join(models[0], "u2net")
    url = _launch(manager, "forge_space_birefnet", U2NET_MODEL_DIR=model_dir)
    try:
        assert "Remove Background" in urllib.request.urlopen(url, timeout=10).read().decode()
        matter = U2NetMatter(model_dir=model_dir)
        img = image(24, 72, 90)
        for extra in ({}, {"flat": True, "bg": "#20c05a", "size": 96}):
            body = {"image": _png(img), **extra}
            status, got = _post(url, body)
            want = _pixels(app.process(body, matter)["image"])
            got = _pixels(got["image"])
            assert status == 200 and got.shape == (72, 90, 3 if extra else 4)
            assert near(got, want)
    finally:
        _stop(manager, "forge_space_birefnet")


def test_florence_2_space(manager, models):
    from forge_tpu.models.blip import BlipCaptioner
    from forge_tpu.postprocessing.deepbooru import DeepDanbooru

    app = _reference_app("forge_space_florence_2")
    root, tags = models
    url = _launch(manager, "forge_space_florence_2", CAPTION_MODEL_ROOT=root)
    try:
        assert "Image Caption" in urllib.request.urlopen(url, timeout=10).read().decode()
        booru = DeepDanbooru(os.path.join(root, "torch_deepdanbooru"))
        booru.load()
        booru.tags = list(tags)  # forge_tpu's reader keeps the tensors only
        state = {"blip": BlipCaptioner(os.path.join(root, "BLIP")), "booru": booru}
        body = {"image": _png(image(25, 80, 112)), "tags": True}
        status, got = _post(url, body)
        want = app.process(body, state)
        assert status == 200 and got == want and set(got) == {"caption", "tags"}
        assert len(got["caption"].split()) >= 3
    finally:
        _stop(manager, "forge_space_florence_2")
    empty = os.path.join(root, "empty")
    os.makedirs(empty, exist_ok=True)
    url = _launch(manager, "forge_space_florence_2", CAPTION_MODEL_ROOT=empty)
    try:
        status, got = _post(url, {"image": _png(image(26, 16, 16))})
        assert status == 200 and "no captioner checkpoints" in got["error"]
    finally:
        _stop(manager, "forge_space_florence_2")
    shutil.rmtree(empty)


def test_api_launches_at_once(tmp_path, monkeypatch):
    """Two POST /sdapi/v1/spaces/launch at once (the server's handler threads):
    one manager, two ports, both listed running, both terminated."""
    from concurrent.futures import ThreadPoolExecutor

    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.runtime.models import ModelManager

    for name in ("forge_space_one", "forge_space_two"):
        _make_space(tmp_path / "extensions-builtin", name)
    monkeypatch.chdir(tmp_path)
    manager = ModelManager(device="cpu")
    srv = create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}/sdapi/v1/spaces"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT) as r:
            return json.loads(r.read())

    try:
        with ThreadPoolExecutor(2) as pool:
            urls = list(pool.map(lambda n: call("/launch", {"name": n})["url"],
                                 ("forge_space_one", "forge_space_two")))
        assert len(set(urls)) == 2
        listed = {s["name"]: s for s in call("")["spaces"]}
        assert [listed[n]["url"] for n in ("forge_space_one", "forge_space_two")] == urls
        assert all(urllib.request.urlopen(u, timeout=10).read() == b"tiny space ok"
                   for u in urls)
    finally:
        for name in ("forge_space_one", "forge_space_two"):
            call("/terminate", {"name": name})
        srv.shutdown()
        srv.server_close()
        manager.close()
    assert all(not s.running for s in srv.api.space_manager.spaces.values())


def test_launch_twice_at_once_starts_one_child(tmp_path, monkeypatch):
    """Two launches of one Space at once (two handler threads): one child,
    started once; both calls answer its URL."""
    from concurrent.futures import ThreadPoolExecutor

    from forge_tpu_torch.runtime import spaces

    _make_space(tmp_path, "forge_space_tiny")
    mgr = spaces.SpaceManager([str(tmp_path)])
    started = []
    popen = spaces.subprocess.Popen

    def counted(*a, **k):
        started.append(a[0])
        return popen(*a, **k)

    monkeypatch.setattr(spaces.subprocess, "Popen", counted)
    try:
        with ThreadPoolExecutor(2) as pool:
            urls = list(pool.map(lambda _: mgr.launch("forge_space_tiny",
                                                      timeout=LAUNCH_TIMEOUT), range(2)))
        assert len(started) == 1 and urls[0] == urls[1] == mgr.spaces["forge_space_tiny"].url
        assert urllib.request.urlopen(urls[0], timeout=10).read() == b"tiny space ok"
    finally:
        mgr.terminate_all()
    assert not mgr.spaces["forge_space_tiny"].running

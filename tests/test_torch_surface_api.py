"""The routes this port adds to its REST API, against forge_tpu's server
(CPU): both servers on port 0 over the tiny SD1.5 of tests/fixtures.py, in a
temporary working directory that holds the files the routes read (two
checkpoints, a LoRA with its preview and metadata, an embedding, an
extension, a localization).

Each answer equals forge_tpu's: /controlnet/version, /module_list and
/model_list; /sdapi/v1/create/embedding (the files byte-equal; an out_dir outside the
embeddings folder 422 in the port, written by the reference);
/merge-checkpoints (the merged files byte-equal, the checkpoint list
refreshed; a custom_name reduced to a file name beside the primary in the
port, followed as a path by the reference); /sdapi/v1/extensions, and `/extensions/install` and
`/update` (403 without --enable-insecure-extension-access, then a
repository the test makes installed and updated); the extra-networks `cards`, `preview` and `metadata` (GET, and
POST writing the same sidecar); /config_states/save and /config_states
(the extensions listed and the settings the port registers); GET / (the
same page; 404 under --nowebui); /sdapi/v1/localization; /sdapi/v1/ui-tabs
(a `ui_tabs` callback's tabs, a raising one skipped). `save_images` true
writes the request's image where the reference's does. The event log gets
`api_request` for every answered /sdapi route and `api_error` for a server
error, with the reference's fields. /sdapi/v1/server-restart without
--api-server-stop answers 404 and latches nothing; with it, it latches
`restart_requested` and stops the server, in both; the port's launcher then
serves again on the same engine. The three Spaces routes are served
(runtime/spaces.py; tests/test_torch_spaces.py launches the port's apps):
the list holds the working directory's Spaces, and a bundled Space the port
does not run yet answers 501 naming ROADMAP item 9.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402
from test_torch_api import TXT2IMG, _call, _serve  # noqa: E402


def _raw(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _write_files(root):
    from forge_tpu_torch.core.save import save_safetensors

    os.makedirs(os.path.join(root, "models", "Stable-diffusion"))
    for name, seed in (("tiny-a", 0), ("tiny-b", 10)):
        save_safetensors(make_sd15_checkpoint(seed),
                         os.path.join(root, "models", "Stable-diffusion", name + ".safetensors"))
    lora = os.path.join(root, "models", "Lora")
    os.makedirs(lora)
    rng = np.random.default_rng(0)
    save_safetensors({"lora_unet_x.lora_up.weight": rng.standard_normal((4, 2), np.float32)},
                     os.path.join(lora, "style.safetensors"))
    save_safetensors({"lora_unet_x.lora_up.weight": rng.standard_normal((4, 2), np.float32)},
                     os.path.join(lora, "plain.safetensors"))
    from forge_tpu_torch.pipeline.images import encode_png

    with open(os.path.join(lora, "style.preview.png"), "wb") as f:
        f.write(encode_png(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)))
    with open(os.path.join(lora, "style.json"), "w", encoding="utf8") as f:
        json.dump({"description": "a style", "activation text": "stylish",
                   "preferred weight": 0.7}, f)
    os.makedirs(os.path.join(root, "embeddings"))
    save_safetensors({"emb_params": rng.standard_normal((2, CLIP_WIDTH), np.float32)},
                     os.path.join(root, "embeddings", "myemb.safetensors"))
    os.makedirs(os.path.join(root, "extensions", "my-ext", "scripts"))
    with open(os.path.join(root, "extensions", "my-ext", "metadata.ini"), "w") as f:
        f.write("[Extension]\nName = My Extension\nRequires = other\n")
    os.makedirs(os.path.join(root, "localizations"))
    with open(os.path.join(root, "localizations", "fr.json"), "w", encoding="utf8") as f:
        json.dump({"Generate": "Générer", "Steps": "Étapes"}, f)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(forge_tpu's base URL, the port's, the working directory, both servers);
    the working directory the temporary one while the module runs."""
    from forge_tpu.api.server import create_server as jcreate
    from forge_tpu.runtime.models import ModelManager as JManager
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.runtime.models import ModelManager

    root = str(tmp_path_factory.mktemp("surface"))
    _write_files(root)
    ckpts = [os.path.join(root, "models", "Stable-diffusion")]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        teng = load_engine(make_sd15_checkpoint(0), device="cpu")
        teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
        jmm, tmm = JManager(checkpoint_dirs=ckpts), ModelManager(checkpoint_dirs=ckpts,
                                                                 device="cpu")
        jmm.set_engine(make_tiny_engine(0))
        tmm.set_engine(teng)
        jsrv, tsrv = jcreate(jmm, "127.0.0.1", 0), create_server(tmm, "127.0.0.1", 0)
        try:
            yield _serve(jsrv), _serve(tsrv), root, (jsrv, tsrv)
        finally:
            for srv in (jsrv, tsrv):
                srv.shutdown()
                srv.server_close()
            tmm.close()


def _both(env, path, body=None):
    jbase, tbase = env[:2]
    want, got = _call(jbase, path, body), _call(tbase, path, body)
    return want[:2], got[:2]


def test_controlnet_routes(env, tmp_path, monkeypatch):
    from forge_tpu.extensions import controlnet as jcn
    from forge_tpu_torch.extensions import controlnet as tcn
    from forge_tpu_torch.preprocessors import preprocessor_names

    for name in ("control_canny.safetensors", "t2i_depth.pth", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(jcn, "_MODEL_DIRS", [str(tmp_path)])
    monkeypatch.setattr(tcn, "_MODEL_DIRS", [str(tmp_path)])
    for path in ("/controlnet/version", "/controlnet/module_list", "/controlnet/model_list"):
        want, got = _both(env, path)
        assert got == want and got[0] == 200, path
    assert _call(env[1], "/controlnet/model_list")[1] == {
        "model_list": ["control_canny", "t2i_depth"]}
    assert _call(env[1], "/controlnet/module_list")[1]["module_list"] == preprocessor_names()


def test_create_embedding(env):
    root = env[2]
    created = os.path.join(root, "embeddings", "created")
    answers = []
    for base, sub in ((env[0], "j"), (env[1], "t")):
        body = dict(name="new emb", num_vectors_per_token=3, init_text="a red cat",
                    out_dir=os.path.join(created, sub))
        answers.append(_call(base, "/sdapi/v1/create/embedding", body)[:2])
    (jstatus, jbody), (tstatus, tbody) = answers
    assert jstatus == tstatus == 200
    assert tbody["info"].replace("/t/", "/j/") == jbody["info"]
    with open(os.path.join(created, "j", "new emb.safetensors"), "rb") as fj, \
            open(os.path.join(created, "t", "new emb.safetensors"), "rb") as ft:
        assert ft.read() == fj.read()
    want, got = _both(env, "/sdapi/v1/create/embedding",
                      dict(name="new emb", out_dir=os.path.join(created, "t")))
    assert got[0] == want[0] and got[0] in (404, 500)  # the file exists: the same refusal
    status, body, _ = _call(env[1], "/sdapi/v1/create/embedding", dict(name="in root"))
    assert status == 200 and os.path.exists(os.path.join(root, "embeddings", "in root.safetensors"))


@pytest.mark.parametrize("out_dir", ["embeddings/../outside", "ABSOLUTE"])
def test_create_embedding_stays_in_its_folder(env, tmp_path, out_dir):
    """An out_dir outside the embeddings folder: the port answers 422 and
    writes nothing; the reference writes there (a reference fault)."""
    root = env[2]
    target = str(tmp_path / "abs") if out_dir == "ABSOLUTE" else os.path.join(root, "outside")
    sent = target if out_dir == "ABSOLUTE" else out_dir
    for base, name in ((env[1], "t-escape"), (env[0], "j-escape")):
        status, body, _ = _call(base, "/sdapi/v1/create/embedding", dict(name=name, out_dir=sent))
        if base == env[1]:
            assert status == 422 and "outside the embeddings folder" in body["detail"]
            assert not os.path.exists(os.path.join(target, name + ".safetensors"))
        else:
            assert status == 200 and os.path.exists(os.path.join(target, name + ".safetensors"))


def test_merge_checkpoints(env):
    root = env[2]
    answers = []
    for base, name in ((env[0], "merged-j"), (env[1], "merged-t")):
        body = dict(primary="tiny-a.safetensors", secondary="tiny-b.safetensors",
                    multiplier=0.3, custom_name=name)
        answers.append(_call(base, "/sdapi/v1/merge-checkpoints", body)[:2])
    (jstatus, jbody), (tstatus, tbody) = answers
    assert jstatus == tstatus == 200
    assert tbody["path"] == jbody["path"].replace("merged-j", "merged-t")
    with open(jbody["path"], "rb") as fj, open(tbody["path"], "rb") as ft:
        assert ft.read() == fj.read()
    models = [_call(b, "/sdapi/v1/sd-models")[1] for b in env[:2]]
    assert {"merged-j.safetensors", "merged-t.safetensors"} <= {m["model_name"] for m in models[1]}
    want, got = _both(env, "/sdapi/v1/merge-checkpoints", dict(primary="no-such"))
    assert got == want and got[0] == 422


def test_merge_checkpoints_name_stays_in_its_folder(env):
    """A custom_name with '../' or an absolute path: the port writes the
    merge beside the primary under the name's last part, made a file name;
    the reference writes where the path leads (a reference fault)."""
    root = env[2]
    ckpts = os.path.join(root, "models", "Stable-diffusion")
    for base, name, want in (
            (env[1], "../escape t", os.path.join(ckpts, "escape_t.safetensors")),
            (env[1], os.path.join(root, "abs-t"), os.path.join(ckpts, "abs-t.safetensors")),
            (env[0], "../escape-j", os.path.join(root, "models", "escape-j.safetensors"))):
        status, body, _ = _call(base, "/sdapi/v1/merge-checkpoints", dict(
            primary="tiny-a.safetensors", secondary="tiny-b.safetensors", custom_name=name))
        assert status == 200 and os.path.realpath(body["path"]) == want
        assert os.path.exists(want)
    assert not os.path.exists(os.path.join(root, "abs-t.safetensors"))


def test_extra_networks_routes(env):
    for base in env[:2]:  # the merged checkpoints of either package listed in both
        assert _call(base, "/sdapi/v1/refresh-checkpoints", {})[0] == 200
    for query in ("?kind=lora", "?kind=lora&search=sty", "?kind=embeddings",
                  "?kind=checkpoints", "?kind=hypernetworks"):
        want, got = _both(env, "/sdapi/v1/extra-networks/cards" + query)
        assert got == want and got[0] == 200, query
    assert [c["name"] for c in _call(env[1], "/sdapi/v1/extra-networks/cards?kind=lora")[1][
        "cards"]] == ["plain", "style"]
    want, got = _both(env, "/sdapi/v1/extra-networks/cards?kind=unknown")
    assert got == want and got[0] == 422
    previews = [_raw(b, "/sdapi/v1/extra-networks/preview?kind=lora&name=style") for b in env[:2]]
    assert previews[1] == previews[0] and previews[1][:2] == (200, "image/png")
    for query in ("?kind=lora&name=plain", "?kind=lora&name=nothing"):
        want, got = _both(env, "/sdapi/v1/extra-networks/preview" + query)
        assert got == want and got[0] == 404
    for query in ("?kind=lora&name=style", "?kind=lora&name=plain", "?kind=lora&name=nothing"):
        want, got = _both(env, "/sdapi/v1/extra-networks/metadata" + query)
        assert got == want, query
    side = os.path.join(env[2], "models", "Lora", "plain.json")
    body = {"name": "plain", "kind": "lora", "description": "d", "notes": "n", "other": 1}
    contents = []
    for base in env[:2]:
        answer = _call(base, "/sdapi/v1/extra-networks/metadata", body)[:2]
        with open(side, encoding="utf8") as f:
            contents.append((answer, f.read()))
        os.remove(side)
    assert contents[1] == contents[0] and contents[1][0] == (200, {"description": "d",
                                                                   "notes": "n"})


def test_extensions_list(env):
    want, got = _both(env, "/sdapi/v1/extensions")
    assert got == want and got[0] == 200
    assert [e["name"] for e in got[1]] == ["my-ext"] and got[1][0]["enabled"] is True


def test_extension_install_and_update_routes(env, tmp_path, monkeypatch):
    """403 without --enable-insecure-extension-access in both; with it, an
    install from a git repository the test makes, the update check and the
    update answer as forge_tpu's; an unknown name 404."""
    import subprocess

    from forge_tpu.api import server as jserver
    from forge_tpu_torch.api import server as tserver

    def git(*args):
        subprocess.run(["git", "-c", "user.name=test", "-c", "user.email=test@example.com",
                        "-c", "init.defaultBranch=main", "-C", str(repo), *args], check=True,
                       capture_output=True)

    repo = tmp_path / "ext-origin"
    repo.mkdir()
    (repo / "README.md").write_text("an extension\n")
    git("init")
    git("add", "-A")
    git("commit", "-m", "first")
    for route in ("/sdapi/v1/extensions/install", "/sdapi/v1/extensions/update"):
        want, got = _both(env, route, {"url": str(repo), "name": "my-ext"})
        assert got == want and got[0] == 403, route
    for mod in (jserver, tserver):
        monkeypatch.setitem(mod.CMD_FLAGS, "enable_insecure_extension_access", True)
    answers = []
    for base, name in ((env[0], "from-j"), (env[1], "from-t")):
        answers.append(_call(base, "/sdapi/v1/extensions/install",
                             {"url": str(repo), "dirname": name})[:2])
    (jstatus, jbody), (tstatus, tbody) = answers
    assert jstatus == tstatus == 200 and tbody["commit_hash"] == jbody["commit_hash"]
    assert (tbody["name"], tbody["path"]) == ("from-t", os.path.join("extensions", "from-t"))
    for body in ({"name": "from-t", "check_only": True}, {"name": "from-t"},
                 {"name": "no-such"}):
        want, got = _both(env, "/sdapi/v1/extensions/update", body)
        assert got == want, body
    assert _call(env[1], "/sdapi/v1/extensions/update", {"name": "from-t", "check_only": True})[
        1] == {"name": "from-t", "status": "latest"}
    assert _call(env[1], "/sdapi/v1/extensions/update", {"name": "no-such"})[0] == 404
    names = [e["name"] for e in _call(env[1], "/sdapi/v1/extensions")[1]]
    assert names == ["from-j", "from-t", "my-ext"]


def test_config_states(env):
    from forge_tpu_torch.runtime.options import opts

    saved = [_call(b, "/config_states/save", {"name": f"../{n}"})[:2]
             for b, n in zip(env[:2], ("j", "t"))]
    assert all(s[0] == 200 and os.path.dirname(s[1]["saved"]) == "config_states" for s in saved)
    states = [_call(b, "/config_states")[1] for b in env[:2]]
    assert states[1] == states[0]  # both list the one directory
    assert sorted(s["name"] for s in states[1]) == ["../j", "../t"]
    want, got = (next(s for s in states[1] if s["name"] == n) for n in ("../j", "../t"))
    assert got["extensions"] == want["extensions"] and len(got["extensions"]) > 0
    assert set(got["settings"]) == set(opts._registry)
    for key, info in got["settings"].items():
        assert (info["default"], info["label"], info["section"]) == (
            want["settings"][key]["default"], want["settings"][key]["label"],
            want["settings"][key]["section"]), key


def test_web_ui_routes(env, monkeypatch):
    from forge_tpu.api import server as jserver
    from forge_tpu_torch.api import server as tserver

    pages = [_raw(b, "/") for b in env[:2]]
    assert pages[1] == pages[0] and pages[1][0] == 200
    assert pages[1][1] == "text/html; charset=utf-8" and pages[1][2].startswith(b"<!doctype html>")
    monkeypatch.setitem(jserver.CMD_FLAGS, "nowebui", True)
    monkeypatch.setitem(tserver.CMD_FLAGS, "nowebui", True)
    want, got = _both(env, "/")
    assert got == want and got[0] == 404
    for query in ("", "?name=fr", "?name=none-such"):
        want, got = _both(env, "/sdapi/v1/localization" + query)
        assert got == want and got[0] == 200, query
    assert _call(env[1], "/sdapi/v1/localization?name=fr")[1]["data"]["Steps"] == "Étapes"


def test_ui_tabs(capsys):
    """Each package's create_server collects the ui_tabs callbacks' tabs; a
    callback that raises is printed and skipped."""
    import importlib

    answers = []
    for package in ("forge_tpu", "forge_tpu_torch"):
        scripts = importlib.import_module(f"{package}.runtime.scripts")
        server_mod = importlib.import_module(f"{package}.api.server")
        models = importlib.import_module(f"{package}.runtime.models")
        scripts.on("ui_tabs", lambda: [{"id": "mine", "title": "Mine", "html": "<b>x</b>"}])
        scripts.on("ui_tabs", lambda: 1 / 0)
        manager = (models.ModelManager(device="cpu") if package == "forge_tpu_torch"
                   else models.ModelManager())
        srv = server_mod.create_server(manager, "127.0.0.1", 0)
        try:
            answers.append(_call(_serve(srv), "/sdapi/v1/ui-tabs")[:2])
        finally:
            scripts.clear("ui_tabs")
            srv.shutdown()
            srv.server_close()
            if package == "forge_tpu_torch":
                manager.close()
    assert answers[1] == answers[0] == (200, [{"id": "mine", "title": "Mine", "html": "<b>x</b>"}])
    assert capsys.readouterr().out.count("ui_tabs callback failed") == 2


def test_save_images_writes_the_image(env, tmp_path):
    from forge_tpu_torch.pipeline.images import decode_png

    written = []
    for base, sub in ((env[0], "j"), (env[1], "t")):
        out = str(tmp_path / sub)
        body = dict(TXT2IMG, save_images=True, override_settings={
            "samples_save": True, "outdir_txt2img_samples": out, "save_to_dirs": False})
        status, answer, _ = _call(base, "/sdapi/v1/txt2img", body)
        assert status == 200
        files = sorted(os.listdir(out))
        with open(os.path.join(out, files[0]), "rb") as f:
            pixels, text = decode_png(f.read())
        image = decode_png(base64.b64decode(answer["images"][0]))[0]
        assert np.array_equal(pixels, image)
        assert text["parameters"] == json.loads(answer["info"])["infotexts"][0]
        written.append(files)
    assert written[1] == written[0] == ["00000-5-a cat.png", "log.csv"]
    status, _, _ = _call(env[1], "/sdapi/v1/txt2img", dict(TXT2IMG, steps=1, override_settings={
        "samples_save": True, "outdir_txt2img_samples": str(tmp_path / "none")}))
    assert status == 200 and not (tmp_path / "none").exists()  # no save_images: nothing saved


def test_event_log_api_fields(env, tmp_path):
    """api_request for an answered /sdapi route (not for one outside /sdapi),
    api_error for a server error: the reference's fields but for the times."""
    from forge_tpu.runtime import logging as jlog
    from forge_tpu_torch.runtime import logging as tlog

    lines = []
    for base, mod, name in ((env[0], jlog, "j"), (env[1], tlog, "t")):
        path = str(tmp_path / f"{name}.jsonl")
        saved = mod._PATH
        mod._PATH = path
        try:
            assert _call(base, "/sdapi/v1/samplers")[0] == 200
            assert _call(base, "/controlnet/version")[0] == 200
            assert _call(base, "/sdapi/v1/create/embedding", {"name": "???"})[0] == 500
        finally:
            mod._PATH = saved
        with open(path, encoding="utf8") as f:
            lines.append([{k: v for k, v in json.loads(line).items()
                           if k not in ("ts", "duration_s")} for line in f])
    assert lines[1] == lines[0] == [
        {"event": "api_request", "method": "GET", "path": "/sdapi/v1/samplers", "status": 200},
        {"event": "api_error", "method": "POST", "path": "/sdapi/v1/create/embedding",
         "error": "embedding name '???' has no legal characters"}]


def test_unported_routes_name_item_9(env, monkeypatch):
    """The Spaces routes are served over the working directory's
    extensions-builtin/: a bundled Space built on a diffusion engine is
    listed; its launch without its checkpoint answers as the reference's
    route does, a 500 naming the child's exit (the reference runs the
    folder's forge_app.py, the port its own app: both exit in setup); its
    terminate 200."""
    routes = {("GET", "/sdapi/v1/spaces"), ("POST", "/sdapi/v1/spaces/launch"),
              ("POST", "/sdapi/v1/spaces/terminate")}
    assert routes <= set(env[3][1].api.routes)
    space = os.path.join(env[2], "extensions-builtin", "forge_space_geowizard")
    os.makedirs(space, exist_ok=True)
    with open(os.path.join(space, "space_meta.json"), "w") as f:
        json.dump({"title": "GeoWizard", "tag": "depth"}, f)
    with open(os.path.join(space, "forge_app.py"), "w") as f:
        f.write("raise SystemExit('the reference app, written against forge_tpu')\n")
    status, body, _ = _call(env[1], "/sdapi/v1/spaces")
    assert status == 200 and {"name": "forge_space_geowizard", "title": "GeoWizard",
                              "tag": "depth", "installed": True, "running": False,
                              "url": None} in body["spaces"]
    from forge_tpu.runtime import spaces as jspaces
    from forge_tpu_torch.runtime.spaces import find_free_port

    # forge_tpu's manager given an OS-picked port: its scan from 7870 can take a port another
    # test's Space is about to open, and connect to that
    monkeypatch.setattr(jspaces, "find_free_port", lambda host="127.0.0.1": find_free_port(host))
    want, got = _both(env, "/sdapi/v1/spaces/launch", {"name": "forge_space_geowizard"})
    assert got == want == (500, {"detail": "space 'forge_space_geowizard' exited with 1"})
    status, body, _ = _call(env[1], "/sdapi/v1/spaces/terminate",
                            {"name": "forge_space_geowizard"})
    assert status == 200 and body == {}


@pytest.mark.parametrize("flag", [False, True])
def test_server_restart_latch(flag, monkeypatch):
    """Without --api-server-stop both answer 404 and latch nothing; with it
    both latch restart_requested and stop serving."""
    import importlib

    for package in ("forge_tpu", "forge_tpu_torch"):
        server_mod = importlib.import_module(f"{package}.api.server")
        models = importlib.import_module(f"{package}.runtime.models")
        monkeypatch.setitem(server_mod.CMD_FLAGS, "api_server_stop", flag)
        manager = (models.ModelManager(device="cpu") if package == "forge_tpu_torch"
                   else models.ModelManager())
        srv = server_mod.create_server(manager, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            status, body, _ = _call(f"http://127.0.0.1:{srv.server_address[1]}",
                                    "/sdapi/v1/server-restart", {})
            thread.join(timeout=10 if flag else 0.5)
            assert status == (200 if flag else 404), (package, body)
            assert srv.restart_requested is flag
            assert thread.is_alive() is not flag
        finally:
            if thread.is_alive():
                srv.shutdown()
            srv.server_close()
            if package == "forge_tpu_torch":
                manager.close()


def test_launcher_serves_again_after_a_restart(monkeypatch):
    """The port's webui main: /server-restart stops the server, its loop
    starts it again with the same engine, /server-stop ends it."""
    from forge_tpu_torch import webui
    from forge_tpu_torch.api import server as tserver

    starts = []
    real_create = tserver.create_server

    def create(models, host, port, api_auth=None):
        srv = real_create(models, host, 0, api_auth=api_auth)
        starts.append((srv, models.engine))
        path = "/sdapi/v1/server-restart" if len(starts) == 1 else "/sdapi/v1/server-stop"

        def ask():
            _call(f"http://127.0.0.1:{srv.server_address[1]}", path, {})

        threading.Timer(0.3, ask).start()
        return srv

    monkeypatch.setattr(tserver, "create_server", create)
    monkeypatch.setattr(tserver.work_queue, "stop", lambda: None)  # other tests' queue
    monkeypatch.setattr(tserver, "CMD_FLAGS", {})  # what main sets stays in this test
    webui.main(["--api-server-stop", "--device", "cpu", "--ckpt-dir", "no/such/dir",
                "--config", "no-such-config.json", "--port", "0"])
    assert len(starts) == 2 and starts[0][0].restart_requested
    assert not starts[1][0].restart_requested
    assert starts[1][0].api.models is starts[0][0].api.models

"""The port's CLIP interrogator (forge_tpu_torch/postprocessing/interrogate.py)
and the /sdapi/v1/interrogate route against forge_tpu's on the CPU, f32.

A tiny CLIP in HF CLIPModel's keys (both towers, both projections), the
four category files and a fifth of its own, a tiny BLIP with a seeded
`vocab.txt` and a tiny DeepDanbooru with its tag names, written where each
package's loaders look (tests/torch_interrogate_cases.py). `rank` gives
forge_tpu's order and its scores within 1e-4 (×100, as the reference
scales them); forge_tpu's `text_embeds` divides a read-only view of its
projection in place and raises on f32 weights (shown from both sides), so
the other tests hand it a writable copy (`_writable_projection`);
`interrogate` gives forge_tpu's string with and without the
BLIP caption leading, under `interrogate_return_ranks`,
`interrogate_clip_dict_limit` and `interrogate_clip_skip_categories`. Both
servers answer /sdapi/v1/interrogate the same: "clip" and "deepbooru"
captions (forge_tpu's DeepDanbooru given the tag names by hand: its reader
drops them, tests/test_torch_deepbooru.py), the deepbooru options, 404
without an image and the same `detail` without a checkpoint.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_api import _call, _png_b64, _serve  # noqa: E402
from torch_interrogate_cases import image, write  # noqa: E402

IMAGES = [image(11, 64, 80), image(12, 96, 72)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A working directory whose models/ holds every tiny network and file."""
    from forge_tpu_torch.core.synth_annotators import (synth_deepbooru_tags,
                                                       synth_interrogate_categories,
                                                       synth_wordpieces)

    root = tmp_path_factory.mktemp("cwd")
    m = str(root / "models")
    write(m, "clip")
    cats = synth_interrogate_categories(terms=12)
    cats["textures"] = ["rough", "smooth surface", "glossy"]
    for name, terms in cats.items():
        with open(os.path.join(m, "interrogate", f"{name}.txt"), "w") as f:
            f.write("\n".join(terms) + "\n\n")
    write(m, "blip")
    with open(os.path.join(m, "BLIP", "vocab.txt"), "w") as f:
        f.write("\n".join(synth_wordpieces()) + "\n")
    tags = synth_deepbooru_tags(40)
    write(m, "deepbooru", tags=tags)
    return root, tags


def _writable_projection(monkeypatch):
    """forge_tpu's `clip_pooled_projection` as a writable numpy array: its
    interrogator normalizes `np.asarray(projection)` in place."""
    from forge_tpu.models import clip as jclip

    original = jclip.clip_pooled_projection
    monkeypatch.setattr(jclip, "clip_pooled_projection",
                        lambda params, pooled: np.array(original(params, pooled), np.float32))


def _install(monkeypatch, root, blip=True):
    """Both packages' interrogator, BLIP and DeepDanbooru reading root/models
    (the port's on the CPU); → (port interrogator, forge_tpu's)."""
    from forge_tpu.models import blip as jblip
    from forge_tpu.postprocessing import interrogate as jinterrogate
    from forge_tpu_torch.models import blip as tblip
    from forge_tpu_torch.postprocessing import interrogate as tinterrogate

    m = os.path.join(str(root), "models")
    dirs = (os.path.join(m, "interrogate"),)
    bdir = os.path.join(m, "BLIP" if blip else "no-BLIP")
    port = tinterrogate.ClipInterrogator(model_dirs=dirs, device="cpu")
    ref = jinterrogate.ClipInterrogator(model_dirs=dirs)
    monkeypatch.setattr(tinterrogate, "_INTERROGATOR", port)
    monkeypatch.setattr(jinterrogate, "get_interrogator", lambda: ref)
    monkeypatch.setattr(tblip, "_CAPTIONER", tblip.BlipCaptioner(model_dir=bdir, device="cpu"))
    monkeypatch.setattr(jblip, "_CAPTIONER", jblip.BlipCaptioner(model_dir=bdir))
    _writable_projection(monkeypatch)
    return port, ref


def test_reference_text_embeds_fault_from_both_sides(models):
    from forge_tpu.postprocessing.interrogate import ClipInterrogator as Ref
    from forge_tpu_torch.postprocessing.interrogate import ClipInterrogator

    root, _ = models
    dirs = (os.path.join(str(root), "models", "interrogate"),)
    with pytest.raises(ValueError, match="read-only"):
        Ref(model_dirs=dirs).text_embeds(["a cat"])
    emb = ClipInterrogator(model_dirs=dirs, device="cpu").text_embeds(["a cat", "a dog", "a cat"])
    assert emb.shape == (3, 32) and np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    assert np.array_equal(emb[0], emb[2])


def test_rank_matches_reference(models, monkeypatch):
    from forge_tpu_torch.postprocessing.interrogate import load_categories

    root, _ = models
    port, ref = _install(monkeypatch, root, blip=False)
    cats = load_categories(os.path.join(str(root), "models", "interrogate"))
    assert set(cats) == {"mediums", "artists", "movements", "flavors", "textures"}
    assert cats["artists"][0].startswith("by ")
    for img in IMAGES:
        pe, re_ = port.image_embed(img), ref.image_embed(img)
        assert np.abs(pe - re_).max() < 1e-4
        for name, terms in cats.items():
            got, want = port.rank(pe, terms, top_count=5), ref.rank(re_, terms, top_count=5)
            assert [t for t, _ in got] == [t for t, _ in want], name
            assert np.allclose([s for _, s in got], [s for _, s in want], atol=1e-4)
    assert port.rank(pe, []) == []


@pytest.mark.parametrize("blip", [False, True])
@pytest.mark.parametrize("options", [
    {},
    {"interrogate_return_ranks": True},
    {"interrogate_clip_dict_limit": 5, "interrogate_clip_skip_categories": "artists, flavors"},
    {"interrogate_clip_dict_limit": 0, "interrogate_clip_skip_categories": "textures",
     "interrogate_clip_max_length": 12, "interrogate_clip_min_length": 10},
])
def test_interrogate_matches_reference(models, monkeypatch, blip, options):
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.runtime.options import opts

    root, _ = models
    monkeypatch.chdir(root)  # the categories from models/interrogate
    port, ref = _install(monkeypatch, root, blip=blip)
    options = {"interrogate_clip_max_length": 8, "interrogate_clip_min_length": 6, **options}
    with opts.override(options), jopts.override(options):
        got, want = port.interrogate(IMAGES[0]), ref.interrogate(IMAGES[0])
    assert got == want
    parts = got.split(", ")
    skipped = str(options.get("interrogate_clip_skip_categories", ""))
    assert len(parts) == blip + 5 - len([s for s in skipped.split(",") if s.strip()])
    if options.get("interrogate_return_ranks"):
        assert all(p.startswith("(") and p.endswith(")") for p in parts[blip:])


def test_interrogate_without_categories(models, monkeypatch):
    root, _ = models
    port, ref = _install(monkeypatch, root, blip=False)
    assert port.interrogate(IMAGES[1], categories={}) == ref.interrogate(IMAGES[1], categories={}) \
        == "<no categories installed>"


@pytest.fixture(scope="module")
def servers():
    from forge_tpu.api.server import create_server as jcreate
    from forge_tpu.runtime.models import ModelManager as JManager
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.runtime.models import ModelManager

    jmm, tmm = JManager(), ModelManager(device="cpu")
    jsrv, tsrv = jcreate(jmm, "127.0.0.1", 0), create_server(tmm, "127.0.0.1", 0)
    yield _serve(jsrv), _serve(tsrv)
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.server_close()
    tmm.close()


def _both(servers, payload):
    return [_call(base, "/sdapi/v1/interrogate", payload)[:2] for base in servers]


def test_route_clip_and_deepbooru(models, servers, monkeypatch):
    from forge_tpu.postprocessing import deepbooru as jdeepbooru
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.postprocessing import deepbooru as tdeepbooru
    from forge_tpu_torch.runtime.options import opts

    root, tags = models
    monkeypatch.chdir(root)
    _install(monkeypatch, root)
    mdir = os.path.join(str(root), "models", "torch_deepdanbooru")
    jdb = jdeepbooru.DeepDanbooru(model_dir=mdir)
    jdb.load()
    jdb.tags = list(tags)  # forge_tpu's reader drops them
    monkeypatch.setattr(jdeepbooru, "_MODEL", jdb)
    monkeypatch.setattr(tdeepbooru, "_MODEL", tdeepbooru.DeepDanbooru(model_dir=mdir, device="cpu"))
    for img in IMAGES:
        (js, jb), (ts, tb) = _both(servers, {"image": _png_b64(img)})
        assert js == ts == 200 and tb == jb and tb["caption"].count(", ") == 5
    settings = {"interrogate_deepbooru_score_threshold": 0.1, "deepbooru_sort_alpha": False,
                "deepbooru_use_spaces": False, "deepbooru_escape": False,
                "deepbooru_filter_tags": tags[5]}
    for values in ({}, settings):
        saved = {k: opts.get(k) for k in values}
        for k, v in values.items():  # the handler threads see set options only
            opts.set(k, v)
            jopts.set(k, v)
        try:
            (js, jb), (ts, tb) = _both(servers, {"image": _png_b64(IMAGES[0]),
                                                 "model": "deepbooru"})
        finally:
            for k, v in saved.items():
                opts.set(k, v)
                jopts.set(k, v)
        assert js == ts == 200 and tb == jb and tb["caption"]
        if values:
            assert tags[5] not in tb["caption"].split(", ")


def test_route_refusals(models, servers, monkeypatch, tmp_path):
    from forge_tpu.postprocessing import deepbooru as jdeepbooru
    from forge_tpu_torch.postprocessing import deepbooru as tdeepbooru

    monkeypatch.chdir(tmp_path)  # no models/ here
    empty = str(tmp_path / "models")
    _install(monkeypatch, tmp_path)
    monkeypatch.setattr(jdeepbooru, "_MODEL", jdeepbooru.DeepDanbooru(model_dir=empty))
    monkeypatch.setattr(tdeepbooru, "_MODEL", tdeepbooru.DeepDanbooru(model_dir=empty,
                                                                      device="cpu"))
    (js, jb), (ts, tb) = _both(servers, {"image": ""})
    assert js == ts == 404 and jb == tb and tb["detail"] == "Image not found"
    for model in ("clip", "deepbooru"):
        (js, jb), (ts, tb) = _both(servers, {"image": _png_b64(IMAGES[0]), "model": model})
        assert js == ts == 200 and jb == tb and tb["caption"] == "" and tb["detail"]
    shutil.rmtree(empty, ignore_errors=True)

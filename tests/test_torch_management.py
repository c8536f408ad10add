"""The port's management modules against forge_tpu's (CPU).

The merger (pipeline/merger.py) on three tiny SD1.5 checkpoints written as
files: weighted sum, add difference and no interpolation, a primary key the
secondary holds at another shape (an inpainting model's 9-channel input
conv) kept, the VAE bake-in, `discard_weights` and an f32 export: every
merged file byte-equal to forge_tpu's, a tensor checked against its
formula; add difference without a tertiary refused in both.
`create_embedding` on the tiny SDXL with its CLIP-G 96 wide (wider than
CLIP-L's 64, as SDXL's 1280 against 768): the CLIP-L
vectors bit-equal to forge_tpu's `emb_params`, the CLIP-G ones the rows of
CLIP-G's token table by the same rule; forge_tpu's CLIP-L-only file cannot
fill CLIP-G's slot in either package (a fault on the reference's side,
shown from both sides), the port's file conditions in both.
runtime/extensions.py on a git repository the test makes: install (the
clone, `metadata.ini`'s name and requirements, the git identity), a second
install of the same directory and an empty URL refused, the listing and its
order by requirements, the disabled options, the update check ("latest",
then "new commits" after a commit upstream) and the update to the new
commit; the config states saved and listed. runtime/localization.py's
listing and merged dictionaries, and runtime/logging.py's lines, rotation,
echo and off switch: all as forge_tpu's.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib
import json
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_sd15_checkpoint  # noqa: E402

PACKAGES = ("forge_tpu", "forge_tpu_torch")


def _mods(name):
    return [importlib.import_module(f"{pk}.{name}") for pk in PACKAGES]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from forge_tpu_torch.core.save import save_safetensors

    d = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name, seed in (("a", 0), ("b", 10), ("c", 20)):
        sd = make_sd15_checkpoint(seed)
        if name == "a":  # an inpainting model's input conv: 9 channels
            key = "model.diffusion_model.input_blocks.0.0.weight"
            sd[key] = np.concatenate([sd[key], sd[key][:, :4], sd[key][:, :1]], axis=1)
        paths[name] = str(d / f"{name}.safetensors")
        save_safetensors(sd, paths[name])
    vae = {k[len("first_stage_model."):]: v + 0.5 for k, v in make_sd15_checkpoint(30).items()
           if k.startswith("first_stage_model.")}
    paths["vae"] = str(d / "vae.safetensors")
    save_safetensors(vae, paths["vae"])
    return paths


MERGES = {
    "weighted sum": dict(mode="weighted_sum", multiplier=0.3),
    "add difference": dict(mode="add_difference", multiplier=0.7, tertiary="c"),
    "no interpolation": dict(mode="no_interpolation"),
    "bake in a VAE": dict(mode="weighted_sum", multiplier=0.5, bake_in_vae="vae"),
    "discard weights": dict(mode="weighted_sum", multiplier=0.25,
                            discard_weights=r"^cond_stage_model\.|\.bias$"),
    "f32": dict(mode="add_difference", multiplier=1.0, tertiary="c", dtype=np.float32),
}


@pytest.mark.parametrize("case", list(MERGES))
def test_merger_matches_reference(checkpoints, tmp_path, case):
    from forge_tpu_torch.core.state_dict import load_safetensors

    kw = dict(MERGES[case])
    for key in ("tertiary", "bake_in_vae"):
        if key in kw:
            kw[key] = checkpoints[kw[key]]
    out = {}
    for pk, mod in zip(PACKAGES, _mods("pipeline.merger")):
        path = str(tmp_path / f"{pk}.safetensors")
        assert mod.run_modelmerger(checkpoints["a"], checkpoints["b"], output_path=path,
                                   **kw) == path
        with open(path, "rb") as f:
            out[pk] = f.read()
    assert out["forge_tpu_torch"] == out["forge_tpu"]
    merged = load_safetensors(str(tmp_path / "forge_tpu_torch.safetensors"))
    a, b, c = (load_safetensors(checkpoints[n]) for n in "abc")
    key = "model.diffusion_model.out.2.weight"
    m = kw.get("multiplier", 0.0)
    want = {"weighted_sum": a[key] * (1.0 - m) + b[key] * m,
            "add_difference": a[key] + (b[key] - c[key]) * m,
            "no_interpolation": a[key]}[kw["mode"]]
    assert np.array_equal(merged[key], want.astype(kw.get("dtype", np.float16)))
    conv = "model.diffusion_model.input_blocks.0.0.weight"
    assert np.array_equal(merged[conv], a[conv].astype(merged[conv].dtype))  # kept: 9 channels
    if case == "bake in a VAE":
        vae = load_safetensors(checkpoints["vae"])
        assert all(np.array_equal(merged["first_stage_model." + k], v.astype(np.float16))
                   for k, v in vae.items())
    if case == "discard weights":
        assert not any(k.startswith("cond_stage_model.") or k.endswith(".bias") for k in merged)
        assert len(merged) > 0
    else:
        assert set(merged) == set(a)


def test_add_difference_needs_a_tertiary(checkpoints, tmp_path):
    for mod in _mods("pipeline.merger"):
        with pytest.raises(ValueError, match="tertiary"):
            mod.run_modelmerger(checkpoints["a"], checkpoints["b"], mode="add_difference",
                                output_path=str(tmp_path / "x.safetensors"))


def test_create_embedding_on_sdxl_from_both_sides(tmp_path, monkeypatch):
    """The port's SDXL file: CLIP-L vectors bit-equal to forge_tpu's
    emb_params, CLIP-G ones from CLIP-G's table; forge_tpu's file fails in
    CLIP-G's slot in both packages, the port's conditions in both."""
    from forge_tpu.text.textual_inversion import _token_table as jtable
    from forge_tpu.text.textual_inversion import create_embedding as jcreate
    from forge_tpu_torch.core.state_dict import load_safetensors
    from forge_tpu_torch.text.textual_inversion import create_embedding as tcreate
    from forge_tpu.core.synth import _Fill
    from test_torch_sdxl import G, _jax_engine, _open_clip_g, _port_engine, _tiny_sdxl_checkpoint
    from test_torch_textual_inversion import writable_reference_splice

    # CLIP-G wider than CLIP-L, as SDXL's (1280 and 768): only the text towers run here
    sd = {k: v for k, v in _tiny_sdxl_checkpoint().items() if not k.startswith(G)}
    sd.update(_open_clip_g(_Fill("random", 14), 96, 2))
    sd[G + "positional_embedding"] += 0.5
    jeng, teng = _jax_engine(sd), _port_engine(sd)
    writable_reference_splice(monkeypatch)
    for n, init in ((1, "*"), (3, "a red cat"), (2, "")):
        jpath = jcreate(jeng, "xlemb", num_vectors=n, init_text=init, overwrite=True,
                        out_dir=str(tmp_path / "j"))
        tpath = tcreate(teng, "xlemb", num_vectors=n, init_text=init, overwrite=True,
                        out_dir=str(tmp_path / "t"))
        want, got = load_safetensors(jpath), load_safetensors(tpath)
        assert set(want) == {"emb_params"} and set(got) == {"clip_l", "clip_g"}
        assert np.array_equal(got["clip_l"], want["emb_params"])
        table = np.asarray(jtable(jeng.text_engines["clip_g"].params), np.float32)
        ids = list(teng.text_engines["clip_g"].tokenizer.ids(init)) if init else []
        rows = np.zeros((n, table.shape[1]), np.float32)
        for i in range(n if ids else 0):
            rows[i] = table[ids[i * len(ids) // n]]
        assert np.array_equal(got["clip_g"], rows)
    prompt = ["a photo of xlemb in the snow"]
    for which, d in (("reference's", "j"), ("port's", "t")):
        for eng in (jeng, teng):
            eng.embedding_db.embeddings.clear()
            eng.embedding_db.by_first_id.clear()
            eng.embedding_db.load_dir(str(tmp_path / d))
        if which == "reference's":
            with pytest.raises(ValueError, match=r"'xlemb' has \d+-wide vectors for slot 'g'"):
                teng.text_engines["clip_g"](prompt)
            with pytest.raises(ValueError, match="could not broadcast"):
                jeng.text_engines["clip_g"](prompt)
        else:
            got = teng.text_engines["clip_g"](prompt)[0].numpy()
            want = np.asarray(jeng.text_engines["clip_g"](prompt)[0])
            assert got.shape == want.shape
            # the towers' bar in tests/test_torch_sdxl.py (their summation orders differ)
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- extensions ---------------------------------------------------------------------------------


def _git(cwd, *args):
    subprocess.run(["git", "-c", "user.name=test", "-c", "user.email=test@example.com",
                    "-c", "init.defaultBranch=main", "-C", str(cwd), *args], check=True,
                   capture_output=True)


@pytest.fixture
def origin(tmp_path):
    """A git repository with one extension commit → its path."""
    repo = tmp_path / "origin" / "sd-ext-tiles.git"
    (repo / "scripts").mkdir(parents=True)
    (repo / "metadata.ini").write_text("[Extension]\nName = Tiles\nRequires = base-ext, Other\n")
    (repo / "scripts" / "tiles.py").write_text("# a script\n")
    _git(repo, "init")
    _git(repo, "add", "-A")
    _git(repo, "commit", "-m", "first")
    return repo


def _ext_fields(ext, root):
    return (ext.name, os.path.relpath(ext.path, root), ext.is_builtin, ext.enabled,
            ext.canonical_name, ext.requires, ext.commit_hash, ext.branch, ext.remote, ext.version)


def test_extensions_on_a_local_repository(origin, tmp_path):
    out = {}
    head = subprocess.run(["git", "-C", str(origin), "rev-parse", "HEAD"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for pk, mod in zip(PACKAGES, _mods("runtime.extensions")):
        root = tmp_path / pk
        base = str(root / "extensions")
        ext = mod.install_extension(str(origin), base_dir=base)
        installed = _ext_fields(ext, root)
        with pytest.raises(FileExistsError):
            mod.install_extension(str(origin), base_dir=base)
        with pytest.raises(ValueError, match="no URL"):
            mod.install_extension("  ", base_dir=base)
        os.makedirs(os.path.join(base, "base-ext"))
        other = mod.install_extension(str(origin), dirname="other copy!", base_dir=base)
        listed = mod.list_extensions([str(root / "missing"), base])
        fresh = mod.check_extension_updates(ext)
        _git(origin, "commit", "--allow-empty", "-m", f"second for {pk}")
        new_head = subprocess.run(["git", "-C", str(origin), "rev-parse", "HEAD"],
                                  capture_output=True, text=True, check=True).stdout.strip()
        stale = mod.check_extension_updates(ext)
        updated = mod.update_extension(ext)
        out[pk] = dict(ext=installed, other=_ext_fields(other, root),
                       listed=[_ext_fields(e, root) for e in listed],
                       checks=(fresh, stale, mod.check_extension_updates(ext)),
                       updated=updated == new_head == ext.commit_hash)
        _git(origin, "reset", "--hard", head)
    assert out["forge_tpu_torch"] == out["forge_tpu"]
    got = out["forge_tpu_torch"]
    assert got["ext"][:6] == ("sd-ext-tiles", os.path.join("extensions", "sd-ext-tiles"), False,
                              True, "tiles", ["base-ext", "other"])
    assert got["ext"][6:] == (head, "main", str(origin), head[:8])
    assert got["other"][0] == "other_copy_"
    assert [e[0] for e in got["listed"]] == ["base-ext", "other_copy_", "sd-ext-tiles"]
    assert got["checks"] == ("latest", "new commits", "latest") and got["updated"]


def test_disabled_extensions_and_config_states(tmp_path):
    out = {}
    for pk, ext_mod, opts_mod in zip(PACKAGES, _mods("runtime.extensions"),
                                     _mods("runtime.options")):
        base = tmp_path / pk / "extensions"
        for name in ("b-ext", "a-ext"):
            (base / name).mkdir(parents=True)
        dirs = [str(base)]
        with opts_mod.opts.override({"disabled_extensions": ["b-ext"]}):
            names = [(e.name, e.enabled) for e in ext_mod.list_extensions(dirs)]
        with opts_mod.opts.override({"disable_all_extensions": "extra"}):
            extra = [(e.name, e.enabled) for e in ext_mod.list_extensions(dirs)]
        states_dir = str(tmp_path / pk / "states")
        path = ext_mod.save_config_state("../../mine", dirname=states_dir)
        listed = ext_mod.list_config_states(states_dir)
        out[pk] = (names, extra, os.path.basename(path).split("_", 1)[1],
                   [(s["name"], os.path.basename(s["filepath"]) == os.path.basename(path))
                    for s in listed], ext_mod.list_config_states(str(tmp_path / "none")))
    assert out["forge_tpu_torch"] == out["forge_tpu"] == (
        [("a-ext", True), ("b-ext", False)], [("a-ext", False), ("b-ext", False)], "mine.json",
        [("../../mine", True)], [])


# -- localization and the event log -------------------------------------------------------------


def test_localization_matches_reference(tmp_path, monkeypatch):
    (tmp_path / "localizations").mkdir()
    (tmp_path / "localizations" / "de.json").write_text(json.dumps({"Steps": "Schritte",
                                                                     "Seed": "Saat"}))
    (tmp_path / "localizations" / "broken.json").write_text("{not json")
    (tmp_path / "localizations" / "notes.txt").write_text("x")
    ext = tmp_path / "extensions" / "ext-a" / "localizations"
    ext.mkdir(parents=True)
    (ext / "de.json").write_text(json.dumps({"Seed": "Keim", "CFG": 7}))
    monkeypatch.chdir(tmp_path)
    jloc, tloc = _mods("runtime.localization")
    assert tloc.list_localizations() == jloc.list_localizations() == {
        "broken": ["localizations/broken.json"],
        "de": ["localizations/de.json", "extensions/ext-a/localizations/de.json"]}
    for name in ("de", "broken", "none"):
        assert tloc.load_localization(name) == jloc.load_localization(name)
    assert tloc.load_localization("de") == {"Steps": "Schritte", "Seed": "Keim", "CFG": "7"}


def test_event_log_matches_reference(tmp_path, capsys):
    lines = {}
    for pk, mod in zip(PACKAGES, _mods("runtime.logging")):
        saved = (mod._PATH, mod._ECHO, mod._MAX_BYTES, mod._ENABLED)
        path = str(tmp_path / pk / "sub" / "events.jsonl")
        try:
            mod.configure(path, echo=True, max_bytes=300)
            for i in range(6):
                mod.log_event("generation", sampler="Euler a", steps=i, arr=np.float32(0.5),
                              obj=object, seed=np.int64(7))
            echoed = capsys.readouterr().out.splitlines()
            mod.configure(path, enabled=False)
            mod.log_event("generation", steps=99)
        finally:
            mod._PATH, mod._ECHO, mod._MAX_BYTES, mod._ENABLED = saved

        def read(p):
            with open(p, encoding="utf-8") as f:
                return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]

        lines[pk] = (read(path + ".1"), read(path),
                     [{k: v for k, v in json.loads(line).items() if k != "ts"}
                      for line in echoed])
    assert lines["forge_tpu_torch"] == lines["forge_tpu"]
    rotated, current, echoed = lines["forge_tpu_torch"]
    assert rotated + current == echoed and len(echoed) == 6 and len(current) < 6
    assert echoed[0] == {"event": "generation", "sampler": "Euler a", "steps": 0, "arr": 0.5,
                         "obj": "<class 'object'>", "seed": 7.0}

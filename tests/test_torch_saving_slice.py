"""Saving in `process_images`, the port's against forge_tpu's (CPU, f32).

The tiny SD1.5 of tests/fixtures.py (64², Euler a, 3 steps, CFG 7) through
both packages with `samples_save`, `grid_save` and `save_write_params_txt`
on, each package's output directories, working directory (params.txt) and
event log under its own temporary directory, and a fixed clock: txt2img at
batch 2 writes the same files in both (two samples and log.csv under
txt2img-images/<date>/, the grid and its log.csv under txt2img-grids/),
each PNG holding its package's image and infotext, the two packages' images
at the bar of tests/test_torch_api.py (40 dB) and log.csv the same rows but
for the infotexts' version; img2img writes under img2img-images; with
`do_not_save_samples` and `do_not_save_grid` nothing but params.txt. Each
request logs one `generation` event whose fields equal the reference's but
for the times. The selectable scripts' inner requests set the two fields as
the reference's do, and they take effect in both packages: the prompt
matrix's requests at batch 2 save their samples and no grid, SD upscale's
tiles nothing.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import contextlib
import csv
import datetime
import importlib
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_controls_cases import (PACKAGES, SD15_REQUEST, assert_slice, init_and_mask,  # noqa: E402
                                  processing, sd15_engines)

BAR = 40.0  # tests/test_torch_api.py's bar on the tiny SD1.5
NOW = datetime.datetime(2026, 3, 4, 5, 6, 7)
SAVING = {"samples_save": True, "grid_save": True, "save_write_params_txt": True}


@pytest.fixture(scope="module")
def engines():
    return sd15_engines()


@contextlib.contextmanager
def saving(package, root):
    """`package` saving into `root`: its options on, its working directory
    and event log there, the clock fixed → the event log's path."""
    opts = importlib.import_module(f"{package}.runtime.options").opts
    images = importlib.import_module(f"{package}.pipeline.images")
    log = importlib.import_module(f"{package}.runtime.logging")

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return NOW

    os.makedirs(root, exist_ok=True)
    cwd, saved_path, saved_clock = os.getcwd(), log._PATH, images.datetime
    events = os.path.join(root, "events.jsonl")
    os.chdir(root)
    log._PATH, images.datetime = events, types.SimpleNamespace(datetime=Clock)
    try:
        with opts.override(dict(SAVING, **{k: os.path.join(root, v) for k, v in (
                ("outdir_txt2img_samples", "txt2img-images"),
                ("outdir_img2img_samples", "img2img-images"),
                ("outdir_txt2img_grids", "txt2img-grids"),
                ("outdir_img2img_grids", "img2img-grids"))})):
            yield events
    finally:
        os.chdir(cwd)
        log._PATH, images.datetime = saved_path, saved_clock


def run_both(engines, root, run):
    """run(package, engine) in each package under `saving` → {package:
    (its result, {relative path: bytes}, its event lines)}."""
    out = {}
    for package, engine in zip(PACKAGES, engines):
        pk_root = os.path.join(root, package)
        with saving(package, pk_root) as events:
            result = run(package, engine)
        files = {}
        for d, _, names in os.walk(pk_root):
            for n in names:
                path = os.path.join(d, n)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, pk_root)] = f.read()
        lines = [json.loads(line) for line in files.pop("events.jsonl", b"").splitlines()]
        out[package] = (result, files, lines)
    return out


def _png(data):
    from forge_tpu_torch.pipeline.images import decode_png

    return decode_png(data)


def _csv_rows(data):
    return [r[:3] + [r[3].split("Version:")[0]] for r in csv.reader(data.decode().splitlines())]


def _generation_fields(lines):
    return [{k: v for k, v in line.items() if k != "ts" and not k.startswith("t_")}
            for line in lines if line["event"] == "generation"]


def _hold_files(out, images_dir):
    """The same paths in both; each PNG its package's image and infotext
    (the grid the images' grid under the first infotext); log.csv's rows
    equal but for the infotexts' version → the port's paths."""
    (jres, jfiles, _), (tres, tfiles, _) = out["forge_tpu"], out["forge_tpu_torch"]
    assert sorted(tfiles) == sorted(jfiles)
    samples = sorted(p for p in tfiles if p.startswith(images_dir) and p.endswith(".png"))
    assert len(samples) == len(tres.images)
    for res, files in ((jres, jfiles), (tres, tfiles)):
        for i, rel in enumerate(samples):
            pixels, text = _png(files[rel])
            assert np.array_equal(pixels, res.images[i]) and text == {
                "parameters": res.infotexts[i]}
        assert files["params.txt"].decode() == res.infotexts[0]
    for rel in tfiles:
        if rel.endswith("log.csv"):
            assert _csv_rows(tfiles[rel]) == _csv_rows(jfiles[rel])
    return sorted(tfiles)


def test_txt2img_samples_and_grid(engines, tmp_path):
    fields = dict(SD15_REQUEST, batch_size=2)
    out = run_both(engines, str(tmp_path), lambda pk, eng: processing(pk).process_images(
        eng, processing(pk).Processing(**fields)))
    got, want = out["forge_tpu_torch"][0], out["forge_tpu"][0]
    assert_slice(got, want, bar=BAR)
    paths = _hold_files(out, "txt2img-images")
    assert paths == ["params.txt", "txt2img-grids/2026-03-04/00000-grid-1-a_photograph_of_an_"
                     "astronaut_riding_a_horse.png", "txt2img-grids/2026-03-04/log.csv",
                     "txt2img-images/2026-03-04/00000-1-a photograph of an astronaut riding a "
                     "horse.png", "txt2img-images/2026-03-04/00001-2-a photograph of an astronaut "
                     "riding a horse.png", "txt2img-images/2026-03-04/log.csv"]
    from forge_tpu_torch.pipeline.images import image_grid

    grid, text = _png(out["forge_tpu_torch"][1][paths[1]])
    assert np.array_equal(grid, image_grid(got.images)) and text["parameters"] == got.infotexts[0]
    events = [_generation_fields(out[pk][2]) for pk in PACKAGES]
    assert events[1] == events[0] == [dict(event="generation", sampler="Euler a", steps=3,
                                           width=64, height=64, batch_size=2, n_iter=1, seed=1,
                                           is_img2img=False)]
    assert {"t_total"} <= set(out["forge_tpu_torch"][2][0])


def test_img2img_sample(engines, tmp_path):
    init, _ = init_and_mask()
    fields = dict(SD15_REQUEST, init_images=[init], denoising_strength=0.6)
    out = run_both(engines, str(tmp_path), lambda pk, eng: processing(pk).process_images(
        eng, processing(pk).Processing(**fields)))
    assert_slice(out["forge_tpu_torch"][0], out["forge_tpu"][0], bar=BAR)
    paths = _hold_files(out, "img2img-images")
    assert paths == ["img2img-images/2026-03-04/00000-1-a photograph of an astronaut riding a "
                     "horse.png", "img2img-images/2026-03-04/log.csv", "params.txt"]
    events = [_generation_fields(out[pk][2]) for pk in PACKAGES]
    assert events[1] == events[0] and events[0][0]["is_img2img"] is True


def test_do_not_save(engines, tmp_path):
    fields = dict(SD15_REQUEST, batch_size=2, do_not_save_samples=True, do_not_save_grid=True)
    out = run_both(engines, str(tmp_path), lambda pk, eng: processing(pk).process_images(
        eng, processing(pk).Processing(**fields)))
    for package in PACKAGES:
        assert sorted(out[package][1]) == ["params.txt"]
        assert len(_generation_fields(out[package][2])) == 1


def _script(package, name, fields, *args, **kwargs):
    def run(pk, engine):
        mod = importlib.import_module(f"{pk}.pipeline.selectable_scripts")
        return mod.get_script(name).run(engine, processing(pk).Processing(**fields), *args,
                                        **kwargs)
    return run


def test_selectable_scripts_set_the_fields(engines, tmp_path):
    """The prompt matrix's inner requests (do_not_save_grid) at batch 2: their
    samples saved, no grid; SD upscale's tiles (both fields): nothing."""
    fields = dict(SD15_REQUEST, prompt="a cat|on the moon", batch_size=2)
    out = run_both(engines, str(tmp_path / "matrix"), _script("", "Prompt matrix", fields))
    for package in PACKAGES:
        files = sorted(out[package][1])
        assert [f.split("/")[0] for f in files] == ["params.txt"] + ["txt2img-images"] * 5, files
        assert len(_generation_fields(out[package][2])) == 2
    assert sorted(out["forge_tpu_torch"][1]) == sorted(out["forge_tpu"][1])
    init, _ = init_and_mask()
    fields = dict(SD15_REQUEST, init_images=[init], denoising_strength=0.6)
    out = run_both(engines, str(tmp_path / "upscale"),
                   _script("", "SD upscale", fields, None, 16, "Lanczos", 2.0))
    for package in PACKAGES:
        assert sorted(out[package][1]) == ["params.txt"]

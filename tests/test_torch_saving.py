"""The port's `save_image` (pipeline/images.py) against forge_tpu's (CPU).

The same seeded images go through both packages' `save_image`, each into a
directory of its own, under the same saving options and a fixed clock: the
relative paths (the `[date]` directory, the five-digit number prefix, the
name pattern with the reference's whole token set, the `-N` suffix on a
clash) are equal, the PNGs' pixels and "parameters" text are equal (read
back by Pillow and by the port's codec), and so are `log.csv` and the
`.txt` beside the image under `save_txt`; `enable_pnginfo` off writes no
text. `before_image_saved` and `image_saved` get the same (path, pixels,
infotext) in both. Formats other than PNG raise NotImplementedError in the
port before anything is written; the reference writes JPEG and WebP through
Pillow, and where Pillow cannot write AVIF or GIF (simulated here: the
card's machine has no Pillow) it writes a PNG without the infotext under
another name than the one `before_image_saved` announced, both sides shown.
`read_infotext` reads the text back; the stealth infotext
(pipeline/stealth_infotext.py) is bit-equal to forge_tpu's.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import datetime
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

PACKAGES = ("forge_tpu", "forge_tpu_torch")
NOW = datetime.datetime(2026, 3, 4, 5, 6, 7)
ALL_TOKENS = "_".join(f"[{t}]" for t in (
    "seed", "seed_first", "prompt_spaces", "prompt", "prompt_no_styles", "prompt_words",
    "prompt_hash", "date", "datetime", "job_timestamp", "width", "height", "model_name",
    "model_hash", "sampler", "sampler_scheduler", "steps", "cfg", "denoising", "clip_skip",
    "batch_number", "generation_number", "user", "image_hash", "none", "styles"))
EXTRA = dict(width=64, height=48, model_name="tiny", model_hash="abc123", sampler="Euler a",
             steps=3, cfg=7.0, batch_number=1, generation_number=5)
INFOTEXT = "a cat: on a mat\nNegative prompt: blurry\nSteps: 3, Sampler: Euler a, Seed: 7"


def _modules(name):
    import importlib

    return [importlib.import_module(f"{pk}.{name}") for pk in PACKAGES]


@pytest.fixture
def fixed_clock(monkeypatch):
    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return NOW

    for mod in _modules("pipeline.images"):
        monkeypatch.setattr(mod, "datetime", types.SimpleNamespace(datetime=Clock))


@pytest.fixture
def both_options():
    """A context that sets saving options in both packages."""
    import contextlib

    jopts, topts = (m.opts for m in _modules("runtime.options"))

    @contextlib.contextmanager
    def override(values):
        with jopts.override(values), topts.override(values):
            yield

    return override


def _images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(n)]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _read_png(data):
    from forge_tpu_torch.pipeline.images import decode_png

    import io

    pil = Image.open(io.BytesIO(data))
    pixels, text = decode_png(data)
    assert np.array_equal(np.asarray(pil), pixels)
    assert dict(pil.info) == {k: v for k, v in text.items()}
    return pixels, text


def _save_both(tmp_path, calls, **kwargs):
    """Each (image, fields) of `calls` saved by both packages → the two
    returned path lists, relative to each package's root."""
    paths = {}
    for pk, mod in zip(PACKAGES, _modules("pipeline.images")):
        root = str(tmp_path / pk)
        paths[pk] = [os.path.relpath(mod.save_image(img, outdir=root, **dict(kwargs, **fields)),
                                     root) for img, fields in calls]
    return paths["forge_tpu"], paths["forge_tpu_torch"]


CASES = {
    "defaults": ({}, {}),
    "prompt words": ({"samples_filename_pattern": "[seed]-[prompt_words]",
                      "directories_max_prompt_words": 2}, {}),
    "every token": ({"samples_filename_pattern": ALL_TOKENS}, EXTRA),
    "directory pattern": ({"directories_filename_pattern": "[prompt_words]-[seed]"}, {}),
    "no dirs, no number": ({"save_to_dirs": False, "save_images_add_number": False}, {}),
    "empty pattern": ({"samples_filename_pattern": "[none]"}, {}),
    "txt, no csv": ({"save_txt": True, "save_write_log_csv": False}, {}),
    "no pnginfo": ({"enable_pnginfo": False}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_save_image_matches_reference(tmp_path, fixed_clock, both_options, case):
    options, extra = CASES[case]
    imgs = _images()
    prompts = ["a cat: on a mat", "a cat: on a mat", "", "naïve <dog>|?"]
    calls = [(img, dict(seed=7 if i < 2 else i, prompt=prompts[i], infotext=INFOTEXT, **extra))
             for i, img in enumerate(imgs)]
    with both_options(options):
        want, got = _save_both(tmp_path, calls)
    assert got == want
    assert len(set(got)) == len(got)  # a clash gets a number or a -N suffix
    jtree, ttree = _tree(tmp_path / "forge_tpu"), _tree(tmp_path / "forge_tpu_torch")
    assert sorted(ttree) == sorted(jtree)
    for rel, data in ttree.items():
        if rel.endswith(".png"):
            jpix, jtext = _read_png(jtree[rel])
            tpix, ttext = _read_png(data)
            assert np.array_equal(tpix, jpix) and ttext == jtext
            assert np.array_equal(tpix, imgs[got.index(rel)])
            assert ttext == ({} if case == "no pnginfo" else {"parameters": INFOTEXT})
        else:  # log.csv and the .txt beside an image: byte for byte
            assert data == jtree[rel], rel
    names = {os.path.basename(r) for r in ttree}
    assert ("log.csv" in names) == (case != "txt, no csv")
    assert any(n.endswith(".txt") for n in names) == (case == "txt, no csv")
    if case == "every token":
        assert got[0].endswith(".png") and "2026-03-04" in got[0] and "20260304050607" in got[0]


def test_clash_suffix_without_number(tmp_path, fixed_clock, both_options):
    calls = [(img, dict(seed=3, prompt="same")) for img in _images(3)]
    with both_options({"save_images_add_number": False, "save_to_dirs": False}):
        want, got = _save_both(tmp_path, calls)
    assert got == want == ["3-same.png", "3-same-1.png", "3-same-2.png"]


def test_save_events_match_reference(tmp_path, fixed_clock):
    """before_image_saved and image_saved: (path, pixels, infotext) equal."""
    logs = {}
    for pk, mod, scripts in zip(PACKAGES, _modules("pipeline.images"),
                                _modules("runtime.scripts")):
        seen = logs.setdefault(pk, [])
        root = str(tmp_path / pk)
        try:
            for event in ("before_image_saved", "image_saved"):
                scripts.on(event, lambda path, img, text, _e=event, _s=seen, _r=root: _s.append(
                    (_e, os.path.relpath(path, _r), np.asarray(img).copy(), text)))
            for img in _images(2):
                mod.save_image(img, outdir=root, seed=5, prompt="a dog", infotext=INFOTEXT)
        finally:
            for event in ("before_image_saved", "image_saved"):
                scripts.clear(event)
    want, got = logs["forge_tpu"], logs["forge_tpu_torch"]
    assert [g[0] for g in got] == ["before_image_saved", "image_saved"] * 2
    assert [(g[0], g[1], g[3]) for g in got] == [(w[0], w[1], w[3]) for w in want]
    assert all(np.array_equal(g[2], w[2]) for g, w in zip(got, want))


@pytest.mark.parametrize("fmt", ["jpg", "webp", "avif", "gif"])
def test_other_formats_refused(tmp_path, fmt, both_options):
    """The port refuses every format but PNG before it writes or fires
    anything; the reference writes the format through Pillow."""
    from forge_tpu.pipeline import images as jimages
    from forge_tpu_torch.pipeline import images as timages

    img = _images(1)[0]
    with both_options({"samples_format": fmt}):
        path = jimages.save_image(img, outdir=str(tmp_path / "j"), seed=1, prompt="x",
                                  infotext=INFOTEXT)
        with pytest.raises(NotImplementedError, match="item 7"):
            timages.save_image(img, outdir=str(tmp_path / "t"), seed=1, prompt="x",
                               infotext=INFOTEXT)
    assert path.endswith("." + fmt) and os.path.getsize(path) > 0
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("fmt", ["avif", "gif"])
def test_avif_gif_fallback_from_both_sides(tmp_path, monkeypatch, both_options, fmt):
    """Where Pillow cannot write the format, the reference quietly writes a
    PNG without its infotext under the stem, after announcing the other name
    to before_image_saved; the port raises NotImplementedError naming item 7."""
    from forge_tpu.pipeline import images as jimages
    from forge_tpu.runtime import scripts as jscripts
    from forge_tpu_torch.pipeline import images as timages

    real_save = Image.Image.save

    def no_plugin(self, fp, format=None, **params):
        if str(fp).endswith("." + fmt):
            raise KeyError(fmt.upper())
        return real_save(self, fp, format=format, **params)

    monkeypatch.setattr(Image.Image, "save", no_plugin)
    announced = []
    jscripts.on("before_image_saved", lambda path, img, text: announced.append(path))
    try:
        with both_options({"samples_format": fmt}):
            path = jimages.save_image(_images(1)[0], outdir=str(tmp_path / "j"), seed=1,
                                      prompt="x", infotext=INFOTEXT)
            with pytest.raises(NotImplementedError, match="item 7"):
                timages.save_image(_images(1)[0], outdir=str(tmp_path / "t"), seed=1,
                                   prompt="x", infotext=INFOTEXT)
    finally:
        jscripts.clear("before_image_saved")
    assert path.endswith(".png") and announced == [path[:-4] + "." + fmt]
    with open(path, "rb") as f:
        pixels, text = _read_png(f.read())
    assert np.array_equal(pixels, _images(1)[0]) and "parameters" not in text


def test_read_infotext(tmp_path, both_options):
    from forge_tpu.pipeline import images as jimages
    from forge_tpu_torch.pipeline import images as timages

    with both_options({"save_to_dirs": False}):
        path = timages.save_image(_images(1)[0], outdir=str(tmp_path), seed=1, prompt="x",
                                  infotext="naïve ✓\nSteps: 3")
    assert timages.read_infotext(path) == jimages.read_infotext(path) == "naïve ✓\nSteps: 3"
    with open(path, "rb") as f:
        assert timages.read_infotext(f.read()) == "naïve ✓\nSteps: 3"


@pytest.mark.parametrize("shape", [(8, 8), (64, 48), (200, 300)])
def test_stealth_infotext_matches_reference(shape):
    from forge_tpu.pipeline import stealth_infotext as jst
    from forge_tpu_torch.pipeline import stealth_infotext as tst

    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    text = "a cat\nNegative prompt: blurry\nSteps: 20, Seed: 1, " + "x" * shape[1]
    got, want = tst.add_stealth_infotext(img, text), jst.add_stealth_infotext(img, text)
    assert got.dtype == np.uint8 and got.shape == shape + (4,)
    assert np.array_equal(got, want)
    assert np.array_equal(got[..., :3], img)
    fits = shape != (8, 8)  # 64 pixels cannot carry the signature and the payload
    assert tst.read_stealth_infotext(got) == jst.read_stealth_infotext(want) == (
        text if fits else None)
    assert tst.read_stealth_infotext(img) is None

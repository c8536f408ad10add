"""The selectable scripts (forge_tpu_torch/pipeline/selectable_scripts.py)
against forge_tpu's: the registry and its helpers, and the txt2img-side
scripts through both packages (CPU, f32).

The tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M Karras, 3 steps,
CFG 7): a prompt matrix of three parts (its grid with a margin, then its
four images), prompts from a two-line textbox with `--seed`, `--steps` and
`--cfg_scale`, and Custom code, refused without `allow_code` in both
packages and run with it. Each image at the slice bar (80 dB), the
infotexts and seeds equal. tests/test_torch_selectable_scripts_img2img.py
holds the img2img scripts.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib
import random

import pytest

torch = pytest.importorskip("torch")

from torch_controls_cases import (PACKAGES, SDXL_REQUEST, assert_slice, processing,  # noqa: E402
                                  sdxl_engines)


def scripts_of(package):
    return importlib.import_module(f"{package}.pipeline.selectable_scripts")


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


def run_script(engines, name, fields, *args, **kwargs):
    """The script `name` in both packages on Processing(**fields) → (the
    port's Processed, the reference's, the port's p)."""
    out = []
    for package, engine in zip(PACKAGES, engines):
        p = processing(package).Processing(**fields)
        out.append((scripts_of(package).get_script(name).run(engine, p, *args, **kwargs), p))
    (want, _), (got, tp) = out
    return got, want, tp


def test_registry_matches_forge_tpu():
    jmod, tmod = scripts_of("forge_tpu"), scripts_of("forge_tpu_torch")
    assert list(tmod.SELECTABLE) == list(jmod.SELECTABLE)
    for key, s in tmod.SELECTABLE.items():
        j = jmod.SELECTABLE[key]
        assert (s.name, s.is_img2img, s.ui_spec) == (j.name, j.is_img2img, j.ui_spec)
    assert tmod.get_script("LOOPBACK") is tmod.SELECTABLE["loopback"]
    with pytest.raises(KeyError) as got:
        tmod.get_script("x/y/z plot")
    with pytest.raises(KeyError) as want:
        jmod.get_script("x/y/z plot")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("line", [
    "a cat", "a cat --steps 12 --width 640", "--prompt 'a dog, sitting' --seed 3 --cfg_scale 5.5",
    "a castle --negative_prompt \"blurry, dark\" --sampler_name DPM++ 2M --n_iter 2",
    "a house --denoising_strength 0.3 --subseed_strength 0.1 --subseed 4"])
def test_parse_prompt_line_matches_forge_tpu(line):
    assert (scripts_of("forge_tpu_torch").parse_prompt_line(line)
            == scripts_of("forge_tpu").parse_prompt_line(line))


def test_parse_prompt_line_refuses_what_forge_tpu_refuses():
    """A value that takes the words after it (a prompt after a number): a
    ValueError in both packages."""
    for package in PACKAGES:
        with pytest.raises(ValueError, match="could not convert"):
            scripts_of(package).parse_prompt_line("--denoising_strength 0.3 a house")


def test_fix_seed_clone_and_merge_match_forge_tpu():
    seeds = []
    for package in PACKAGES:
        p = processing(package).Processing(prompt="x", seed=-1, extra_generation_params={"a": 1})
        random.seed(11)
        scripts_of(package)._fix_seed(p)
        seeds.append(p.seed)
        p.all_seeds = [1]
        q = scripts_of(package)._clone(p)
        assert q.all_seeds is None and q.seed == p.seed and q.prompt == "x"
        assert q.extra_generation_params == {"a": 1}
        assert q.extra_generation_params is not p.extra_generation_params
    assert seeds[0] == seeds[1] and seeds[0] != -1


def test_prompt_matrix_matches_forge_tpu(engines):
    fields = dict(SDXL_REQUEST, prompt="a castle|on a hill|at night")
    got, want, _ = run_script(engines, "Prompt matrix", fields, margin_size=2)
    assert len(got.images) == 5 and got.images[0].shape == (2 * 64 + 2, 2 * 64 + 2, 3)
    assert_slice(got, want)
    assert got.seeds == want.seeds == [1] * 4
    prompts = [t.split("\n")[0] for t in got.infotexts[1:]]
    assert prompts == ["a castle", "a castle, on a hill", "a castle, at night",
                       "a castle, on a hill, at night"]
    assert (got.images[0][64:66] == 255).all()  # the margin between the rows
    got, want, _ = run_script(engines, "Prompt matrix", fields, put_at_start=True,
                              different_seeds=True, variations_delimiter="space")
    assert_slice(got, want)
    assert got.seeds == want.seeds == [1, 2, 3, 4]


def test_prompts_from_textbox_matches_forge_tpu(engines):
    text = "a cat --seed 3 --steps 2\n\n a dog in the snow --cfg_scale 5"
    got, want, _ = run_script(engines, "Prompts from file or textbox", dict(SDXL_REQUEST),
                              prompt_txt=text)
    assert_slice(got, want)
    assert got.seeds == want.seeds == [3, 1]
    assert "Steps: 2," in got.infotexts[0] and "CFG scale: 5" in got.infotexts[1]
    got, want, _ = run_script(engines, "Prompts from file or textbox",
                              dict(SDXL_REQUEST, seed=9), True, False, "a cat\na dog")
    assert_slice(got, want)
    assert got.seeds == want.seeds == [9, 10]
    for package, engine in zip(PACKAGES, engines):
        with pytest.raises(ValueError, match="no prompt lines"):
            scripts_of(package).get_script("Prompts from file or textbox").run(
                engine, processing(package).Processing(**SDXL_REQUEST), prompt_txt=" \n")


def test_custom_code_needs_allow_code(engines, monkeypatch):
    """Refused (PermissionError) without --allow-code in both packages;
    with it, the code's edits to p reach the request, and a `result` it
    leaves is returned as it is."""
    code = "p.steps = 2\np.prompt = 'a red ' + p.prompt"
    for package, engine in zip(PACKAGES, engines):
        server = importlib.import_module(f"{package}.api.server")
        monkeypatch.setitem(server.CMD_FLAGS, "allow_code", False)
        with pytest.raises(PermissionError, match="--allow-code"):
            scripts_of(package).get_script("Custom code").run(
                engine, processing(package).Processing(**SDXL_REQUEST), code=code)
        monkeypatch.setitem(server.CMD_FLAGS, "allow_code", True)
    got, want, _ = run_script(engines, "Custom code", dict(SDXL_REQUEST), code=code)
    assert_slice(got, want)
    assert got.infotexts[0].startswith("a red a photograph") and "Steps: 2," in got.infotexts[0]
    out = scripts_of("forge_tpu_torch").get_script("Custom code").run(
        engines[1], processing("forge_tpu_torch").Processing(**SDXL_REQUEST),
        code="result = Processed(images=[], seeds=[], subseeds=[], infotexts=['kept'], "
             "params={}, timings={})")
    assert out.infotexts == ["kept"] and out.images == []

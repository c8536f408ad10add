"""The script runner and the callback registry (forge_tpu_torch/runtime/
scripts.py) against forge_tpu's, and the hook sites of the port's
process_images (CPU, f32).

A recording Script (every hook, its arguments reduced to what both packages
share: the request, shapes, batch numbers, prompts, seeds, indices) and
recording callbacks on the events run through both packages' process_images
on the tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M Karras, 3 steps,
CFG 7): txt2img at batch 2 × n_iter 2, img2img, inpaint and a hires pass.
The calls, their order and their arguments are equal, and the images meet
the slice bar (80 dB). A script whose hooks return None leaves the bytes as
they are without it; a CFG event's post hook acts as forge_tpu's does; a
raising script or callback is printed and passed over, in both packages;
`post_sample` is called by neither.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import contextlib
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_controls_cases import (PACKAGES, SDXL_REQUEST, assert_slice, init_and_mask,  # noqa: E402
                                  processing, sdxl_engines)

CASES = {
    "txt2img batch 2 x n_iter 2": dict(batch_size=2, n_iter=2),
    "img2img": dict(denoising_strength=0.6),
    "inpaint": dict(denoising_strength=0.6, mask=True),
    "hires": dict(enable_hr=True, hr_scale=2.0, hr_upscaler="Latent", hr_second_pass_steps=2,
                  hr_denoising_strength=0.5),
}
HOOKS = ("setup", "before_process", "process", "before_process_batch", "process_batch",
         "process_before_every_sampling", "after_extra_networks_activate",
         "before_process_init_images", "before_hr", "post_sample", "on_mask_blend",
         "postprocess_batch", "postprocess_batch_list", "postprocess_image",
         "postprocess_image_after_composite", "postprocess")


def scripts_module(package):
    return importlib.import_module(f"{package}.runtime.scripts")


def _reduce(value, p):
    """An argument as both packages can agree on it."""
    if value is p:
        return "p"
    if isinstance(value, np.ndarray):
        return ("array", value.shape, str(value.dtype))
    if isinstance(value, list):
        return [_reduce(v, p) for v in value]
    if isinstance(value, dict):
        return ("dict", tuple(sorted(value)))
    if hasattr(value, "images") and hasattr(value, "infotexts"):
        return ("processed", len(value.images), list(value.seeds))
    return value


def recording_script(package, log, returns_none=True):
    """A Script of `package` that logs every hook's call; its hooks return
    None (or, with returns_none False, the base class's value)."""
    base = scripts_module(package).Script

    class Recorder(base):
        name = "recorder"
        request = None  # the request its arguments are reduced against

    def make(hook):
        def method(self, p, *args, **kwargs):
            log.append((hook, [_reduce(a, self.request) for a in (p,) + args],
                        {k: _reduce(v, self.request) for k, v in sorted(kwargs.items())}))
            return None if returns_none else getattr(base, hook)(self, p, *args, **kwargs)
        return method

    for hook in HOOKS:
        setattr(Recorder, hook, make(hook))
    return Recorder()


def _request(package, case, log):
    """The case's Processing in `package`, with a recording runner."""
    proc = processing(package)
    fields = dict(CASES[case])
    mask = fields.pop("mask", False)
    p = proc.Processing(**{**SDXL_REQUEST, **fields})
    if case != "txt2img batch 2 x n_iter 2" and case != "hires":
        init, m = init_and_mask()
        p.init_images = [init]
        if mask:
            p.inpaint_mask = m
    runner = scripts_module(package).ScriptRunner()
    script = recording_script(package, log)
    script.request = p
    runner.register(script)
    p.scripts = runner
    return p


def _register_events(package, log):
    mod = scripts_module(package)
    mod.on("before_process", lambda p: log.append(("event before_process", p.prompt)))
    for event in ("cfg_denoiser", "cfg_denoised", "cfg_after_cfg"):
        mod.on(event, lambda hp, e=event: log.append(
            (f"event {e}", hp.total_sampling_steps, len(hp.sigmas), hp.p.prompt, hp.p.cfg_scale)))


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


@pytest.fixture(scope="module")
def recorded(engines):
    """case → {package: (the Processed, the hook log, what the runner printed)}."""
    out = {}
    for case in CASES:
        out[case] = {}
        for package, engine in zip(PACKAGES, engines):
            log, printed = [], io.StringIO()
            mod = scripts_module(package)
            _register_events(package, log)
            try:
                p = _request(package, case, log)
                with contextlib.redirect_stdout(printed):
                    res = processing(package).process_images(engine, p)
            finally:
                mod.clear()
            out[case][package] = (res, log, printed.getvalue())
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_hooks_and_events_match_forge_tpu(recorded, case):
    (want, want_log, want_out), (got, got_log, got_out) = (recorded[case][package]
                                                           for package in PACKAGES)
    assert "failed" not in want_out + got_out
    assert got_log == want_log
    names = [entry[0] for entry in got_log]
    assert "post_sample" not in names  # defined, and called by neither package
    assert names[:3] == ["setup", "before_process", "process"]
    assert names[3] == "event before_process" and names[-1] == "postprocess"
    batches = CASES[case].get("n_iter", 1)
    assert names.count("process_before_every_sampling") == batches
    assert names.count("event cfg_denoiser") == batches * (2 if case == "hires" else 1)
    assert names.count("before_hr") == (1 if case == "hires" else 0)
    assert names.count("before_process_init_images") == (1 if "img2img" in case
                                                          or case == "inpaint" else 0)
    assert names.count("on_mask_blend") == (1 if case == "inpaint" else 0)
    assert names.count("postprocess_image") == len(got.images)
    assert_slice(got, want)


def test_scripts_returning_none_leave_the_bytes(engines, capsys):
    """The recording script (hooks returning None) and one returning the
    base class's values: the images byte-identical to no script, on a batch
    of two and an inpaint request, and no hook failed."""
    proc = processing("forge_tpu_torch")
    engine = engines[1]
    init, mask = init_and_mask()
    for fields in (dict(batch_size=2), dict(init_images=[init], inpaint_mask=mask,
                                            denoising_strength=0.6)):
        plain = proc.process_images(engine, proc.Processing(**{**SDXL_REQUEST, **fields}))
        for returns_none in (True, False):
            runner = scripts_module("forge_tpu_torch").ScriptRunner()
            runner.register(recording_script("forge_tpu_torch", [], returns_none))
            got = proc.process_images(engine, proc.Processing(
                **{**SDXL_REQUEST, **fields}, scripts=runner))
            assert all(np.array_equal(a, b) for a, b in zip(got.images, plain.images))
            assert got.infotexts == plain.infotexts
    assert "failed" not in capsys.readouterr().out


def test_cfg_event_hooks_act_as_forge_tpu(engines):
    """A cfg_after_cfg callback appending a post-CFG hook (x0 · 0.9) and a
    cfg_denoiser callback appending a pre-CFG hook (the cond direction
    scaled by 1.1): the images at the slice bar, unlike the plain one."""
    from torch_controls_cases import run_both

    def attach(package, p):
        mod = scripts_module(package)
        mod.on("cfg_after_cfg", lambda hp: hp.post_cfg_hooks.append(
            lambda x0, ec, eu, x, s: x0 * 0.9))
        mod.on("cfg_denoiser", lambda hp: hp.pre_cfg_hooks.append(
            lambda ec, eu, x, s: (ec * 1.1, eu)))

    try:
        got, want, _ = run_both(engines, SDXL_REQUEST, attach)
    finally:
        for package in PACKAGES:
            scripts_module(package).clear()
    assert_slice(got, want)
    proc = processing("forge_tpu_torch")
    plain = proc.process_images(engines[1], proc.Processing(**SDXL_REQUEST)).images[0]
    assert not np.array_equal(got.images[0], plain)


def _boom(self, p, *args, **kwargs):
    raise RuntimeError("boom")


@pytest.mark.parametrize("package", PACKAGES)
def test_runner_and_registry_semantics(package, capsys):
    """The runner chains a returned value into the next script's argument,
    keeps the input where every script returns None, prints a raising
    script's traceback and goes on; `fire` does the same for callbacks; the
    registry's events, `callbacks` and `clear` as the reference's."""
    mod = scripts_module(package)
    base = mod.Script

    class Double(base):
        name = "double"

        def postprocess_image(self, p, image, **kw):
            return image * 2

    bad = type("Bad", (base,), {"name": "raises", "postprocess_image": _boom, "process": _boom})
    runner = mod.ScriptRunner()
    for script in (bad(), Double(), base(), Double()):
        runner.register(script)
    assert runner.postprocess_image(None, 3, index=0) == 12
    runner.process(None)
    out = capsys.readouterr().out
    assert out.count("script raises.postprocess_image failed:") == 1
    assert out.count("script raises.process failed:") == 1 and "RuntimeError: boom" in out
    empty = mod.ScriptRunner()
    empty.register(base())
    assert empty.postprocess_batch(None, "images") == "images"
    assert empty.on_mask_blend(None, "blended") == "blended"
    calls = []
    try:
        mod.on("model_loaded", lambda e: calls.append(e))
        mod.on("model_loaded", lambda e: 1 / 0)
        mod.on("model_loaded", lambda e: calls.append(e + 1))
        mod.fire("model_loaded", 1)
        assert calls == [1, 2] and len(mod.callbacks("model_loaded")) == 3
        assert "callback model_loaded failed:" in capsys.readouterr().out
        mod.clear("model_loaded")
        assert mod.callbacks("model_loaded") == []
    finally:
        mod.clear()
    assert mod.EVENTS == scripts_module("forge_tpu").EVENTS


@pytest.mark.parametrize("error", [NotImplementedError, FileNotFoundError])
def test_runner_lets_refusals_through(error, capsys):
    """A refusal or a missing file raised in a hook reaches the port's
    caller, and the scripts after it do not run; the reference's runner
    prints it and goes on (a reference fault: the request answers as if the
    script had run)."""
    for package in PACKAGES:
        mod = scripts_module(package)
        ran = []

        def refuse(self, p, _error=error):
            raise _error("refused")

        runner = mod.ScriptRunner()
        runner.register(type("Refuses", (mod.Script,), {"name": "refuses", "process": refuse})())
        runner.register(type("After", (mod.Script,),
                             {"name": "after", "process": lambda self, p: ran.append(p)})())
        if package == "forge_tpu_torch":
            with pytest.raises(error, match="refused"):
                runner.process(1)
            assert ran == [] and "failed" not in capsys.readouterr().out
        else:
            runner.process(1)
            assert ran == [1] and "script refuses.process failed:" in capsys.readouterr().out
    assert isinstance(mod.scripts_txt2img, mod.ScriptRunner)
    assert mod.scripts_img2img is not mod.scripts_txt2img


@pytest.mark.parametrize("package", PACKAGES)
def test_load_dir(package, tmp_path, capsys):
    """Script subclasses of a directory's .py files registered in name order;
    a file that fails to import is printed and skipped."""
    (tmp_path / "b_two.py").write_text(
        f"from {package}.runtime.scripts import Script\n"
        "class Two(Script):\n    name = 'two'\n")
    (tmp_path / "a_one.py").write_text(
        f"from {package}.runtime.scripts import Script\n"
        "class One(Script):\n    name = 'one'\nclass OneMore(Script):\n    name = 'one more'\n")
    (tmp_path / "c_broken.py").write_text("raise ImportError('no such thing')\n")
    (tmp_path / "notes.txt").write_text("not a script")
    runner = scripts_module(package).ScriptRunner()
    runner.load_dir(str(tmp_path))
    runner.load_dir(str(tmp_path / "missing"))
    assert [s.name for s in runner.scripts] == ["one", "one more", "two"]
    assert "failed loading script" in capsys.readouterr().out


def test_hook_arguments_without_scripts_untouched(engines):
    """A request without scripts fires the before_process event with the
    request (after the seeds resolve) and no hook; the events of both
    packages see the same seeds."""
    seen = {}
    for package, engine in zip(PACKAGES, engines):
        mod = scripts_module(package)
        mod.on("before_process", lambda p, pk=package: seen.setdefault(pk, list(p.all_seeds)))
        try:
            processing(package).process_images(engine, processing(package).Processing(
                **{**SDXL_REQUEST, "seed": 7, "batch_size": 2}))
        finally:
            mod.clear()
    assert seen["forge_tpu"] == seen["forge_tpu_torch"] == [7, 8]

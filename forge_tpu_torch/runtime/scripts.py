# Copied from forge_tpu/runtime/scripts.py (Script, ScriptRunner, the two runners, the callback registry, CFGHookParams); stdlib only, so the port imports no JAX.
"""Script / extension system: lifecycle hooks + global callback registry.

Behavioral twin of the reference's plugin layer (modules/scripts.py:53-352
Script lifecycle, :397-541 discovery; modules/script_callbacks.py:219-690
global events). Scripts hook the pipeline at the same named points
(pipeline/processing.py fires each where forge_tpu fires it); model-surgery
hooks (attention and block patches, CFG hooks) are declarative: scripts
contribute entries to the request's hook manifest, which the next pass's
model function is built from, instead of mutating live modules.

`ScriptRunner._run` and `fire` catch every exception a script or callback
raises, print its traceback ("... failed:") and go on, as the reference
does, except that `_run` lets a refusal (`NotImplementedError`) and a
missing file (`FileNotFoundError`) reach the caller: a request whose
script could not run must not answer as if it had (the reference prints
and returns the image without the script's work). `Script.post_sample` is defined and, as in the reference, never
called by the pipeline.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import traceback
from typing import Callable, Dict, List, Optional


class Script:
    """Base class. Override any subset of the lifecycle methods."""

    name = "script"
    alwayson = False

    def title(self) -> str:
        return self.name

    # -- generation lifecycle (subset of modules/scripts.py:53-352) ----------
    def setup(self, p):                       # after Processing built
        pass

    def before_process(self, p):
        pass

    def process(self, p):                     # before any iteration
        pass

    def before_process_batch(self, p, **kw):
        pass

    def process_batch(self, p, **kw):
        pass

    def process_before_every_sampling(self, p, **kw):
        """Last chance to mutate the hook manifest / conds before the
        sampler runs (the ControlNet attach point)."""

    def after_extra_networks_activate(self, p, **kw):
        """After <lora:...> activation patched the weight trees
        (reference scripts.py:179)."""

    def before_process_init_images(self, p, **kw):
        """img2img only: mutate p.init_images before VAE encode
        (reference scripts.py:864)."""

    def before_hr(self, p):
        """Before the hires-fix second pass (reference scripts.py:348)."""

    def post_sample(self, p, latent, **kw):
        return latent

    def on_mask_blend(self, p, blended, **kw):
        """After the inpaint latent/pixel blend; return a replacement
        blended image (reference scripts.py:244 MaskBlendArgs)."""
        return blended

    def postprocess_batch(self, p, images, **kw):
        return images

    def postprocess_batch_list(self, p, images, **kw):
        """Mutate the accumulated batch image LIST (add/remove/reorder —
        reference scripts.py:225 PostprocessBatchListArgs)."""
        return images

    def postprocess_image(self, p, image, **kw):
        return image

    def postprocess_image_after_composite(self, p, image, **kw):
        """After the inpaint composite pasted generated pixels back
        (reference scripts.py:277)."""
        return image

    def postprocess(self, p, processed):
        pass


class ScriptRunner:
    def __init__(self):
        self.scripts: List[Script] = []

    def register(self, script: Script):
        self.scripts.append(script)

    def load_dir(self, path: str):
        """Auto-discover Script subclasses in scripts/*.py (reference
        scripts.py:397-541 load_scripts)."""
        if not os.path.isdir(path):
            return
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".py"):
                continue
            mod_path = os.path.join(path, fname)
            try:
                spec = importlib.util.spec_from_file_location(f"forge_script_{fname[:-3]}", mod_path)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[spec.name] = mod
                spec.loader.exec_module(mod)
                for obj in vars(mod).values():
                    if isinstance(obj, type) and issubclass(obj, Script) and obj is not Script:
                        self.register(obj())
            except Exception:
                print(f"failed loading script {mod_path}:\n{traceback.format_exc()}")

    def _run(self, method: str, *args, **kwargs):
        result = args[1] if len(args) > 1 else None
        for script in self.scripts:
            try:
                fn = getattr(script, method)
                out = fn(*args, **kwargs)
                if out is not None:
                    result = out
                    if len(args) > 1:
                        args = (args[0], out) + args[2:]
            except (NotImplementedError, FileNotFoundError):
                raise
            except Exception:
                print(f"script {script.name}.{method} failed:\n{traceback.format_exc()}")
        return result

    def setup(self, p):
        self._run("setup", p)

    def before_process(self, p):
        self._run("before_process", p)

    def process(self, p):
        self._run("process", p)

    def before_process_batch(self, p, **kw):
        self._run("before_process_batch", p, **kw)

    def process_batch(self, p, **kw):
        self._run("process_batch", p, **kw)

    def process_before_every_sampling(self, p, **kw):
        self._run("process_before_every_sampling", p, **kw)

    def after_extra_networks_activate(self, p, **kw):
        self._run("after_extra_networks_activate", p, **kw)

    def before_process_init_images(self, p, **kw):
        self._run("before_process_init_images", p, **kw)

    def before_hr(self, p):
        self._run("before_hr", p)

    def post_sample(self, p, latent, **kw):
        return self._run("post_sample", p, latent, **kw)

    def on_mask_blend(self, p, blended, **kw):
        return self._run("on_mask_blend", p, blended, **kw)

    def postprocess_batch(self, p, images, **kw):
        return self._run("postprocess_batch", p, images, **kw)

    def postprocess_batch_list(self, p, images, **kw):
        return self._run("postprocess_batch_list", p, images, **kw)

    def postprocess_image(self, p, image, **kw):
        return self._run("postprocess_image", p, image, **kw)

    def postprocess_image_after_composite(self, p, image, **kw):
        return self._run("postprocess_image_after_composite", p, image, **kw)

    def postprocess(self, p, processed):
        self._run("postprocess", p, processed)


scripts_txt2img = ScriptRunner()
scripts_img2img = ScriptRunner()


# ---------------------------------------------------------------------------
# global callback registry (modules/script_callbacks.py:219-690)

_CALLBACKS: Dict[str, List[Callable]] = {}

EVENTS = (
    "app_started", "model_loaded", "ui_tabs", "before_image_saved",
    "image_saved", "cfg_denoiser", "cfg_denoised", "cfg_after_cfg",
    "before_process", "script_unloaded", "infotext_pasted",
)


class CFGHookParams:
    """Carrier for the cfg_denoiser / cfg_denoised / cfg_after_cfg events.

    Re-expression of the reference's per-step callback params
    (script_callbacks.py CFGDenoiserParams/CFGDenoisedParams/
    AfterCFGCallbackParams), as forge_tpu has it: each event fires ONCE per
    sampling pass instead of every step, and callbacks contribute functions
    that run inside every step of that pass at the equivalent point —
      * cfg_denoiser / cfg_denoised → append to `pre_cfg_hooks`
        (fn(eps_cond, eps_uncond, x, σ) → (eps_cond, eps_uncond))
      * cfg_after_cfg → append to `post_cfg_hooks`
        (fn(x0, eps_cond, eps_uncond, x, σ) → x0)
    """

    def __init__(self, p, sigmas, total_sampling_steps):
        self.p = p
        self.sigmas = sigmas
        self.total_sampling_steps = total_sampling_steps
        self.pre_cfg_hooks: List[Callable] = []
        self.post_cfg_hooks: List[Callable] = []


def on(event: str, fn: Callable):
    _CALLBACKS.setdefault(event, []).append(fn)


def callbacks(event: str) -> List[Callable]:
    return list(_CALLBACKS.get(event, ()))


def fire(event: str, *args, **kwargs):
    for fn in callbacks(event):
        try:
            fn(*args, **kwargs)
        except Exception:
            print(f"callback {event} failed:\n{traceback.format_exc()}")


def clear(event: Optional[str] = None):
    if event is None:
        _CALLBACKS.clear()
    else:
        _CALLBACKS.pop(event, None)

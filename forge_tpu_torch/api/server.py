# Copied from forge_tpu/api/server.py (the route table, _processing_from_payload, _apply_alwayson_scripts, _first_dict, _generate with its script dispatch, the routes this port answers, _Handler with basic auth, CORS, raw answers and the event log, create_server with its ui_tabs and app_started events, the restart latch); PNG through the port's own codec.
"""REST API: the reference's `/sdapi/v1/*` contract on the standard
library's `ThreadingHTTPServer` (routes, JSON bodies, base64 PNG images), so
webui API clients work unchanged.

Every generation, and every checkpoint load, runs on the single work queue
(runtime/queue.py) between `state.begin` and `state.end`, under the request's
`override_settings`. Images come and go as PNG through the port's codec
(pipeline/images.py); the infotext rides in the PNG's "parameters" text.

A request field is passed to the port's `Processing`; one it refuses answers
422 with the refusal's text. The reference's fields the port lacks are
dropped only at the value that is the port's behaviour (no tiling or
hooks); keys that are no request field at all are dropped, as
the reference drops them, and `do_not_save_samples` and `do_not_save_grid`
default to the negation of `save_images`, as the reference's API sets them. `alwayson_scripts` turns
the extensions on, as the reference's dispatch does: ControlNet units, the
IP-Adapter (FaceID and InstantID too), FreeU, the latent modifier, Fooocus
inpaint, ControlLLLite, soft inpainting, StyleAlign, dynamic thresholding,
Kohya HRFix, SAG and PAG; "lora" is accepted and does nothing (LoRAs ride
the prompt). Their weights load on the engine's device, on the work queue.
An unknown name answers 422, as does what an extension refuses.
`script_name` runs a selectable script (pipeline/selectable_scripts.py)
with `script_args` in place of `process_images`; an unknown name answers
422. `/sdapi/v1/scripts` and `/sdapi/v1/script-info` list the always-on and
selectable scripts and the runners' registered ones, and
`/sdapi/v1/xyz-grid` runs the X/Y/Z grid (extensions/xyz_grid.py); an axis
value it refuses answers 422. `/sdapi/v1/extra-single-image` and
`/sdapi/v1/extra-batch-images` restore faces and upscale uploaded images as
the reference's `_upscale_one` does (the registry of pipeline/upscalers.py,
the restorer postprocessing/faces.py picks); `restore_faces` without a
restorer checkpoint answers 422. `/controlnet/model_list`, `/module_list`
and `/version` list the ControlNet models and preprocessors;
`/sdapi/v1/create/embedding`, `/merge-checkpoints` (on the work queue, then
the checkpoint list refreshed), `/extensions*` (install and update answer
403 without --enable-insecure-extension-access), `/config_states*` and the
extra-networks `metadata`, `cards` and `preview` routes manage files as the
reference's do; `GET /` serves the static web UI (404 under --nowebui),
with `/sdapi/v1/localization` and `/sdapi/v1/ui-tabs` (the `ui_tabs`
callbacks' tabs, collected by `create_server`). `/sdapi/v1/server-restart`
latches `restart_requested` once its gate passes and stops the server;
the launcher's loop starts it again. `create_server` fires the `app_started` event
and `serve` `script_unloaded` once it stops serving. Every answered
`/sdapi` route logs an `api_request` event and a server error an
`api_error` event (runtime/logging.py). An image
that is not an 8-bit PNG answers 415 with its format's name. `/sdapi/v1/spaces`, `/spaces/launch` and
`/spaces/terminate` list, start and stop the Forge Spaces of
extensions-builtin/ and extensions/ (runtime/spaces.py), each in a child
process on the card; a bundled Space the port does not run yet answers
501 naming its ROADMAP item.
"""

from __future__ import annotations

import base64
import hmac
import json
import os
import platform
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..pipeline import images as images_mod
from ..pipeline.infotext import infotext_to_processing_args, parse_generation_parameters
from ..pipeline.processing import Processing, process_images
from ..postprocessing.faces import RestorerMissing
from ..runtime.models import ModelManager
from ..runtime.options import opts
from ..runtime.queue import work_queue
from ..runtime.logging import log_event
from ..runtime.scripts import callbacks, fire
from ..runtime.state import state
from ..sampling.samplers import SAMPLERS
from ..sampling.schedules import SCHEDULES


class ApiError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status


def _b64_to_image(data: str) -> np.ndarray:
    """A base64 image (a data: URL too) → uint8 RGB [H,W,3]; not an 8-bit
    PNG: 415 naming the format; past the reader's size limits: 413; a PNG
    that does not read: 422."""
    if "," in data and data.strip().startswith("data:"):
        data = data.split(",", 1)[1]
    try:
        pixels, _ = images_mod.decode_png(base64.b64decode(data))
    except images_mod.UnsupportedImage as e:
        raise ApiError(415, str(e)) from e
    except images_mod.ImageTooLarge as e:
        raise ApiError(413, str(e)) from e
    except ValueError as e:  # binascii.Error too
        raise ApiError(422, f"image does not read: {e}") from e
    return images_mod.to_rgb(pixels)


def _image_to_b64(arr: np.ndarray, infotext: Optional[str] = None) -> str:
    text = {"parameters": infotext} if infotext else None
    return base64.b64encode(images_mod.encode_png(np.asarray(arr, np.uint8), text)).decode()


_API_ALIASES = {
    # webui API name → Processing field (None: dropped)
    "sampler_index": "sampler_name",
    "firstphase_width": None,
    "firstphase_height": None,
    "controlnet_units": None,  # the reference's request has no such field: dropped
}
# the reference's request fields (forge_tpu Processing) that the port's lacks, at the value
# that is the port's behaviour: dropped at it, passed on (and refused) at any other
_INERT_FIELDS = {
    "tiling": False, "image_cfg_scale": None, "user": None,
    "init_img_hash": None,
    "scripts": None, "pre_cfg_hooks": None, "post_cfg_hooks": None, "cfg_combine_hook": None,
    "deferred_hooks": None, "cond_transform": None, "soft_inpainting": None,
    "reference_state": None, "hook_phases": None,
}
_INPAINTING_FILL = ["fill", "original", "latent_noise", "latent_nothing"]
# the always-on script names the dispatch takes (lower case) → the extension
ALWAYSON_SCRIPTS = {
    "controlnet": "controlnet", "control net": "controlnet",
    "ipadapter": "ip-adapter", "ip-adapter": "ip-adapter", "ip adapter": "ip-adapter",
    "freeu": "freeu", "freeu integrated": "freeu",
    "lora": "lora", "extra networks": "lora",
    "latent modifier": "latent modifier", "latentmodifier": "latent modifier",
    "latent mega modifier": "latent modifier",
    "fooocus inpaint": "fooocus inpaint", "fooocus_inpaint": "fooocus inpaint",
    "controlllite": "controllllite", "controllllite": "controllllite",
    "control lllite": "controllllite",
    "stylealign": "stylealign", "style align": "stylealign", "stylealign integrated": "stylealign",
    "dynamic thresholding": "dynamic thresholding",
    "dynamic thresholding (cfg scale fix)": "dynamic thresholding",
    "dynamicthresholding": "dynamic thresholding",
    "kohya hrfix": "kohya hrfix", "kohya hrfix integrated": "kohya hrfix",
    "kohya_hrfix": "kohya hrfix",
    "sag": "sag", "self attention guidance": "sag", "selfattentionguidance integrated": "sag",
    "pag": "pag", "perturbed attention": "pag", "perturbed attention guidance": "pag",
    "perturbedattentionguidance integrated": "pag",
    "soft inpainting": "soft inpainting", "soft_inpainting": "soft inpainting",
}
# Python objects an extension's attach or the caller sets: never from a JSON payload
_OBJECT_FIELDS = ("hook_phases", "deferred_hooks", "scripts", "soft_inpainting")


def _processing_from_payload(payload: Dict[str, Any]) -> Processing:
    """A txt2img or img2img payload → Processing. An `infotext` field seeds the
    request, the payload's own fields override it; images and grids are
    saved only with `save_images` true (`do_not_save_samples` and
    `do_not_save_grid` default to its negation, as the reference's API sets
    them); an always-on script the dispatch does not take answers 422
    (`_alwayson_kind`); the always-on scripts attach on the work queue
    (`_apply_alwayson_scripts`)."""
    from ..pipeline.processing import _FIELDS, CFG_HOOK_FIELDS, IMAGE_PROMPT_FIELDS

    for name in payload.get("alwayson_scripts") or {}:
        _alwayson_kind(name)
    no_save = not payload.get("save_images", False)
    kwargs: Dict[str, Any] = {"do_not_save_samples": no_save, "do_not_save_grid": no_save}
    if payload.get("infotext"):
        kwargs.update(infotext_to_processing_args(payload["infotext"]))
    for key, value in payload.items():
        field = _API_ALIASES.get(key, key)
        if field in _INERT_FIELDS and value == _INERT_FIELDS[field]:
            continue
        if field in CFG_HOOK_FIELDS + IMAGE_PROMPT_FIELDS + _OBJECT_FIELDS:
            # Python objects: an extension's attach sets them
            raise ApiError(422, f"{key}: hooks cannot come in a JSON payload; the "
                                "extensions that set them are reached through "
                                "alwayson_scripts")
        if field and (field in _FIELDS or field in _INERT_FIELDS):
            kwargs[field] = value
    if isinstance(kwargs.get("inpainting_fill"), int):
        kwargs["inpainting_fill"] = _INPAINTING_FILL[kwargs["inpainting_fill"]]
    try:
        return Processing(**kwargs)
    except NotImplementedError as e:
        raise ApiError(422, str(e)) from e


def _alwayson_kind(name: str) -> str:
    """An always-on script's name → the extension it turns on; an unknown
    name answers 422."""
    low = name.lower()
    if low not in ALWAYSON_SCRIPTS:
        raise ApiError(422, f"unknown alwayson_scripts {name!r} — supported: "
                            + ", ".join(sorted(set(ALWAYSON_SCRIPTS.values()))))
    return ALWAYSON_SCRIPTS[low]


def _first_dict(args) -> Dict[str, Any]:
    if args and isinstance(args[0], dict):
        return args[0]
    return {}


def _apply_alwayson_scripts(p: Processing, scripts: Dict[str, Any], device=None,
                            dtype: Optional[torch.dtype] = None) -> None:
    """The reference's dispatch: each always-on script's `args` attach its
    extension to `p`, its weights on `device` in `dtype`."""
    for name, spec in (scripts or {}).items():
        args = (spec or {}).get("args", [])
        kind, a = _alwayson_kind(name), _first_dict(args)
        if kind == "controlnet":
            from ..extensions.controlnet import attach_units

            attach_units(p, [u for u in args if isinstance(u, dict)], device, dtype)
        elif kind == "ip-adapter":
            from ..pipeline.ipadapter import attach

            attach(p, a, device, dtype)
        elif kind == "freeu":
            from ..extensions.freeu import build_freeu_hooks

            vals = args if args and isinstance(args[0], (int, float)) else [
                v for v in args if isinstance(v, (int, float))]
            hooks = (build_freeu_hooks(320, *[float(v) for v in vals[:4]]) if vals
                     else build_freeu_hooks())
            p.unet_hooks = {**(p.unet_hooks or {}), **hooks}
        elif kind == "latent modifier":
            from ..extensions.latent_modifier import attach

            attach(p, a)
        elif kind == "fooocus inpaint":
            from ..extensions.fooocus_inpaint import attach

            attach(p, a)
        elif kind == "controllllite":
            from ..extensions.controllllite import attach

            attach(p, a, device=device)
        elif kind == "soft inpainting":
            from ..extensions.soft_inpainting import attach

            attach(p, a)
        elif kind == "stylealign":
            from ..extensions.stylealign import attach

            attach(p, a)
        elif kind == "dynamic thresholding":
            from ..extensions.dynamic_thresholding import attach

            attach(p, a)
        elif kind == "kohya hrfix":
            from ..extensions.kohya_hrfix import attach

            attach(p, a)
        elif kind == "sag":
            scale = float(a.get("scale", a.get("sag_scale", 0.75)))
            blur = float(a.get("blur_sigma", 2.0))

            def attach_sag(engine, pp, cond, uncond, _s=scale, _b=blur):
                from ..extensions.sag import build_sag

                hooks, post_cfg = build_sag(engine, cond, sag_scale=_s, blur_sigma=_b)
                pp.unet_hooks = {**(pp.unet_hooks or {}), **hooks}
                pp.post_cfg_hooks = list(pp.post_cfg_hooks or []) + [post_cfg]

            p.deferred_hooks = list(p.deferred_hooks or []) + [attach_sag]
        elif kind == "pag":
            scale = float(a.get("scale", a.get("pag_scale", 3.0)))

            def attach_pag(engine, pp, cond, uncond, _s=scale):
                from ..extensions.pag import build_pag_post_cfg

                pp.post_cfg_hooks = list(pp.post_cfg_hooks or []) + [
                    build_pag_post_cfg(engine, cond, pag_scale=_s)]

            p.deferred_hooks = list(p.deferred_hooks or []) + [attach_pag]


# the parsed command line (webui.py), as the reference returns vars(cmd_opts)
CMD_FLAGS: Dict[str, Any] = {}

LATENT_UPSCALE_MODES = ("Latent", "Latent (antialiased)", "Latent (bicubic)",
                        "Latent (bicubic antialiased)", "Latent (nearest)",
                        "Latent (nearest-exact)")


def _meminfo() -> Dict[str, int]:
    """The host's RAM from /proc/meminfo: free = MemAvailable, used = total − free."""
    fields = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, _, rest = line.partition(":")
            fields[name] = int(rest.split()[0]) * 1024
    total, free = fields["MemTotal"], fields.get("MemAvailable", fields["MemFree"])
    return {"free": free, "used": total - free, "total": total}


class Api:
    def __init__(self, models: ModelManager):
        self.models = models
        self.routes = {
            ("POST", "/sdapi/v1/txt2img"): self.txt2img,
            ("POST", "/sdapi/v1/img2img"): self.img2img,
            ("GET", "/sdapi/v1/progress"): self.progress,
            ("POST", "/sdapi/v1/interrupt"): self.interrupt,
            ("POST", "/sdapi/v1/skip"): self.skip,
            ("GET", "/sdapi/v1/options"): self.get_options,
            ("POST", "/sdapi/v1/options"): self.set_options,
            ("GET", "/sdapi/v1/samplers"): self.get_samplers,
            ("GET", "/sdapi/v1/schedulers"): self.get_schedulers,
            ("GET", "/sdapi/v1/sd-models"): self.get_sd_models,
            ("GET", "/sdapi/v1/sd-modules"): self.get_sd_modules,
            ("GET", "/sdapi/v1/cmd-flags"): lambda q, b: dict(CMD_FLAGS),
            ("GET", "/sdapi/v1/upscalers"): self.get_upscalers,
            ("GET", "/sdapi/v1/latent-upscale-modes"): lambda q, b: [
                {"name": n} for n in LATENT_UPSCALE_MODES],
            ("GET", "/sdapi/v1/prompt-styles"): self.get_prompt_styles,
            ("POST", "/sdapi/v1/prompt-styles"): self.save_prompt_style,
            ("POST", "/sdapi/v1/refresh-prompt-styles"): self.refresh_prompt_styles,
            ("GET", "/sdapi/v1/embeddings"): self.get_embeddings,
            ("GET", "/sdapi/v1/loras"): self.get_loras,
            ("POST", "/sdapi/v1/refresh-loras"): self.refresh_loras,
            ("POST", "/sdapi/v1/png-info"): self.png_info,
            ("POST", "/sdapi/v1/token-count"): self.token_count,
            ("POST", "/sdapi/v1/parse-infotext"): self.parse_infotext,
            ("GET", "/sdapi/v1/memory"): self.memory,
            ("POST", "/sdapi/v1/refresh-checkpoints"): self.refresh_checkpoints,
            ("POST", "/sdapi/v1/unload-checkpoint"): self.unload_checkpoint,
            ("POST", "/sdapi/v1/reload-checkpoint"): self.reload_checkpoint,
            ("POST", "/sdapi/v1/server-stop"): self.server_stop,
            ("POST", "/sdapi/v1/server-kill"): self.server_stop,
            ("GET", "/internal/ping"): lambda q, b: {},
            ("GET", "/internal/sysinfo"): self.sysinfo,
            ("GET", "/sdapi/v1/scripts"): self.list_scripts,
            ("GET", "/sdapi/v1/script-info"): self.script_info,
            ("POST", "/sdapi/v1/xyz-grid"): self.xyz_grid,
            ("POST", "/sdapi/v1/extra-single-image"): self.extra_single,
            ("POST", "/sdapi/v1/extra-batch-images"): self.extra_batch,
            ("POST", "/sdapi/v1/interrogate"): self.interrogate,
            ("GET", "/controlnet/model_list"): self.controlnet_models,
            ("GET", "/controlnet/module_list"): self.controlnet_modules,
            ("GET", "/controlnet/version"): lambda q, b: {"version": 2},
            ("POST", "/sdapi/v1/create/embedding"): self.create_embedding,
            ("GET", "/sdapi/v1/extensions"): self.list_extensions,
            ("POST", "/sdapi/v1/extensions/install"): self.extensions_install,
            ("POST", "/sdapi/v1/extensions/update"): self.extensions_update,
            ("POST", "/sdapi/v1/merge-checkpoints"): self.merge_checkpoints,
            ("GET", "/sdapi/v1/extra-networks/metadata"): self.network_metadata_get,
            ("POST", "/sdapi/v1/extra-networks/metadata"): self.network_metadata_set,
            ("GET", "/sdapi/v1/extra-networks/cards"): self.network_cards,
            ("GET", "/sdapi/v1/extra-networks/preview"): self.network_preview,
            ("GET", "/config_states"): self.config_states,
            ("POST", "/config_states/save"): self.config_states_save,
            ("POST", "/sdapi/v1/server-restart"): self.server_restart,
            ("GET", "/"): self.index,
            ("GET", "/sdapi/v1/localization"): self.get_localization,
            ("GET", "/sdapi/v1/ui-tabs"): lambda q, b: self.custom_tabs,
            ("GET", "/sdapi/v1/spaces"): self.spaces_list,
            ("POST", "/sdapi/v1/spaces/launch"): self.spaces_launch,
            ("POST", "/sdapi/v1/spaces/terminate"): self.spaces_terminate,
        }
        self._server: Optional[ThreadingHTTPServer] = None
        self._space_manager = None
        self._space_lock = threading.Lock()
        self._standalone_loras = None
        self.custom_tabs = []  # what the ui_tabs callbacks gave create_server

    # -- Forge Spaces (runtime/spaces.py) -----------------------------------

    @property
    def space_manager(self):
        """One manager for every handler thread, made on the first Spaces request."""
        with self._space_lock:
            if self._space_manager is None:
                from ..runtime.spaces import SpaceManager

                self._space_manager = SpaceManager(["extensions-builtin", "extensions"])
        return self._space_manager

    def spaces_list(self, query, body):
        return {"spaces": self.space_manager.list()}

    def spaces_launch(self, query, body):
        try:
            return {"url": self.space_manager.launch((body or {}).get("name"))}
        except NotImplementedError as e:  # a bundled Space the port does not run yet
            raise ApiError(501, str(e)) from e

    def spaces_terminate(self, query, body):
        self.space_manager.terminate((body or {}).get("name"))
        return {}

    # -- generation ---------------------------------------------------------

    def _engine(self):
        eng = self.models.engine
        if eng is None:
            ckpt = opts.get("sd_model_checkpoint")
            if ckpt:
                return self.models.load(ckpt)
            raise RuntimeError("no checkpoint loaded")
        return eng

    def _generate(self, kind: str, p: Processing, body):
        """process_images, or the selectable script the payload's script_name
        names with its script_args (reference api.py init_script_args →
        Script.run), on the work queue, between state.begin and state.end,
        under the request's override_settings."""
        overrides = body.get("override_settings") or {}
        script = None
        if body.get("script_name"):
            from ..pipeline.selectable_scripts import get_script

            try:
                script = get_script(body["script_name"])
            except KeyError as e:
                raise ApiError(422, str(e)) from e
        script_args = body.get("script_args") or []

        def run():
            with opts.override(overrides):
                state.begin(kind, job_count=p.n_iter, steps=p.steps)
                try:
                    engine = self._engine()
                    _apply_alwayson_scripts(p, body.get("alwayson_scripts"), engine.device,
                                            engine.compute_dtype)
                    if script is not None:
                        return script.run(engine, p, *script_args)
                    return process_images(engine, p)
                finally:
                    state.end()

        return work_queue.run_and_wait(run)

    def txt2img(self, query, body):
        p = _processing_from_payload(body)
        result = self._generate("txt2img", p, body)
        infos = result.infotexts
        return {
            "images": [_image_to_b64(img, infos[i] if i < len(infos) else None)
                       for i, img in enumerate(result.images)],
            "parameters": body,
            "info": json.dumps({
                "seed": result.seeds[0] if result.seeds else -1,
                "all_seeds": result.seeds,
                "all_subseeds": result.subseeds,
                "infotexts": result.infotexts,
            }),
        }

    def img2img(self, query, body):
        init_images = [_b64_to_image(x) for x in body.get("init_images", [])]
        mask = body.get("mask")
        body = dict(body)
        body.pop("init_images", None)
        body.pop("mask", None)
        p = _processing_from_payload(body)
        p.init_images = init_images
        # the init image's size only where the request gives none
        if init_images and not (body.get("width") or body.get("height")):
            p.height, p.width = init_images[0].shape[:2]
        if mask:
            p.inpaint_mask = _b64_to_image(mask).mean(axis=-1)
        result = self._generate("img2img", p, body)
        return {
            "images": [_image_to_b64(img, result.infotexts[i] if i < len(result.infotexts)
                                     else None)
                       for i, img in enumerate(result.images)],
            "parameters": body,
            "info": json.dumps({"all_seeds": result.seeds, "infotexts": result.infotexts}),
        }

    # -- scripts ------------------------------------------------------------

    # the always-on script names /sdapi/v1/scripts and /script-info list, the reference's
    ALWAYSON = ("controlnet", "freeu", "sag", "pag", "stylealign", "dynamic thresholding",
                "kohya hrfix", "latent modifier", "soft inpainting", "fooocus inpaint",
                "controlllite")

    def list_scripts(self, query, body):
        from ..pipeline.selectable_scripts import SELECTABLE
        from ..runtime.scripts import scripts_img2img, scripts_txt2img

        names = list(self.ALWAYSON)
        sel_t2i = sorted(s.name for s in SELECTABLE.values() if not s.is_img2img)
        sel_i2i = sorted(s.name for s in SELECTABLE.values())
        return {"txt2img": names + sel_t2i + [s.name for s in scripts_txt2img.scripts],
                "img2img": names + sel_i2i + [s.name for s in scripts_img2img.scripts]}

    def script_info(self, query, body):
        from ..pipeline.selectable_scripts import SELECTABLE

        out = [{"name": name, "is_alwayson": True, "is_img2img": is_img2img, "args": []}
               for name in self.ALWAYSON for is_img2img in (False, True)]
        seen = set()
        for s in SELECTABLE.values():
            if s.name not in seen:
                seen.add(s.name)
                out.append({"name": s.name, "is_alwayson": False, "is_img2img": s.is_img2img,
                            "args": s.ui_spec})
        return out

    def xyz_grid(self, query, body):
        """X/Y/Z plot: txt2img fields and axes {field or "prompt_sr", values,
        search?} under x_axis (required), y_axis and z_axis → a grid PNG a Z
        value."""
        from ..extensions.xyz_grid import Axis, run_xyz_grid

        body = dict(body or {})
        specs = [body.pop(k, None) for k in ("x_axis", "y_axis", "z_axis")]

        def axis(spec):
            if not spec or not spec.get("values"):
                return None
            return Axis(field=spec.get("field", "seed"), values=spec["values"],
                        search=spec.get("search"))

        x = axis(specs[0])
        if x is None:
            raise ApiError(422, "x_axis with values is required")
        p = _processing_from_payload(body)

        def run():
            engine = self._engine()
            _apply_alwayson_scripts(p, body.get("alwayson_scripts"), engine.device,
                                    engine.compute_dtype)
            return run_xyz_grid(engine, p, x, axis(specs[1]), axis(specs[2]))

        try:
            grids = work_queue.run_and_wait(run)
        except ValueError as e:  # an axis value Axis.apply refuses
            raise ApiError(422, str(e)) from e
        return {"images": [_image_to_b64(g) for g in grids]}

    # -- status -------------------------------------------------------------

    def progress(self, query, body):
        skip_image = (query.get("skip_current_image", ["false"])[0]).lower() == "true"
        return {
            "progress": state.progress(),
            "eta_relative": state.eta() or 0.0,
            "state": state.snapshot(),
            "current_image": None if skip_image else state.current_image_base64(),
            "textinfo": state.textinfo,
        }

    def interrupt(self, query, body):
        state.interrupt()
        return {}

    def skip(self, query, body):
        state.skip()
        return {}

    # -- config -------------------------------------------------------------

    def get_options(self, query, body):
        return {k: v["value"] for k, v in opts.dump_registry().items()}

    def set_options(self, query, body):
        if CMD_FLAGS.get("freeze_settings"):
            raise ApiError(403, "settings are frozen (--freeze-settings)")
        for k, v in (body or {}).items():
            opts.set(k, v)
        ckpt = (body or {}).get("sd_model_checkpoint")
        if ckpt:
            work_queue.run_and_wait(self.models.load, ckpt)
        return {}

    def get_samplers(self, query, body):
        return [{"name": name, "aliases": list(info.aliases), "options": {}}
                for name, info in SAMPLERS.items()]

    def get_schedulers(self, query, body):
        return [{"name": name, "label": name.replace("_", " ").title()} for name in SCHEDULES]

    def get_sd_models(self, query, body):
        return [{"title": c.title, "model_name": c.name, "filename": c.path,
                 "hash": None, "sha256": None}
                for c in self.models.checkpoints.values()]

    def get_sd_modules(self, query, body):
        return [{"name": os.path.basename(v), "filename": v} for v in self.models.list_vaes()]

    def _upscalers(self):
        from ..pipeline.upscalers import get_default_registry

        return get_default_registry(self.models.device)

    def get_upscalers(self, query, body):
        return [{"name": n, "model_name": None, "model_path": None, "model_url": None,
                 "scale": u.scale}
                for n, u in self._upscalers().upscalers.items()]

    # -- extras -----------------------------------------------------------------

    def _upscale_one(self, img_b64: str, body) -> str:
        """One extras image (reference postprocessing order): face restoration
        blended by max(codeformer_visibility, gfpgan_visibility), the upscale
        (resize_mode 0: `upscaling_resize`; 1: the scale that covers, or with
        `upscaling_crop` off fits, `upscaling_resize_w`×`_h`), `upscaler_2`
        on the undecorated input blended by `extras_upscaler_2_visibility`,
        then for mode 1 the crop (with `focal_crop_enabled` the window
        around the focal point, postprocessing/focal_crop.py, weighted by
        `focal_crop_face_weight`, `_entropy_weight` and `_edges_weight`;
        otherwise the centre, zero past the edge as Pillow's crop) and a
        Lanczos resize to the exact size. Each network step runs on the
        work queue. A restorer without its checkpoint answers 422, where the
        reference skips it."""
        img = _b64_to_image(img_b64)
        cf_vis = float(body.get("codeformer_visibility", 0) or 0)
        gf_vis = float(body.get("gfpgan_visibility", 0) or 0)
        if cf_vis > 0 or gf_vis > 0:
            from ..postprocessing.faces import get_face_restorer

            restorer = get_face_restorer(self.models.device)
            if not restorer.available:  # the reference skips without a word
                raise ApiError(422, f"face restoration: no {restorer.name} checkpoint under "
                                    f"{restorer.model_dir}")
            w = float(body.get("codeformer_weight", 0.5))
            restored = work_queue.run_and_wait(restorer.restore, img, w)
            vis = max(cf_vis, gf_vis)
            img = (restored.astype(np.float32) * vis
                   + img.astype(np.float32) * (1 - vis) + 0.5).astype(np.uint8)
        registry = self._upscalers()
        name = body.get("upscaler_1", "Lanczos")
        if int(body.get("resize_mode", 0) or 0) == 1:
            tw = int(body.get("upscaling_resize_w", 512) or 512)
            th = int(body.get("upscaling_resize_h", 512) or 512)
            h, w = img.shape[:2]
            crop = body.get("upscaling_crop", True)
            scale = max(tw / w, th / h) if crop else min(tw / w, th / h)
        else:
            tw = th = None
            scale = float(body.get("upscaling_resize", 2))
        if name and name != "None" and scale != 1:
            img = work_queue.run_and_wait(registry.get(name).upscale, img, scale)
            name2 = body.get("upscaler_2", "None")
            vis2 = float(body.get("extras_upscaler_2_visibility", 0) or 0)
            if name2 and name2 != "None" and vis2 > 0:
                img2 = work_queue.run_and_wait(registry.get(name2).upscale,
                                               _b64_to_image(img_b64), scale)
                if img2.shape == img.shape:
                    img = (img2.astype(np.float32) * vis2
                           + img.astype(np.float32) * (1 - vis2) + 0.5).astype(np.uint8)
        if tw is not None:
            h, w = img.shape[:2]
            if body.get("upscaling_crop", True) and (w, h) != (tw, th) \
                    and body.get("focal_crop_enabled"):
                from ..postprocessing.focal_crop import focal_crop

                img = focal_crop(img, tw, th,
                                 face_weight=float(body.get("focal_crop_face_weight", 0.9)),
                                 entropy_weight=float(body.get("focal_crop_entropy_weight", 0.15)),
                                 edges_weight=float(body.get("focal_crop_edges_weight", 0.5)))
            elif body.get("upscaling_crop", True) and (w, h) != (tw, th):
                left, top = max(0, (w - tw) // 2), max(0, (h - th) // 2)
                cropped = np.zeros((th, tw) + img.shape[2:], np.uint8)
                part = img[top:top + th, left:left + tw]
                cropped[:part.shape[0], :part.shape[1]] = part
                img = cropped
            if img.shape[:2] != (th, tw):
                img = images_mod.lanczos_resize(img, tw, th)
        return _image_to_b64(img)

    def extra_single(self, query, body):
        return {"image": self._upscale_one(body.get("image", ""), body), "html_info": ""}

    def extra_batch(self, query, body):
        images = body.get("imageList", []) or body.get("images", [])
        return {"images": [self._upscale_one(item.get("data", item) if isinstance(item, dict)
                                             else item, body) for item in images],
                "html_info": ""}

    def interrogate(self, query, body):
        """The interrogator (reference api.py interrogateapi): `model` "clip"
        (postprocessing/interrogate.py) or "deepbooru"
        (postprocessing/deepbooru.py), on the work queue; 404 without an
        image, and the reference's `detail` without a checkpoint."""
        img_b64 = (body or {}).get("image", "")
        if not img_b64:
            raise ApiError(404, "Image not found")
        img = _b64_to_image(img_b64)
        if (body or {}).get("model", "clip") == "deepbooru":
            from ..postprocessing.deepbooru import get_deepbooru

            db = get_deepbooru(self.models.device)
            if not db.available:
                return {"caption": "", "detail": "no deepbooru checkpoint "
                        "under models/torch_deepdanbooru"}
            caption = work_queue.run_and_wait(
                db.tag, img, threshold=float(opts.get("interrogate_deepbooru_score_threshold")),
                alpha_sort=bool(opts.get("deepbooru_sort_alpha")),
                use_spaces=bool(opts.get("deepbooru_use_spaces")),
                use_escape=bool(opts.get("deepbooru_escape")),
                filter_tags=str(opts.get("deepbooru_filter_tags")))
            return {"caption": caption}
        from ..postprocessing.interrogate import get_interrogator

        interrogator = get_interrogator(self.models.device)
        if not interrogator.available:
            return {"caption": "", "detail": "no CLIP checkpoint under "
                    "models/interrogate — install one to enable interrogation"}
        return {"caption": work_queue.run_and_wait(interrogator.interrogate, img)}

    # -- ControlNet ---------------------------------------------------------------

    def controlnet_models(self, query, body):
        from ..extensions.controlnet import list_controlnet_models

        return {"model_list": list_controlnet_models()}

    def controlnet_modules(self, query, body):
        from ..preprocessors import preprocessor_names

        return {"module_list": preprocessor_names()}

    # -- management -------------------------------------------------------------

    def create_embedding(self, query, body):
        """A textual-inversion embedding from the engine's token table
        (text/textual_inversion.py `create_embedding`), on the work queue →
        {info: the path}. `out_dir` must lie inside the embeddings folder
        (422 otherwise: the reference writes wherever the request says)."""
        from ..text.textual_inversion import create_embedding

        body = body or {}
        root = os.path.realpath(CMD_FLAGS.get("embeddings_dir") or "embeddings")
        out_dir = body.get("out_dir") or root
        if os.path.commonpath([root, os.path.realpath(out_dir)]) != root:
            raise ApiError(422, f"out_dir {out_dir!r} is outside the embeddings folder {root!r}")
        path = work_queue.run_and_wait(
            lambda: create_embedding(
                self._engine(), name=body.get("name", ""),
                num_vectors=int(body.get("num_vectors_per_token", body.get("num_vectors", 1))),
                init_text=body.get("init_text", "*"),
                overwrite=bool(body.get("overwrite_old", False)),
                out_dir=out_dir))
        return {"info": f"create embedding filename: {path}"}

    def list_extensions(self, query, body):
        from ..runtime.extensions import list_extensions

        return [{"name": e.name, "remote": e.remote, "branch": e.branch,
                 "commit_hash": e.commit_hash, "version": e.version, "commit_date": "",
                 "enabled": e.enabled}
                for e in list_extensions()]

    def _check_extension_access(self):
        """Install and update run fetched code: 403 without
        --enable-insecure-extension-access."""
        if not CMD_FLAGS.get("enable_insecure_extension_access"):
            raise ApiError(403, "extension install/update requires "
                                "--enable-insecure-extension-access")

    def extensions_install(self, query, body):
        from ..runtime.extensions import install_extension

        self._check_extension_access()
        body = body or {}
        ext = install_extension(body.get("url", ""), dirname=body.get("dirname", ""),
                                branch=body.get("branch", ""))
        return {"name": ext.name, "path": ext.path, "commit_hash": ext.commit_hash}

    def extensions_update(self, query, body):
        from ..runtime.extensions import (check_extension_updates, list_extensions,
                                          update_extension)

        self._check_extension_access()
        body = body or {}
        name = body.get("name", "")
        for ext in list_extensions():
            if ext.name == name or ext.canonical_name == name.lower():
                if body.get("check_only"):
                    return {"name": ext.name, "status": check_extension_updates(ext)}
                return {"name": ext.name, "commit_hash": update_extension(ext)}
        raise ApiError(404, f"no extension named {name!r}")

    def merge_checkpoints(self, query, body):
        """pipeline/merger.py `run_modelmerger` over the listed checkpoints
        (by key, name or title), on the work queue, written beside the
        primary as `<custom_name or "merged">.safetensors`, the name reduced to
        a file name as config_states/save reduces its own (the reference
        joins it as sent, '../' and all); then the checkpoint list is
        refreshed."""
        from ..pipeline.merger import run_modelmerger

        body = body or {}

        def resolve(name):
            c = self.models.checkpoints.get(name)
            if c is None:
                c = next((v for v in self.models.checkpoints.values()
                          if name in (v.name, v.title)), None)
            if c is None:
                raise ApiError(422, f"unknown checkpoint {name!r}")
            return c.path

        primary = resolve(body["primary"])
        name = re.sub(r"[^\w.-]", "_", os.path.basename(body.get("custom_name") or "merged"))
        out = os.path.join(os.path.dirname(primary) or ".", f"{name or 'merged'}.safetensors")
        path = work_queue.run_and_wait(
            run_modelmerger, primary,
            resolve(body["secondary"]) if body.get("secondary") else None,
            tertiary=resolve(body["tertiary"]) if body.get("tertiary") else None,
            mode=body.get("interp_method", body.get("mode", "weighted_sum")),
            multiplier=float(body.get("multiplier", 0.3)),
            bake_in_vae=body.get("bake_in_vae") or None, output_path=out,
            discard_weights=body.get("discard_weights") or None)
        self.models.refresh()
        return {"path": path}

    def _network_paths(self, kind: str) -> Dict[str, str]:
        """name → file of one extra-network kind: LoRAs, textual-inversion
        embeddings (embeddings/, models/embeddings/), hypernetworks or
        checkpoints."""
        import glob

        def scan(dirs, exts):
            out = {}
            for d in dirs:
                for ext in exts:
                    for path in sorted(glob.glob(os.path.join(d, f"**/*{ext}"), recursive=True)):
                        out[os.path.splitext(os.path.basename(path))[0]] = path
            return out

        kind = (kind or "lora").lower()
        if kind in ("lora", "lycoris"):
            return dict(self._lora_registry().available)
        if kind in ("ti", "embedding", "embeddings", "textual inversion"):
            return scan(("embeddings", "models/embeddings"), (".safetensors", ".pt", ".bin"))
        if kind in ("hypernet", "hypernetwork", "hypernetworks"):
            return scan(("models/hypernetworks",), (".safetensors", ".pt", ".ckpt"))
        if kind in ("checkpoint", "checkpoints", "model"):
            return {name: info.path for name, info in sorted(self.models.checkpoints.items())}
        raise ApiError(422, f"unknown extra-network kind {kind!r}")

    @staticmethod
    def _preview_path(path: str) -> Optional[str]:
        stem = os.path.splitext(path)[0]
        for suffix in (".preview.png", ".preview.jpg", ".png", ".jpg", ".webp"):
            if stem + suffix != path and os.path.exists(stem + suffix):
                return stem + suffix
        return None

    def _network(self, kind: str, name: str) -> str:
        path = self._network_paths(kind).get(name)
        if path is None:
            raise ApiError(404, f"unknown network {name!r}")
        return path

    def network_cards(self, query, body):
        """The extra-networks browser's cards of one kind (`search` filters
        names and paths): name, path, directory, whether a preview exists and
        the user metadata of the `.json` beside the file."""
        kind = query.get("kind", ["lora"])[0]
        search = (query.get("search", [""])[0] or "").lower()
        cards, dirs = [], set()
        for name, path in sorted(self._network_paths(kind).items()):
            if search and search not in name.lower() and search not in path.lower():
                continue
            dirs.add(os.path.dirname(path))
            meta = {}
            side = os.path.splitext(path)[0] + ".json"
            if os.path.exists(side):
                try:
                    with open(side, encoding="utf8") as f:
                        meta = json.load(f)
                except Exception:  # noqa: BLE001 — a corrupt sidecar still lists the card
                    meta = {}
            cards.append({"name": name, "path": path, "dir": os.path.dirname(path),
                          "has_preview": self._preview_path(path) is not None,
                          "description": meta.get("description", ""),
                          "activation_text": meta.get("activation text", ""),
                          "preferred_weight": meta.get("preferred weight", 0) or 0})
        return {"kind": kind, "cards": cards, "dirs": sorted(dirs)}

    def network_preview(self, query, body):
        name = query.get("name", [""])[0]
        prev = self._preview_path(self._network(query.get("kind", ["lora"])[0], name))
        if prev is None:
            raise ApiError(404, f"no preview for {name!r}")
        with open(prev, "rb") as f:
            data = f.read()
        ctype = ("image/jpeg" if prev.endswith((".jpg", ".jpeg"))
                 else "image/webp" if prev.endswith(".webp") else "image/png")
        return RawResponse(data, ctype)

    def network_metadata_get(self, query, body):
        """A network's user metadata: the `.json` beside its file, or the
        empty record."""
        path = self._network(query.get("kind", ["lora"])[0], query.get("name", [""])[0])
        side = os.path.splitext(path)[0] + ".json"
        if os.path.exists(side):
            with open(side, encoding="utf8") as f:
                return json.load(f)
        return {"description": "", "activation text": "", "preferred weight": 0, "notes": ""}

    def network_metadata_set(self, query, body):
        body = dict(body or {})
        name, kind = body.pop("name", ""), body.pop("kind", "lora")
        path = self._network(kind, name)
        keep = {k: body[k] for k in ("description", "activation text", "preferred weight",
                                     "negative text", "notes") if k in body}
        with open(os.path.splitext(path)[0] + ".json", "w", encoding="utf8") as f:
            json.dump(keep, f, indent=2)
        return keep

    def config_states(self, query, body):
        from ..runtime.extensions import list_config_states

        return list_config_states()

    def config_states_save(self, query, body):
        from ..runtime.extensions import save_config_state

        return {"saved": save_config_state((body or {}).get("name", ""))}

    # -- the web UI -------------------------------------------------------------

    def index(self, query, body):
        """The single-page web UI (api/webui_static.py); 404 under --nowebui."""
        if CMD_FLAGS.get("nowebui"):
            raise ApiError(404, "webui disabled (--nowebui)")
        from .webui_static import INDEX_HTML

        return RawResponse(INDEX_HTML, "text/html; charset=utf-8")

    def get_localization(self, query, body):
        """The localization `name` (else the `localization` option) names:
        {name, available, data}, data the merged replacement dict."""
        from ..runtime.localization import list_localizations, load_localization

        name = (query.get("name") or [None])[0] or opts.get("localization")
        return {"name": name or "None", "available": sorted(list_localizations()),
                "data": {} if name in (None, "", "None") else load_localization(name)}

    def get_prompt_styles(self, query, body):
        from ..runtime.styles import prompt_styles

        return [{"name": s.name, "prompt": s.prompt, "negative_prompt": s.negative_prompt}
                for s in prompt_styles.styles.values()]

    def save_prompt_style(self, query, body):
        """Create or update a style (with delete=true remove it) and write the
        styles CSV."""
        from ..runtime.styles import PromptStyle, prompt_styles

        body = body or {}
        name = (body.get("name") or "").strip()
        if not name:
            raise ApiError(422, "style name required")
        if body.get("delete"):
            prompt_styles.styles.pop(name, None)
        else:
            existing = prompt_styles.styles.get(name)
            prompt_styles.styles[name] = PromptStyle(
                name, body.get("prompt") or "", body.get("negative_prompt") or "",
                existing.path if existing else None)
        prompt_styles.save()
        return {"name": name}

    def refresh_prompt_styles(self, query, body):
        from ..runtime.styles import prompt_styles

        prompt_styles.reload()
        return {}

    def get_embeddings(self, query, body):
        eng = self.models.engine
        loaded = {}
        if eng is not None:
            loaded = {name: {"step": None, "sd_checkpoint": None,
                             "shape": int(e.vectors.shape[1]), "vectors": int(e.vectors.shape[0])}
                      for name, e in eng.embedding_db.embeddings.items()}
        return {"loaded": loaded, "skipped": {}}

    def _lora_registry(self):
        eng = self.models.engine
        reg = getattr(eng, "lora_registry", None) if eng is not None else None
        reg = reg or self.models.lora_registry
        if reg is None:
            from ..pipeline.extra_networks import LoraRegistry

            if self._standalone_loras is None:
                self._standalone_loras = LoraRegistry()
            reg = self._standalone_loras
        return reg

    def get_loras(self, query, body):
        return [{"name": name, "alias": name, "path": path, "metadata": {}}
                for name, path in sorted(self._lora_registry().available.items())]

    def refresh_loras(self, query, body):
        self._lora_registry().refresh()
        return {}

    def png_info(self, query, body):
        """The text of a PNG: "parameters" parsed; an image that does not read: empty."""
        try:
            raw = base64.b64decode((body or {}).get("image", "").split(",", 1)[-1])
            _, text = images_mod.decode_png(raw)
        except (ValueError, images_mod.UnsupportedImage):
            return {"info": "", "items": {}}
        info = text.get("parameters", "")
        return {"info": info, "items": dict(text),
                "parameters": parse_generation_parameters(info)}

    def parse_infotext(self, query, body):
        return {"parameters": parse_generation_parameters(str((body or {}).get("text", "")))}

    def token_count(self, query, body):
        """CLIP tokens of the prompt's worst variant: extra-network tags
        stripped, styles applied, `[a:b:N]` expanded at `steps`, AND parts
        split; `max` is the 75-token chunk ceiling the encoder pads to."""
        import math

        from ..pipeline.extra_networks import parse_prompt
        from ..text.chunking import CHUNK_LEN, tokenize_line
        from ..text.schedule import get_schedule, split_composable

        body = body or {}
        text = str(body.get("text", ""))
        steps = max(1, int(body.get("steps", 20) or 20))
        styles = body.get("styles") or []
        is_positive = bool(body.get("is_positive", True))
        if styles:
            from ..runtime.styles import prompt_styles

            apply = (prompt_styles.apply_styles_to_prompt if is_positive
                     else prompt_styles.apply_negative_styles_to_prompt)
            text = apply(text, list(styles))
        eng = self.models.engine
        tok = db = None
        if eng is not None:
            for name in ("clip_l", "clip_g"):
                te = eng.text_engines.get(name)
                if te is not None:
                    tok, db = te.tokenizer, getattr(te, "embedding_db", None)
                    break
        if tok is None:
            from ..text.tokenizer import default_tokenizer

            tok = default_tokenizer()
        try:
            text, _ = parse_prompt(text)
            branches = split_composable(text) if is_positive else [(text, 1.0)]
            variants = [s for t, _w in branches for _end, s in get_schedule(t, steps)]
        except Exception:  # noqa: BLE001 — a prompt mid-typing must not answer 500
            variants = [text]
        lookup = None if db is None else (lambda toks, off: db.find(toks, off, "l"))
        count = 0
        for v in variants or [""]:
            try:
                _chunks, n = tokenize_line(v, tok, embedding_lookup=lookup)
            except Exception:  # noqa: BLE001
                continue
            count = max(count, n)
        return {"count": count, "max": max(CHUNK_LEN, math.ceil(count / CHUNK_LEN) * CHUNK_LEN)}

    def memory(self, query, body):
        """The host's RAM (/proc/meminfo) and, with a card, the CUDA device's
        memory (torch.cuda.mem_get_info) under "cuda"."""
        out = {"ram": _meminfo()}
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
            out["cuda"] = {"free": int(free), "used": int(total - free), "total": int(total)}
        return out

    def refresh_checkpoints(self, query, body):
        self.models.refresh()
        return {}

    def unload_checkpoint(self, query, body):
        self.models.unload()
        return {}

    def reload_checkpoint(self, query, body):
        ckpt = opts.get("sd_model_checkpoint")
        if ckpt:
            work_queue.run_and_wait(self.models.load, ckpt)
        return {}

    def server_stop(self, query, body):
        if not CMD_FLAGS.get("api_server_stop", True):
            raise ApiError(404, "server stop/restart disabled (pass --api-server-stop)")
        threading.Thread(target=self._shutdown, daemon=True).start()
        return {}

    def server_restart(self, query, body):
        """The server stops with `restart_requested` set, and the launcher's
        serve loop starts it again (webui.py). The gate is checked first: a
        refused restart latches nothing."""
        if not CMD_FLAGS.get("api_server_stop", True):
            raise ApiError(404, "server stop/restart disabled (pass --api-server-stop)")
        if self._server is not None:
            self._server.restart_requested = True
        return self.server_stop(query, body)

    def _shutdown(self):
        time.sleep(0.2)
        if self._server is not None:
            self._server.shutdown()

    def sysinfo(self, query, body):
        cuda = torch.cuda.is_available()
        return {
            "platform": platform.platform(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                        if cuda else []),
        }


class RawResponse:
    """A route's answer that is not JSON: the body (str or bytes) as it is."""

    def __init__(self, body, content_type: str):
        self.body = body
        self.content_type = content_type


class _Handler(BaseHTTPRequestHandler):
    api: Api = None  # set by create_server
    auth = None  # accepted Authorization headers, or None

    def log_message(self, fmt, *args):  # quiet
        pass

    def _cors_origin(self) -> Optional[str]:
        """The request's Origin where --cors-allow-origins lists it or
        --cors-allow-origins-regex matches it, else None."""
        origin = self.headers.get("Origin")
        if not origin:
            return None
        allowed = CMD_FLAGS.get("cors_allow_origins") or ""
        if origin in {o.strip() for o in allowed.split(",") if o.strip()}:
            return origin
        pattern = CMD_FLAGS.get("cors_allow_origins_regex")
        if pattern:
            try:
                if re.fullmatch(pattern, origin):
                    return origin
            except re.error:
                pass
        return None

    def _reply(self, code: int, payload: Any):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        origin = self._cors_origin()
        if origin:
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Vary", "Origin")
        self.end_headers()
        self.wfile.write(data)

    def do_OPTIONS(self):
        origin = self._cors_origin()
        self.send_response(204 if origin else 403)
        if origin:
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type, Authorization")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _dispatch(self, method: str):
        if self.auth:
            supplied = self.headers.get("Authorization") or ""
            if not any(hmac.compare_digest(supplied, want) for want in self.auth):
                self.send_response(401)
                self.send_header("WWW-Authenticate", 'Basic realm="forge"')
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
        parsed = urlparse(self.path)
        handler = self.api.routes.get((method, parsed.path))
        if handler is None:
            self._reply(404, {"detail": "Not Found"})
            return
        body = {}
        if method == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    self._reply(422, {"detail": "invalid JSON"})
                    return
        t0 = time.time()
        try:
            result = handler(parse_qs(parsed.query), body)
            if parsed.path.startswith("/sdapi"):
                log_event("api_request", method=method, path=parsed.path, status=200,
                          duration_s=round(time.time() - t0, 4))
            if isinstance(result, RawResponse):
                data = result.body if isinstance(result.body, bytes) else result.body.encode()
                self.send_response(200)
                self.send_header("Content-Type", result.content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._reply(200, result)
        except ApiError as e:
            self._reply(e.status, {"detail": str(e)})
        except NotImplementedError as e:  # a request feature the port refuses
            self._reply(422, {"detail": str(e)})
        except KeyError as e:  # an unported option, an unknown sampler or upscaler
            self._reply(422, {"detail": str(e.args[0]) if e.args else str(e)})
        except RestorerMissing as e:  # restore_faces with no checkpoint
            self._reply(422, {"detail": str(e)})
        except FileNotFoundError as e:
            self._reply(404, {"detail": str(e)})
        except Exception as e:  # noqa: BLE001
            log_event("api_error", method=method, path=parsed.path, error=str(e),
                      duration_s=round(time.time() - t0, 4))
            self._reply(500, {"detail": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def create_server(models: ModelManager, host: str = "127.0.0.1", port: int = 7860,
                  api_auth: Optional[str] = None) -> ThreadingHTTPServer:
    """The API's server, not yet serving (run `serve_forever` on a thread);
    port 0 takes a free port, read back from `server.server_address`.
    `api_auth` "user:pass[,user2:pass2]" turns on HTTP basic auth. The
    `ui_tabs` callbacks' tabs ({"id", "title", "html"} dicts) are collected
    once, for GET /sdapi/v1/ui-tabs; a callback that raises is printed and
    skipped."""
    api = Api(models)
    creds = None
    if api_auth:
        creds = {"Basic " + base64.b64encode(pair.strip().encode()).decode()
                 for pair in api_auth.split(",") if pair.strip()}
    handler = type("BoundHandler", (_Handler,), {"api": api, "auth": creds})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    server.api = api
    server.restart_requested = False
    api._server = server
    for cb in callbacks("ui_tabs"):
        try:
            api.custom_tabs.extend(cb() or [])
        except Exception as e:  # noqa: BLE001 — an extension's error must not stop the start
            print(f"ui_tabs callback failed: {e}")
    fire("app_started", server)
    return server


def serve(models: ModelManager, host: str = "127.0.0.1", port: int = 7860,
          api_auth: Optional[str] = None) -> bool:
    """Serve until /sdapi/v1/server-stop or /server-restart (or an interrupt
    of the process) → whether a restart was asked for. The work queue keeps
    running across a restart."""
    server = create_server(models, host, port, api_auth=api_auth)
    print(f"forge_tpu_torch API listening on http://{host}:{server.server_address[1]}", flush=True)
    restart = False
    try:
        server.serve_forever()
        fire("script_unloaded")
        restart = server.restart_requested
    finally:
        server.server_close()
        if not restart:
            work_queue.stop()
    return restart

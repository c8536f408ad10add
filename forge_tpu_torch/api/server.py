# Copied from forge_tpu/api/server.py (the route table, _processing_from_payload, _apply_alwayson_scripts, _first_dict, _generate, the routes this slice answers, _Handler with basic auth and CORS, create_server); PNG through the port's own codec.
"""REST API: the reference's `/sdapi/v1/*` contract on the standard
library's `ThreadingHTTPServer` (routes, JSON bodies, base64 PNG images), so
webui API clients work unchanged.

Every generation, and every checkpoint load, runs on the single work queue
(runtime/queue.py) between `state.begin` and `state.end`, under the request's
`override_settings`. Images come and go as PNG through the port's codec
(pipeline/images.py); the infotext rides in the PNG's "parameters" text.

A request field is passed to the port's `Processing`; one it refuses answers
422 with the refusal's text. The reference's fields the port lacks are
dropped only at the value that is the port's behaviour (nothing saved, no
scripts, hooks or face restoration); keys that are no request field at all
are dropped, as the reference drops them. `alwayson_scripts` turns the
extensions on, as the reference's dispatch does: ControlNet units, the
IP-Adapter (FaceID and InstantID too), FreeU, the latent modifier, Fooocus
inpaint, ControlLLLite, StyleAlign, dynamic thresholding, Kohya HRFix, SAG
and PAG; "lora" is accepted and does nothing (LoRAs ride the prompt). Their
weights load on the engine's device, on the work queue. Soft inpainting and
an unknown name answer 422, as does what an extension refuses. An image
that is not an 8-bit PNG answers 415 with its format's name. Routes of the reference's table that
this port does not answer yet answer 501 with the ROADMAP item that ports
them; none answers as if it had worked.
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
from ..runtime.models import ModelManager
from ..runtime.options import opts
from ..runtime.queue import work_queue
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
}
# the reference's request fields (forge_tpu Processing) that the port's lacks, at the value
# that is the port's behaviour: dropped at it, passed on (and refused) at any other
_INERT_FIELDS = {
    "tiling": False, "restore_faces": False, "do_not_save_samples": True,
    "do_not_save_grid": True, "image_cfg_scale": None, "user": None, "init_img_hash": None,
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
}
_SOFT_INPAINTING = ("soft inpainting", "soft_inpainting")


def _processing_from_payload(payload: Dict[str, Any]) -> Processing:
    """A txt2img or img2img payload → Processing. An `infotext` field seeds the
    request, the payload's own fields override it; `save_images` or a script
    answers 422 (no sample is saved and scripts are not ported), as does an
    always-on script the dispatch does not take (`_alwayson_kind`); the
    always-on scripts attach on the work queue (`_apply_alwayson_scripts`)."""
    from ..pipeline.processing import _FIELDS, CFG_HOOK_FIELDS, IMAGE_PROMPT_FIELDS

    for key, what in (("save_images", "saving images"), ("script_name", "scripts")):
        if payload.get(key):
            raise ApiError(422, f"{key}: {what} are not ported to forge_tpu_torch yet "
                                "(ROADMAP.md queue 1 item 7)")
    for name in payload.get("alwayson_scripts") or {}:
        _alwayson_kind(name)
    kwargs: Dict[str, Any] = {}
    if payload.get("infotext"):
        kwargs.update(infotext_to_processing_args(payload["infotext"]))
    for key, value in payload.items():
        field = _API_ALIASES.get(key, key)
        if field in _INERT_FIELDS and value == _INERT_FIELDS[field]:
            continue
        if field in CFG_HOOK_FIELDS + IMAGE_PROMPT_FIELDS + ("hook_phases", "deferred_hooks"):
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
    """An always-on script's name → the extension it turns on; soft
    inpainting and an unknown name answer 422."""
    low = name.lower()
    if low in _SOFT_INPAINTING:
        raise ApiError(422, f"alwayson_scripts {name!r}: soft inpainting is not ported to "
                            "forge_tpu_torch yet (ROADMAP.md queue 1 item 6 (e))")
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

# the reference's routes this port does not answer yet → the ROADMAP item that ports them
_ROADMAP_STATIC_UI = "queue 1 item 7: the static web UI"
_ROADMAP_SCRIPTS = "queue 1 item 7: scripts"
_ROADMAP_EXTRAS = "queue 1 item 9: extras, upscaling and interrogate"
_ROADMAP_CONTROLNET = "queue 1 item 6: the ControlNet routes"
_ROADMAP_SPACES = "queue 1 item 9: spaces"
_ROADMAP_MANAGE = "queue 1 item 7: extensions, merging, embeddings and the extra-networks pages"
UNPORTED_ROUTES = {
    ("GET", "/"): _ROADMAP_STATIC_UI,
    ("GET", "/sdapi/v1/localization"): _ROADMAP_STATIC_UI,
    ("GET", "/sdapi/v1/ui-tabs"): _ROADMAP_STATIC_UI,
    ("GET", "/sdapi/v1/scripts"): _ROADMAP_SCRIPTS,
    ("GET", "/sdapi/v1/script-info"): _ROADMAP_SCRIPTS,
    ("POST", "/sdapi/v1/xyz-grid"): _ROADMAP_SCRIPTS,
    ("POST", "/sdapi/v1/extra-single-image"): _ROADMAP_EXTRAS,
    ("POST", "/sdapi/v1/extra-batch-images"): _ROADMAP_EXTRAS,
    ("POST", "/sdapi/v1/interrogate"): _ROADMAP_EXTRAS,
    ("GET", "/controlnet/model_list"): _ROADMAP_CONTROLNET,
    ("GET", "/controlnet/module_list"): _ROADMAP_CONTROLNET,
    ("GET", "/controlnet/version"): _ROADMAP_CONTROLNET,
    ("GET", "/sdapi/v1/spaces"): _ROADMAP_SPACES,
    ("POST", "/sdapi/v1/spaces/launch"): _ROADMAP_SPACES,
    ("POST", "/sdapi/v1/spaces/terminate"): _ROADMAP_SPACES,
    ("POST", "/sdapi/v1/create/embedding"): _ROADMAP_MANAGE,
    ("GET", "/sdapi/v1/extensions"): _ROADMAP_MANAGE,
    ("POST", "/sdapi/v1/extensions/install"): _ROADMAP_MANAGE,
    ("POST", "/sdapi/v1/extensions/update"): _ROADMAP_MANAGE,
    ("POST", "/sdapi/v1/merge-checkpoints"): _ROADMAP_MANAGE,
    ("GET", "/sdapi/v1/extra-networks/metadata"): _ROADMAP_MANAGE,
    ("POST", "/sdapi/v1/extra-networks/metadata"): _ROADMAP_MANAGE,
    ("GET", "/sdapi/v1/extra-networks/cards"): _ROADMAP_MANAGE,
    ("GET", "/sdapi/v1/extra-networks/preview"): _ROADMAP_MANAGE,
    ("GET", "/config_states"): _ROADMAP_MANAGE,
    ("POST", "/config_states/save"): _ROADMAP_MANAGE,
    ("POST", "/sdapi/v1/server-restart"): _ROADMAP_MANAGE,
}


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
        }
        for route, item in UNPORTED_ROUTES.items():
            self.routes[route] = self._unported(route, item)
        self._server: Optional[ThreadingHTTPServer] = None
        self._standalone_loras = None

    @staticmethod
    def _unported(route, item):
        def answer(query, body):
            raise ApiError(501, f"{route[0]} {route[1]} is not ported to forge_tpu_torch yet "
                                f"(ROADMAP.md {item})")

        return answer

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
        """process_images on the work queue, between state.begin and state.end,
        under the request's override_settings."""
        overrides = body.get("override_settings") or {}

        def run():
            with opts.override(overrides):
                state.begin(kind, job_count=p.n_iter, steps=p.steps)
                try:
                    engine = self._engine()
                    _apply_alwayson_scripts(p, body.get("alwayson_scripts"), engine.device,
                                            engine.compute_dtype)
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

    def get_upscalers(self, query, body):
        from ..pipeline.upscalers import get_default_registry

        return [{"name": n, "model_name": None, "model_path": None, "model_url": None,
                 "scale": u.scale}
                for n, u in get_default_registry().upscalers.items()]

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
            raise ApiError(404, "server stop disabled (pass --api-server-stop)")
        threading.Thread(target=self._shutdown, daemon=True).start()
        return {}

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
        try:
            self._reply(200, handler(parse_qs(parsed.query), body))
        except ApiError as e:
            self._reply(e.status, {"detail": str(e)})
        except NotImplementedError as e:  # a request feature the port refuses
            self._reply(422, {"detail": str(e)})
        except KeyError as e:  # an unported option, an unknown sampler or upscaler
            self._reply(422, {"detail": str(e.args[0]) if e.args else str(e)})
        except FileNotFoundError as e:
            self._reply(404, {"detail": str(e)})
        except Exception as e:  # noqa: BLE001
            self._reply(500, {"detail": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def create_server(models: ModelManager, host: str = "127.0.0.1", port: int = 7860,
                  api_auth: Optional[str] = None) -> ThreadingHTTPServer:
    """The API's server, not yet serving (run `serve_forever` on a thread);
    port 0 takes a free port, read back from `server.server_address`.
    `api_auth` "user:pass[,user2:pass2]" turns on HTTP basic auth."""
    api = Api(models)
    creds = None
    if api_auth:
        creds = {"Basic " + base64.b64encode(pair.strip().encode()).decode()
                 for pair in api_auth.split(",") if pair.strip()}
    handler = type("BoundHandler", (_Handler,), {"api": api, "auth": creds})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    server.api = api
    api._server = server
    return server


def serve(models: ModelManager, host: str = "127.0.0.1", port: int = 7860,
          api_auth: Optional[str] = None):
    """Serve until /sdapi/v1/server-stop (or an interrupt of the process)."""
    server = create_server(models, host, port, api_auth=api_auth)
    print(f"forge_tpu_torch API listening on http://{host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        work_queue.stop()

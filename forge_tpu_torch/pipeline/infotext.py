# Copied from forge_tpu/pipeline/infotext.py; the parser fires no script callbacks (no scripts runtime).
"""Infotext: the generation-parameter line embedded in every image.

Reference parity targets:
  - serializer: modules/processing.py:668-798 (create_infotext) — ~60 keys,
    ordered, None-skipping, quote() for values containing , : or newlines,
    plus the ``extra_generation_params`` extension mechanism that pipeline
    stages and scripts fill in (hires keys processing.py:1247-1340, mask keys
    :1684-1848, sampler sigma keys sd_samplers_common.py:300-340, lora hashes
    extensions-builtin/sd_forge_lora/extra_networks_lora.py:56).
  - parser: modules/infotext_utils.py:251-491 (parse_generation_parameters) —
    regex key:value scan of the last line, quoted-value unescape, "WxH" size
    splitting into -1/-2 halves, and the backward-compat default shims so old
    images paste correctly.

The infotext round-trip is the ecosystem's reproducibility oracle:
serialize → parse → map-to-Processing must recover every field that affects
the image. The version key names forge_tpu_torch's version.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional

# reference infotext_utils.py:18 — key chars allow spaces/dash/slash
re_param = re.compile(r'\s*(\w[\w \-/]+):\s*("(?:\\.|[^\\"])+"|[^,]*)(?:,|$)')
re_imagesize = re.compile(r"^(\d+)x(\d+)$")


def quote(text: Any) -> Any:
    """reference infotext_utils.py:58-62: json-quote values that would break
    the comma/colon-separated line."""
    s = str(text)
    if "," not in s and "\n" not in s and ":" not in s:
        return text
    return json.dumps(s, ensure_ascii=False)


def unquote(text: str) -> str:
    if len(text) == 0 or text[0] != '"' or text[-1] != '"':
        return text
    try:
        return json.loads(text)
    except Exception:
        return text


def format_params(params: Dict[str, Any]) -> str:
    """k: v comma line, dropping None values (reference processing.py:792)."""
    return ", ".join(
        k if k == v else f"{k}: {quote(v)}"
        for k, v in params.items()
        if v is not None
    )


def build_generation_params(p, seed: int, subseed: int) -> Dict[str, Any]:
    """Assemble the ordered key dict for one image.

    ``p`` is a pipeline Processing object; extension/stage-specific keys ride
    in ``p.extra_generation_params`` exactly like the reference.
    """
    from ..runtime.options import opts

    def opt(key, default=None):
        try:
            return opts.get(key)
        except KeyError:
            return default

    is_flux = getattr(p, "_engine_family", None) in ("flux", "chroma")
    extra = dict(getattr(p, "extra_generation_params", None) or {})

    params: Dict[str, Any] = {
        "Steps": p.steps,
        "Sampler": p.sampler_name,
        "Schedule type": _schedule_label(p),
        "CFG scale": p.cfg_scale,
    }
    if is_flux:
        params["Distilled CFG Scale"] = p.distilled_cfg_scale
    image_cfg = getattr(p, "image_cfg_scale", None)
    params.update({
        "Image CFG scale": image_cfg,
        "Seed": seed,
        "Face restoration": (opt("face_restoration_model", "CodeFormer")
                             if getattr(p, "restore_faces", False) else None),
        "Size": f"{p.width}x{p.height}",
        "Model hash": getattr(p, "sd_model_hash", None)
                      if opt("add_model_hash_to_info", True) else None,
        "Model": getattr(p, "sd_model_name", None)
                 if opt("add_model_name_to_info", True) else None,
        "Variation seed": subseed if p.subseed_strength else None,
        "Variation seed strength": p.subseed_strength or None,
        "Seed resize from": (
            f"{p.seed_resize_from_w}x{p.seed_resize_from_h}"
            if p.seed_resize_from_w > 0 and p.seed_resize_from_h > 0 else None
        ),
        "Denoising strength": extra.pop("Denoising strength", None),
        "Clip skip": None if p.clip_skip <= 1 else p.clip_skip,
        "ENSD": p.eta_noise_seed_delta or None,
        "Init image hash": getattr(p, "init_img_hash", None),
        "Tiling": "True" if getattr(p, "tiling", False) else None,
    })
    params.update(extra)
    if opt("add_version_to_infotext", True):
        from .. import __version__

        params["Version"] = f"forge-tpu {__version__}"
    if getattr(p, "user", None) and opt("add_user_name_to_info", False):
        params["User"] = p.user
    return params


def _schedule_label(p) -> Optional[str]:
    """Human label for the resolved schedule (reference emits the scheduler
    registry label, sd_samplers_kdiffusion.py:106)."""
    sched = p.scheduler
    if not sched or sched == "automatic":
        # reference resolves 'Automatic' to the real schedule before emitting
        from .processing import _auto_schedule

        sched = _auto_schedule(p.sampler_name, sched)
    return _SCHEDULE_LABELS.get(sched, sched.replace("_", " ").title())


_SCHEDULE_LABELS = {
    "normal": "Normal", "karras": "Karras", "exponential": "Exponential",
    "polyexponential": "Polyexponential", "sgm_uniform": "SGM Uniform",
    "kl_optimal": "KL Optimal", "align_your_steps": "Align Your Steps",
    "align_your_steps_11": "Align Your Steps 11",
    "align_your_steps_32": "Align Your Steps 32",
    "align_your_steps_gits": "Align Your Steps GITS",
    "simple": "Simple", "ddim": "DDIM", "beta": "Beta", "turbo": "Turbo",
    "uniform": "Uniform",
}
_SCHEDULE_BY_LABEL = {v: k for k, v in _SCHEDULE_LABELS.items()}


def create_infotext(p, seed: int, subseed: int) -> str:
    params = build_generation_params(p, seed, subseed)
    text = format_params(params)
    neg = f"\nNegative prompt: {p.negative_prompt}" if p.negative_prompt else ""
    return f"{p.prompt}{neg}\n{text}".strip()


# -- parser ------------------------------------------------------------------


def parse_generation_parameters(x: str, skip_fields: Optional[list] = None
                                ) -> Dict[str, Any]:
    """Parse an infotext back into a key dict, with the reference's
    backward-compat default shims (infotext_utils.py:251-430)."""
    res: Dict[str, Any] = {}
    if not x or not x.strip():
        return res

    *lines, lastline = x.strip().split("\n")
    if len(re_param.findall(lastline)) < 3:
        lines.append(lastline)
        lastline = ""

    prompt, negative = "", ""
    done_with_prompt = False
    for line in lines:
        line = line.strip()
        if line.startswith("Negative prompt:"):
            done_with_prompt = True
            line = line[16:].strip()
        if done_with_prompt:
            negative += ("" if negative == "" else "\n") + line
        else:
            prompt += ("" if prompt == "" else "\n") + line

    for k, v in re_param.findall(lastline):
        try:
            if v and v[0] == '"' and v[-1] == '"':
                v = unquote(v)
            m = re_imagesize.match(v)
            if m is not None:
                res[f"{k}-1"] = m.group(1)
                res[f"{k}-2"] = m.group(2)
            else:
                res[k] = v
        except Exception:
            pass

    res["Prompt"] = prompt
    res["Negative prompt"] = negative

    # backward-compat defaults (missing key == reference default)
    defaults = {
        "Clip skip": "1",
        "Hires resize-1": 0,
        "Hires resize-2": 0,
        "Hires sampler": "Use same sampler",
        "Hires schedule type": "Use same scheduler",
        "Hires checkpoint": "Use same checkpoint",
        "Hires prompt": "",
        "Hires negative prompt": "",
        "Mask mode": "Inpaint masked",
        "Masked content": "original",
        "Inpaint area": "Whole picture",
        "Masked area padding": 32,
        "RNG": "GPU",
        "Schedule type": "Automatic",
        "Schedule max sigma": 0,
        "Schedule min sigma": 0,
        "Schedule rho": 0,
        "VAE Encoder": "Full",
        "VAE Decoder": "Full",
        "FP8 weight": "Disable",
        "Refiner switch by sampling steps": False,
    }
    for k, v in defaults.items():
        res.setdefault(k, v)

    for key in skip_fields or []:
        res.pop(key, None)

    return res


# Paste-back binding: infotext key → (Processing field, cast). The reference
# does this with per-component PasteField bindings (infotext_utils.py:113-196);
# here it is one table because Processing is a plain dataclass.
def _size_cast(v):
    return int(float(v))


def _bool_cast(v):
    return str(v).lower() in ("true", "1", "yes")


_FIELD_MAP = {
    "Prompt": ("prompt", str),
    "Negative prompt": ("negative_prompt", str),
    "Steps": ("steps", int),
    "Sampler": ("sampler_name", str),
    "CFG scale": ("cfg_scale", float),
    "Distilled CFG Scale": ("distilled_cfg_scale", float),
    "Image CFG scale": ("image_cfg_scale", float),
    "Seed": ("seed", int),
    "Size-1": ("width", _size_cast),
    "Size-2": ("height", _size_cast),
    "Model": ("sd_model_name", str),
    "Model hash": ("sd_model_hash", str),
    "Denoising strength": ("denoising_strength", float),
    "Clip skip": ("clip_skip", int),
    "ENSD": ("eta_noise_seed_delta", int),
    "Variation seed": ("subseed", int),
    "Variation seed strength": ("subseed_strength", float),
    "Seed resize from-1": ("seed_resize_from_w", _size_cast),
    "Seed resize from-2": ("seed_resize_from_h", _size_cast),
    "Hires upscale": ("hr_scale", float),
    "Hires steps": ("hr_second_pass_steps", int),
    "Hires upscaler": ("hr_upscaler", str),
    "Hires prompt": ("hr_prompt", str),
    "Hires negative prompt": ("hr_negative_prompt", str),
    "Hires CFG Scale": ("hr_cfg_scale", float),
    "Mask blur": ("mask_blur", float),
    "Masked area padding": ("inpaint_full_res_padding", int),
    "Eta": ("eta", float),
    "Eta DDIM": ("eta_ddim", float),
    "Sigma churn": ("s_churn", float),
    "Sigma noise": ("s_noise", float),
    "Refiner switch at": ("refiner_switch_at", float),
    "Tiling": ("tiling", _bool_cast),
    "Face restoration": ("restore_faces", lambda v: bool(v)),
}


def infotext_to_processing_args(text: str) -> Dict[str, Any]:
    """Infotext → Processing constructor kwargs (the API ``infotext`` field
    and UI paste path, reference api.py:301-351 apply_infotext)."""
    d = parse_generation_parameters(text)
    out: Dict[str, Any] = {}

    # style extraction on paste (reference infotext_utils.py:318-333,
    # governed by the infotext_styles option): peel known styles off the
    # prompts and re-express them as style selections
    mode = "Ignore"
    try:
        from ..runtime.options import opts

        mode = str(opts.get("infotext_styles"))
    except Exception:  # noqa: BLE001 — options registry optional in tests
        pass
    if mode in ("Apply", "Discard", "Apply if any") and d.get("Prompt"):
        from ..runtime.styles import prompt_styles

        found, pos, neg = prompt_styles.extract_styles_from_prompt(
            d.get("Prompt", ""), d.get("Negative prompt", ""))
        if found:
            d["Prompt"], d["Negative prompt"] = pos, neg
            if mode != "Discard":
                out["styles"] = found
    for key, (field, cast) in _FIELD_MAP.items():
        v = d.get(key)
        if v is None or v == "":
            continue
        try:
            out[field] = cast(v)
        except (TypeError, ValueError):
            pass

    st = d.get("Schedule type")
    if st and st != "Automatic":
        out["scheduler"] = _SCHEDULE_BY_LABEL.get(st, st.lower().replace(" ", "_"))
    if d.get("Hires checkpoint") not in (None, "", "Use same checkpoint"):
        out["hr_checkpoint_name"] = d["Hires checkpoint"]
    if d.get("Refiner") not in (None, ""):
        out["refiner_checkpoint"] = d["Refiner"]
    if d.get("Mask mode") == "Inpaint not masked":
        out["inpainting_mask_invert"] = True
    if d.get("Inpaint area") == "Only masked":
        out["inpaint_full_res"] = True
    mc = d.get("Masked content")
    if mc in ("fill", "original", "latent noise", "latent nothing"):
        out["inpainting_fill"] = mc.replace(" ", "_")
    if "Hires resize-1" in d and int(d["Hires resize-1"] or 0) > 0:
        out["hr_resize_x"] = int(d["Hires resize-1"])
        out["hr_resize_y"] = int(d["Hires resize-2"])
    if "Hires upscale" in d or "Hires resize-1" in d and int(d.get("Hires resize-1") or 0) > 0:
        if "Hires upscale" in d:
            out["enable_hr"] = True
        # in txt2img infotexts Denoising strength IS the hires strength
        # (reference reuses one field; ours are separate)
        if "denoising_strength" in out:
            out["hr_denoising_strength"] = out["denoising_strength"]
    return out


def write_params_txt(text: str, path: str = "params.txt") -> None:
    """Persist the last generation's infotext (reference processing.py:970)."""
    try:
        with open(path, "w", encoding="utf8") as f:
            f.write(text)
    except OSError:
        pass

# Copied from forge_tpu/pipeline/selectable_scripts.py (the registry, the seven scripts and img2img alternative test); the image and latent work on torch tensors and numpy.
"""Selectable scripts: whole-generation runs picked from the Script
dropdown (reference `scripts/` — prompt_matrix.py, prompts_from_file.py,
loopback.py, sd_upscale.py, poor_mans_outpainting.py, outpainting_mk_2.py,
custom_code.py; dispatched via Script.run when the API request carries
`script_name`/`script_args`, modules/api/api.py init_script_args).

Each entry takes (engine, p, args) and OWNS the generation: it may run
process_images many times and returns one Processed. The host's random
draws (`random.randrange` for a seed of −1, `np.random.default_rng` for
outpainting mk2's noise and img2img alternative test's randomness) and the
resizing (pipeline/images.py's Lanczos, Pillow's to the byte) are
forge_tpu's; the img2img alternative test's latent stays on the engine's
device between its steps.
"""

from __future__ import annotations

import math
import shlex
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .images import image_grid, lanczos_resize
from .processing import Processed, Processing, process_images


class SelectableScript:
    def __init__(self, name: str, run: Callable, is_img2img: bool = False,
                 ui_spec: Optional[List[Dict[str, Any]]] = None):
        self.name = name
        self.run = run
        self.is_img2img = is_img2img
        self.ui_spec = ui_spec or []


SELECTABLE: Dict[str, SelectableScript] = {}


def register(s: SelectableScript):
    SELECTABLE[s.name.lower()] = s
    return s


def get_script(name: str) -> SelectableScript:
    key = name.lower()
    if key not in SELECTABLE:
        raise KeyError(
            f"unknown script {name!r} — selectable: "
            + ", ".join(sorted(s.name for s in SELECTABLE.values())))
    return SELECTABLE[key]


def _fix_seed(p: Processing) -> None:
    import random

    if p.seed is None or int(p.seed) == -1:
        p.seed = random.randrange(4294967294)


def _merge(results: List[Processed], images: Optional[List[np.ndarray]] = None
           ) -> Processed:
    first = results[0]
    return Processed(
        images=images if images is not None
        else [im for r in results for im in r.images],
        seeds=[s for r in results for s in r.seeds],
        subseeds=[s for r in results for s in r.subseeds],
        infotexts=[t for r in results for t in r.infotexts],
        params=first.params, timings=first.timings)


# ---------------------------------------------------------------------------
# Prompt matrix (reference scripts/prompt_matrix.py:58-89)


def _run_prompt_matrix(engine, p: Processing, put_at_start: bool = False,
                       different_seeds: bool = False,
                       prompt_type: str = "positive",
                       variations_delimiter: str = "comma",
                       margin_size: int = 0) -> Processed:
    _fix_seed(p)
    source = p.prompt if prompt_type == "positive" else p.negative_prompt
    parts = source.split("|")
    delim = ", " if variations_delimiter == "comma" else " "
    combos = []
    for n in range(2 ** (len(parts) - 1)):
        chosen = [t.strip().strip(",") for i, t in enumerate(parts[1:])
                  if n & (1 << i)]
        ordered = chosen + [parts[0].strip()] if put_at_start \
            else [parts[0].strip()] + chosen
        combos.append(delim.join(x for x in ordered if x))

    results = []
    base_seed = p.seed
    for i, text in enumerate(combos):
        q = _clone(p)
        q.do_not_save_grid = True
        q.seed = base_seed + i if different_seeds else base_seed
        if prompt_type == "positive":
            q.prompt = text
        else:
            q.negative_prompt = text
        results.append(process_images(engine, q))

    rows = 1 << (max(len(parts) - 1, 2) // 2)
    grid = image_grid([r.images[0] for r in results], rows=rows,
                      margin=int(margin_size))
    merged = _merge(results)
    merged.images = [grid] + merged.images
    merged.infotexts = [merged.infotexts[0]] + merged.infotexts
    return merged


# ---------------------------------------------------------------------------
# Prompts from file or textbox (reference scripts/prompts_from_file.py)

# request fields a prompt line may override with `--field value` (reference
# prompt_tags, scripts/prompts_from_file.py:14-43)
_LINE_FIELDS = {"prompt": str, "negative_prompt": str, "seed": int,
                "subseed": int, "subseed_strength": float, "steps": int,
                "cfg_scale": float, "width": int, "height": int,
                "sampler_name": str, "batch_size": int, "n_iter": int,
                "denoising_strength": float}


def parse_prompt_line(line: str) -> Dict[str, Any]:
    """`a cat --steps 12 --width 640` → {'prompt': 'a cat', 'steps': 12, ...}"""
    if "--" not in line:
        return {"prompt": line.strip()}
    toks = shlex.split(line, posix=True)
    out: Dict[str, Any] = {}
    pos: List[str] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.startswith("--") and t[2:] in _LINE_FIELDS:
            field = t[2:]
            i += 1
            vals = []
            while i < len(toks) and not (toks[i].startswith("--")
                                         and toks[i][2:] in _LINE_FIELDS):
                vals.append(toks[i])
                i += 1
            out[field] = _LINE_FIELDS[field](" ".join(vals))
        else:
            pos.append(t)
            i += 1
    if pos and "prompt" not in out:
        out["prompt"] = " ".join(pos)
    return out


def _run_prompts_from_file(engine, p: Processing, checkbox_iterate: bool = False,
                           checkbox_iterate_batch: bool = False,
                           prompt_txt: str = "") -> Processed:
    lines = [ln for ln in (prompt_txt or "").splitlines() if ln.strip()]
    if not lines:
        raise ValueError("prompts_from_file: no prompt lines given")
    # seed semantics match the reference: -1 stays -1 (fresh noise per line)
    # unless iterate (consecutive seeds) or iterate_batch (one shared random
    # seed for every line) is on
    if checkbox_iterate or checkbox_iterate_batch:
        _fix_seed(p)
    results = []
    seed = p.seed
    for ln in lines:
        q = _clone(p)
        q.do_not_save_grid = True
        q.seed = seed
        for k, v in parse_prompt_line(ln).items():
            setattr(q, k, v)
        r = process_images(engine, q)
        results.append(r)
        if checkbox_iterate:  # consecutive seeds down the list
            seed = r.seeds[-1] + 1
    return _merge(results)


# ---------------------------------------------------------------------------
# Loopback (reference scripts/loopback.py)


def _run_loopback(engine, p: Processing, loops: int = 4,
                  final_denoising_strength: float = 0.5,
                  denoising_curve: str = "Linear",
                  append_interrogation: str = "None") -> Processed:
    if p.init_images is None:
        raise ValueError("loopback needs an init image (img2img)")
    _fix_seed(p)
    initial = p.denoising_strength

    def strength_at(i: int) -> float:
        if loops == 1:
            return initial
        prog = i / (loops - 1)
        if denoising_curve == "Aggressive":
            s = math.sin(prog * math.pi * 0.5)
        elif denoising_curve == "Lazy":
            s = 1 - math.cos(prog * math.pi * 0.5)
        else:
            s = prog
        return initial + (final_denoising_strength - initial) * s

    results = []
    q = _clone(p)
    q.batch_size, q.n_iter, q.do_not_save_grid = 1, 1, True
    for i in range(int(loops)):
        q.denoising_strength = strength_at(i)
        r = process_images(engine, q)
        results.append(r)
        q = _clone(q)
        q.init_images = [r.images[0]]
        q.seed = r.seeds[-1] + 1
    return _merge(results)


# ---------------------------------------------------------------------------
# SD upscale (reference scripts/sd_upscale.py): pixel upscale, then img2img
# each p.width×p.height tile with `overlap`, linear seam blend on recombine.


def _run_sd_upscale(engine, p: Processing, _info: Any = None,
                    overlap: int = 64, upscaler_name: str = "Lanczos",
                    scale_factor: float = 2.0) -> Processed:
    if p.init_images is None:
        raise ValueError("SD upscale needs an init image (img2img)")
    _fix_seed(p)
    from .upscalers import get_default_registry

    registry = getattr(engine, "upscalers", None) or get_default_registry()
    img = np.asarray(p.init_images[0])
    scale_factor = max(float(scale_factor), 1.0)
    if upscaler_name and upscaler_name != "None":
        img = np.asarray(registry.get(upscaler_name).upscale(img, scale_factor))

    # tile never exceeds the upscaled image (reference split_grid contract);
    # clamp to 64-multiples so the latent sides stay even
    th = max(min(p.height, img.shape[0]) // 64 * 64, 64)
    tw = max(min(p.width, img.shape[1]) // 64 * 64, 64)
    p.height, p.width = th, tw
    H, W = img.shape[:2]
    stride_y = max(th - overlap, 1)
    stride_x = max(tw - overlap, 1)
    ys = list(range(0, max(H - th, 0) + 1, stride_y)) or [0]
    xs = list(range(0, max(W - tw, 0) + 1, stride_x)) or [0]
    if ys[-1] + th < H:
        ys.append(H - th)
    if xs[-1] + tw < W:
        xs.append(W - tw)

    out = np.zeros((H, W, 3), np.float32)
    weight = np.zeros((H, W, 1), np.float32)

    def ramp(n: int, ov: int) -> np.ndarray:
        w = np.ones(n, np.float32)
        if ov > 0:
            r = np.linspace(0, 1, ov + 2)[1:-1]
            w[:ov] = np.minimum(w[:ov], r)
            w[-ov:] = np.minimum(w[-ov:], r[::-1])
        return w

    infotexts, seeds = [], []
    q = _clone(p)
    q.do_not_save_grid, q.do_not_save_samples = True, True
    q.n_iter, q.batch_size = 1, 1
    for y in ys:
        for x in xs:
            tile = img[y:y + th, x:x + tw]
            q.init_images = [tile]
            r = process_images(engine, q)
            q.seed = r.seeds[-1] + 1
            infotexts = infotexts or r.infotexts
            seeds.extend(r.seeds)
            wy = ramp(th, overlap if 0 < y else 0)[:, None] * \
                ramp(th, overlap if y + th < H else 0)[:, None]
            wx = ramp(tw, overlap if 0 < x else 0)[None, :] * \
                ramp(tw, overlap if x + tw < W else 0)[None, :]
            w = (wy * wx)[..., None]
            out[y:y + th, x:x + tw] += r.images[0].astype(np.float32) * w
            weight[y:y + th, x:x + tw] += w
    combined = (out / np.maximum(weight, 1e-6)).clip(0, 255).astype(np.uint8)
    return Processed(images=[combined], seeds=seeds[:1],
                     subseeds=[p.subseed], infotexts=infotexts,
                     params={}, timings={})


# ---------------------------------------------------------------------------
# Outpainting (reference scripts/poor_mans_outpainting.py and
# outpainting_mk_2.py). Both extend the canvas and inpaint the new border;
# mk2 seeds the border with spectrum-matched noise so large extensions keep
# the image's texture statistics (the published A1111 "outpainting mk2"
# algorithm, re-derived: histogram-matched white noise blended through an
# FFT magnitude transfer from the source).


def _edge_fill(img: np.ndarray, top: int, bottom: int, left: int, right: int
               ) -> np.ndarray:
    return np.pad(img, ((top, bottom), (left, right), (0, 0)), mode="edge")


def _matched_noise_fill(img: np.ndarray, top: int, bottom: int, left: int,
                        right: int, noise_q: float = 1.0,
                        color_variation: float = 0.05,
                        seed: int = 0) -> np.ndarray:
    """Spectrum-matched noise in the extended border: white noise shaped by
    the source's FFT magnitude (per channel), mixed with the edge-replicated
    base. Re-derivation of outpainting_mk_2.get_matched_noise's intent."""
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    base = _edge_fill(img, top, bottom, left, right).astype(np.float32)
    H, W = base.shape[:2]
    shaped = np.empty_like(base)
    for c in range(base.shape[2]):
        mag = np.abs(np.fft.rfft2(base[..., c]))
        phase = rng.uniform(0, 2 * np.pi, mag.shape)
        noise = np.fft.irfft2((mag ** noise_q) * np.exp(1j * phase), s=(H, W))
        lo, hi = np.percentile(noise, [2, 98])
        noise = (noise - lo) / max(hi - lo, 1e-6)
        shaped[..., c] = noise * 255.0
    mixed = base * (1 - color_variation) + shaped * color_variation
    # keep the original pixels exact; noise only in the new border
    out = mixed
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out.clip(0, 255).astype(np.uint8)


def _run_outpaint(engine, p: Processing, pixels: int, mask_blur: float,
                  directions: Sequence[str], fill_mode: str,
                  noise_q: float = 1.0, color_variation: float = 0.05,
                  matched_noise: bool = False) -> Processed:
    if p.init_images is None:
        raise ValueError("outpainting needs an init image (img2img)")
    _fix_seed(p)
    img = np.asarray(p.init_images[0])
    top = pixels if "up" in directions else 0
    bottom = pixels if "down" in directions else 0
    left = pixels if "left" in directions else 0
    right = pixels if "right" in directions else 0

    # round the canvas up to /64 (the reference sizes outpaint targets to
    # 64-multiples; odd latent sides also break UNet down/up skip shapes) by
    # extending the border pad on the grown sides
    gh = img.shape[0] + top + bottom
    gw = img.shape[1] + left + right
    eh, ew = (-gh) % 64, (-gw) % 64
    if bottom or not top:
        bottom += eh
    else:
        top += eh
    if right or not left:
        right += ew
    else:
        left += ew

    if matched_noise:
        canvas = _matched_noise_fill(img, top, bottom, left, right,
                                     noise_q, color_variation, seed=p.seed)
    else:
        canvas = _edge_fill(img, top, bottom, left, right)
    H, W = canvas.shape[:2]
    mask = np.ones((H, W), np.float32)
    keep = max(int(mask_blur) * 2, 8)  # overlap band repainted around the seam
    mask[top + (keep if top else 0): H - bottom - (keep if bottom else 0),
         left + (keep if left else 0): W - right - (keep if right else 0)] = 0.0

    q = _clone(p)
    q.init_images = [canvas]
    q.inpaint_mask = mask
    q.mask_blur = mask_blur
    q.inpainting_fill = fill_mode
    q.width = W - W % 8
    q.height = H - H % 8
    q.do_not_save_grid = True
    return process_images(engine, q)


def _run_poor_mans(engine, p: Processing, pixels: int = 128,
                   mask_blur: float = 4, inpainting_fill: str = "fill",
                   direction: Sequence[str] = ("left", "right", "up", "down")
                   ) -> Processed:
    return _run_outpaint(engine, p, int(pixels), mask_blur, direction,
                         inpainting_fill, matched_noise=False)


def _run_outpainting_mk2(engine, p: Processing, _info: Any = None,
                         pixels: int = 128, mask_blur: float = 8,
                         direction: Sequence[str] = ("left", "right", "up", "down"),
                         noise_q: float = 1.0, color_variation: float = 0.05
                         ) -> Processed:
    return _run_outpaint(engine, p, int(pixels), mask_blur, direction,
                         "original", noise_q=noise_q,
                         color_variation=color_variation, matched_noise=True)


# ---------------------------------------------------------------------------
# Custom code (reference scripts/custom_code.py — gated on --allow-code)


def _run_custom_code(engine, p: Processing, code: str = "",
                     indent_level: int = 0) -> Processed:
    from ..api.server import CMD_FLAGS

    if not CMD_FLAGS.get("allow_code"):
        raise PermissionError(
            "custom code requires launching with --allow-code")
    namespace: Dict[str, Any] = {"engine": engine, "p": p,
                                 "process_images": process_images,
                                 "np": np, "Processed": Processed}
    exec(compile(code, "<custom_code>", "exec"), namespace)  # noqa: S102
    ret = namespace.get("result")
    if isinstance(ret, Processed):
        return ret
    return process_images(engine, p)


def _clone(p: Processing) -> Processing:
    import copy
    import dataclasses

    q = Processing()
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, (list, dict)):
            v = copy.copy(v)
        setattr(q, f.name, v)
    q.all_seeds = q.all_subseeds = None
    return q


register(SelectableScript(
    "Prompt matrix", _run_prompt_matrix, ui_spec=[
        {"name": "put_at_start", "type": "bool", "default": False},
        {"name": "different_seeds", "type": "bool", "default": False},
        {"name": "prompt_type", "type": "choice",
         "choices": ["positive", "negative"], "default": "positive"},
        {"name": "variations_delimiter", "type": "choice",
         "choices": ["comma", "space"], "default": "comma"},
        {"name": "margin_size", "type": "int", "default": 0}]))
register(SelectableScript(
    "Prompts from file or textbox", _run_prompts_from_file, ui_spec=[
        {"name": "checkbox_iterate", "type": "bool", "default": False},
        {"name": "checkbox_iterate_batch", "type": "bool", "default": False},
        {"name": "prompt_txt", "type": "text", "default": ""}]))
register(SelectableScript(
    "Loopback", _run_loopback, is_img2img=True, ui_spec=[
        {"name": "loops", "type": "int", "default": 4},
        {"name": "final_denoising_strength", "type": "float", "default": 0.5},
        {"name": "denoising_curve", "type": "choice",
         "choices": ["Linear", "Aggressive", "Lazy"], "default": "Linear"},
        {"name": "append_interrogation", "type": "choice",
         "choices": ["None", "CLIP", "DeepBooru"], "default": "None"}]))
register(SelectableScript(
    "SD upscale", _run_sd_upscale, is_img2img=True, ui_spec=[
        {"name": "info", "type": "none", "default": None},
        {"name": "overlap", "type": "int", "default": 64},
        {"name": "upscaler_name", "type": "text", "default": "Lanczos"},
        {"name": "scale_factor", "type": "float", "default": 2.0}]))
register(SelectableScript(
    "Poor man's outpainting", _run_poor_mans, is_img2img=True, ui_spec=[
        {"name": "pixels", "type": "int", "default": 128},
        {"name": "mask_blur", "type": "float", "default": 4},
        {"name": "inpainting_fill", "type": "choice",
         "choices": ["fill", "original", "latent_noise", "latent_nothing"],
         "default": "fill"},
        {"name": "direction", "type": "multi",
         "choices": ["left", "right", "up", "down"],
         "default": ["left", "right", "up", "down"]}]))
register(SelectableScript(
    "Outpainting mk2", _run_outpainting_mk2, is_img2img=True, ui_spec=[
        {"name": "info", "type": "none", "default": None},
        {"name": "pixels", "type": "int", "default": 128},
        {"name": "mask_blur", "type": "float", "default": 8},
        {"name": "direction", "type": "multi",
         "choices": ["left", "right", "up", "down"],
         "default": ["left", "right", "up", "down"]},
        {"name": "noise_q", "type": "float", "default": 1.0},
        {"name": "color_variation", "type": "float", "default": 0.05}]))
register(SelectableScript(
    "Custom code", _run_custom_code, ui_spec=[
        {"name": "code", "type": "text", "default": ""},
        {"name": "indent_level", "type": "int", "default": 0}]))


# ---------------------------------------------------------------------------
# img2img alternative test (reference scripts/img2imgalt.py): reconstruct the
# noise that would produce the init image under the ORIGINAL prompt by
# running Euler in reverse (ascending sigma), then re-sample toward the new
# prompt from that noise — deterministic "CLIP-guided editing".


def _cfg_apply(engine, cond, uncond, cfg_scale):
    """denoise(x, σ) = du + (dc − du)·cfg_scale from two uncombined batch-1
    calls of the engine's UNet (no hooks), cond first."""
    from ..sampling import cfg as cfg_mod

    apply = cfg_mod.make_apply_model(engine.unet_apply_fn(), engine.loaded.unet,
                                     engine.predictor, engine.compute_dtype)

    def denoise(x, sigma):
        dc = apply(x, sigma, cond)
        du = apply(x, sigma, uncond)
        return du + (dc - du) * cfg_scale

    return denoise


@torch.no_grad()
def find_noise_for_image(engine, latent: torch.Tensor, cond, uncond, cfg_scale: float,
                         steps: int) -> torch.Tensor:
    """Reverse Euler (reference img2imgalt.py find_noise_for_image:28-59):
    ascending σ walk of d=(x−D(x,σ))/σ; returns x normalized to unit std
    (noise units; numpy's std, without Bessel's correction)."""
    from ..sampling.schedules import get_sigmas

    sigmas = np.asarray(get_sigmas("normal", steps, engine.predictor),
                        np.float32)[::-1]  # ascending, starts at 0
    denoise = _cfg_apply(engine, cond, uncond, cfg_scale)
    x = latent.float()
    for i in range(1, len(sigmas)):
        sig = float(sigmas[i])
        d = (x - denoise(x, sig)) / sig
        x = x + d * float(sigmas[i] - sigmas[i - 1])
    return x / max(float(x.std(correction=0)), 1e-6)


@torch.no_grad()
def _run_img2img_alt(engine, p: Processing, _info: Any = None,
                     override_prompt: bool = True, original_prompt: str = "",
                     original_negative_prompt: str = "",
                     override_steps: bool = True, st: int = 25,
                     randomness: float = 0.0, sigma_adjustment: bool = True
                     ) -> Processed:
    from ..sampling.schedules import get_sigmas

    if p.init_images is None:
        raise ValueError("img2img alternative needs an init image")
    _fix_seed(p)
    decode_steps = st if override_steps else p.steps
    img = np.asarray(p.init_images[0])
    # fit to the processing size (64-rounded): arbitrary init dims produce
    # odd latent sides that break UNet skip shapes
    p.width = max(p.width - p.width % 64, 64)
    p.height = max(p.height - p.height % 64, 64)
    if img.shape[:2] != (p.height, p.width):
        img = lanczos_resize(img, p.width, p.height)
    x01 = torch.from_numpy(np.ascontiguousarray(
        (img[None].astype(np.float32) / 127.5 - 1.0).transpose(0, 3, 1, 2)))
    latent = engine.encode_first_stage(x01).float()

    def conds(prompt, negative):
        c = engine.get_learned_conditioning([prompt], p.width, p.height)
        u = engine.get_learned_conditioning([negative], p.width, p.height,
                                            is_negative=True)
        return c, u

    oc, ou = conds(original_prompt, original_negative_prompt)
    rec = find_noise_for_image(engine, latent, oc, ou, 1.0, decode_steps)

    # drawn NHWC, as forge_tpu draws it, then taken to NCHW
    b, c, h, w = rec.shape
    rand = np.random.default_rng(p.seed & 0xFFFFFFFF).standard_normal(
        (b, h, w, c)).astype(np.float32)
    rand = torch.from_numpy(np.ascontiguousarray(rand.transpose(0, 3, 1, 2))).to(rec.device)
    r = float(randomness)
    noise = ((1 - r) * rec + r * rand) / math.sqrt(r * r + (1 - r) * (1 - r))

    tc, tu = conds(p.prompt, p.negative_prompt)
    denoise = _cfg_apply(engine, tc, tu, p.cfg_scale)
    sigmas = np.asarray(get_sigmas("normal", decode_steps, engine.predictor),
                        np.float32)
    x = latent + noise * float(sigmas[0])
    for i in range(len(sigmas) - 1):
        sig = float(sigmas[i])
        d = (x - denoise(x, sig)) / sig
        x = x + d * float(sigmas[i + 1] - sigmas[i])

    out = engine.decode_finish(engine.decode_dispatch(x))
    return Processed(images=[out[0]], seeds=[p.seed], subseeds=[p.subseed],
                     infotexts=[f"{p.prompt}\nimg2img alternative, "
                                f"decode steps {decode_steps}"],
                     params={}, timings={})


register(SelectableScript(
    "img2img alternative test", _run_img2img_alt, is_img2img=True, ui_spec=[
        {"name": "info", "type": "none", "default": None},
        {"name": "override_prompt", "type": "bool", "default": True},
        {"name": "original_prompt", "type": "text", "default": ""},
        {"name": "original_negative_prompt", "type": "text", "default": ""},
        {"name": "override_steps", "type": "bool", "default": True},
        {"name": "st", "type": "int", "default": 25},
        {"name": "randomness", "type": "float", "default": 0.0},
        {"name": "sigma_adjustment", "type": "bool", "default": True}]))

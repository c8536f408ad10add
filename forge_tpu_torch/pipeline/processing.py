"""txt2img processing (port of forge_tpu/pipeline/processing.py, txt2img slice).

resolve seeds → encode cond and uncond with a shared chunk count → host
Philox noise → the sampler's step loop on the CFG-batched latent → VAE
decode with the NaN checks → uint8 images. SDXL's conditioning embeds the
image's width and height in `y`. Flux adds the distilled-CFG
guidance scale to both conditionings and samples 16-channel latents; at
CFG 1 the uncond branch is skipped, as for every family.

`Processing` takes only the fields this slice reads. Any other field of the
reference's request (img2img, hires fix, scripts, styles, ...) raises
NotImplementedError rather than being ignored, as do prompt features the
slice does not run yet: `[from:to:when]` editing, `AND` composition and
`<lora:...>` extra networks.
"""

from __future__ import annotations

import dataclasses
import inspect
import random
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.image_rng import ImageRNG
from ..sampling import cfg as cfg_mod
from ..sampling.samplers import get_sampler
from ..sampling.schedules import get_sigmas
from ..text.schedule import get_schedule, split_composable
from .engine import DiffusionEngine, raise_nans

_EXTRA_NETWORK_RE = re.compile(r"<(\w+):([^>]+)>")


@dataclasses.dataclass
class Processing:
    prompt: str = ""
    negative_prompt: str = ""
    seed: int = -1
    subseed: int = -1
    subseed_strength: float = 0.0
    seed_resize_from_h: int = 0
    seed_resize_from_w: int = 0
    sampler_name: str = "Euler a"
    scheduler: str = "automatic"
    steps: int = 20
    cfg_scale: float = 7.0
    distilled_cfg_scale: float = 3.5  # Flux guidance embedding
    width: int = 512
    height: int = 512
    batch_size: int = 1
    n_iter: int = 1
    eta: float = 1.0
    s_churn: float = 0.0
    s_noise: float = 1.0
    clip_skip: int = 1
    eta_noise_seed_delta: int = 0
    all_seeds: Optional[List[int]] = None
    all_subseeds: Optional[List[int]] = None

    def __setattr__(self, name, value):
        if name not in _FIELDS:
            raise NotImplementedError(
                f"Processing.{name} is not ported to forge_tpu_torch yet (txt2img slice)")
        object.__setattr__(self, name, value)

    def __init__(self, **kwargs):
        for f in dataclasses.fields(self):
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            setattr(self, f.name, kwargs.pop(f.name, default))
        if kwargs:
            raise NotImplementedError(
                f"Processing fields not ported to forge_tpu_torch yet: {sorted(kwargs)}")


_FIELDS = frozenset(f.name for f in dataclasses.fields(Processing))


@dataclasses.dataclass
class Processed:
    images: List[np.ndarray]  # uint8 HWC
    seeds: List[int]
    subseeds: List[int]
    timings: Dict[str, float]


def _resolve_seeds(p: Processing) -> None:
    def fix(s):
        return random.randrange(4294967294) if s is None or int(s) == -1 else int(s)

    base = fix(p.seed)
    sub = fix(p.subseed)
    n = p.batch_size * p.n_iter
    p.all_seeds = [base + i for i in range(n)]
    p.all_subseeds = [sub + i for i in range(n)]
    p.seed = base
    p.subseed = sub


def _check_prompt(p: Processing, text: str) -> None:
    if _EXTRA_NETWORK_RE.search(text):
        raise NotImplementedError(f"extra networks in {text!r} are not ported yet")
    if len(split_composable(text)) > 1 or len(get_schedule(text, p.steps)) > 1:
        raise NotImplementedError(
            f"prompt editing / AND composition in {text!r} is not ported yet")


def _auto_schedule(sampler_name: str, scheduler: str) -> str:
    if scheduler and scheduler != "automatic":
        return scheduler
    return "karras" if "Karras" in sampler_name else "normal"


def _prepare_noise(p: Processing, rng: ImageRNG, info, n_steps: int, device):
    """Per-step sampler noise [n_steps, draws, B, C, h, w] (NCHW) on `device`,
    or None for a deterministic sampler."""
    draws = info.noise_draws
    if draws == 0 and "s_churn" in inspect.signature(info.fn).parameters and p.s_churn > 0:
        draws = 1  # a deterministic sampler turns stochastic under churn
    if draws == 0:
        return None
    steps = [np.stack([rng.next() for _ in range(draws)]) for _ in range(n_steps)]
    return torch.from_numpy(np.stack(steps)).to(device)


def _sample_txt2img(engine: DiffusionEngine, p: Processing, seeds, subseeds, cond, uncond,
                    timings: Dict[str, float]) -> np.ndarray:
    t_noise = time.perf_counter()
    info = get_sampler(p.sampler_name)
    lc = engine.latent_format.latent_channels
    rng = ImageRNG(
        (lc, p.height // 8, p.width // 8), seeds, subseeds=subseeds,
        subseed_strength=p.subseed_strength,
        seed_resize_from_h=p.seed_resize_from_h, seed_resize_from_w=p.seed_resize_from_w,
        eta_noise_seed_delta=p.eta_noise_seed_delta if info.uses_ensd else 0,
    )
    noise0 = rng.next()  # NCHW, the layout the seeds encode
    sigmas = get_sigmas(_auto_schedule(p.sampler_name, p.scheduler), p.steps, engine.predictor)
    n_steps = len(sigmas) - 1
    step_noise = _prepare_noise(p, rng, info, n_steps, engine.device)
    x = torch.from_numpy(engine.predictor.noise_scaling(
        np.float32(sigmas[0]), noise0, np.zeros_like(noise0))).to(engine.device)
    timings["noise"] = timings.get("noise", 0.0) + time.perf_counter() - t_noise

    t1 = time.perf_counter()
    apply_model = cfg_mod.make_apply_model(engine.unet_apply_fn(), engine.loaded.unet,
                                           engine.predictor, engine.compute_dtype)
    model_fn = cfg_mod.make_cfg_model_fn(apply_model, cond,
                                         None if p.cfg_scale == 1.0 else uncond, p.cfg_scale)
    params = inspect.signature(info.fn).parameters
    kwargs = {name: value for name, value in
              (("eta", p.eta), ("s_noise", p.s_noise), ("s_churn", p.s_churn))
              if name in params}
    latent = info.fn(model_fn, x, sigmas, step_noise, **kwargs)
    if latent.is_cuda:
        torch.cuda.synchronize(latent.device)
    timings["sample"] = timings.get("sample", 0.0) + time.perf_counter() - t1

    t2 = time.perf_counter()
    img, lat_ok, img_ok = engine.decode_to_uint8_checked(latent)
    out = img.cpu().numpy()
    if not lat_ok:
        raise_nans("unet")
    if not img_ok:
        raise_nans("vae")
    timings["decode"] = timings.get("decode", 0.0) + time.perf_counter() - t2
    return out


@torch.no_grad()
def process_images(engine: DiffusionEngine, p: Processing) -> Processed:
    t0 = time.perf_counter()
    _resolve_seeds(p)
    _check_prompt(p, p.prompt)
    _check_prompt(p, p.negative_prompt)
    engine.set_clip_skip(p.clip_skip)
    timings: Dict[str, float] = {}
    images: List[np.ndarray] = []
    te = engine.text_engines.get("clip_l")
    for it in range(p.n_iter):
        seeds = p.all_seeds[it * p.batch_size:(it + 1) * p.batch_size]
        subseeds = p.all_subseeds[it * p.batch_size:(it + 1) * p.batch_size]
        prompts = [p.prompt] * p.batch_size
        negs = [p.negative_prompt] * p.batch_size

        tc = time.perf_counter()
        max_chunks = (1 if te is None else
                      max(te.tokenize_batch(prompts)[1], te.tokenize_batch(negs)[1]))
        cond = engine.get_learned_conditioning(prompts, p.width, p.height, max_chunks=max_chunks)
        uncond = engine.get_learned_conditioning(negs, p.width, p.height, max_chunks=max_chunks)
        if engine.family == "flux":
            g = torch.full((p.batch_size,), float(p.distilled_cfg_scale),
                           dtype=torch.float32, device=engine.device)
            cond = dict(cond, guidance=g)
            uncond = dict(uncond, guidance=g)
        timings["cond"] = timings.get("cond", 0.0) + time.perf_counter() - tc

        batch = _sample_txt2img(engine, p, seeds, subseeds, cond, uncond, timings)
        images.extend(batch[b] for b in range(len(batch)))
    timings["total"] = time.perf_counter() - t0
    return Processed(images=images, seeds=list(p.all_seeds), subseeds=list(p.all_subseeds),
                     timings=timings)

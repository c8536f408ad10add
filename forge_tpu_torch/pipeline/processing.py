"""txt2img and img2img processing (port of forge_tpu/pipeline/processing.py:
the txt2img slice, img2img, inpainting and "only masked" inpainting, UNet
hooks, MultiDiffusion tiling, the SDXL refiner's two-pass switch and the
hires fix).

resolve seeds → `<lora:...>` tags patch the UNet and text encoders for the
request (pipeline/extra_networks.py, from `engine.lora_registry`) → encode
cond and uncond with a shared chunk count → host Philox noise → the
sampler's step loop on the CFG-batched latent → VAE decode with the NaN
checks → uint8 images. SDXL's conditioning embeds the image's width and
height in `y`. Flux adds the distilled-CFG guidance scale to both
conditionings and samples 16-channel latents; at CFG 1 the uncond branch is
skipped, as for every family.

img2img encodes the init images (resized by `resize_mode`) with the VAE and
samples the tail of the schedule that `denoising_strength` keeps from noise
scaled over that latent; with an `inpaint_mask` the sampler's x0 is blended
with the init latent under the mask taken to latent size, and the decoded
image is pasted into the init image under the blurred mask. `controlnets`
(models/controlnet.py `ControlNetState`s) run beside the UNet at each step;
`unet_hooks` is the UNet's attention hook manifest (models/unet.py; the
IP-Adapter's, pipeline/ipadapter.py); `tiled_diffusion` ({"tile", "overlap"}
in latent pixels) denoises the latent tile by tile (sampling/tiled.py).
The reference's options `initial_noise_multiplier`, `img2img_extra_noise`
and color correction take their defaults (1.0, 0, off).

txt2img only, as in the reference: with `refiner_switch_at` in (0, 1) and a
refiner (`refiner_checkpoint` through `ENGINE_RESOLVER`, or the engine set
as `p._refiner_engine`), the base engine samples σ[:k+1] with k =
clamp(round(switch_at·n), 1, n − 1), and the refiner continues σ[k:] from
that latent with the step noise from k on, its own conds and a fresh
multistep history, then decodes. With `enable_hr` the hires fix follows: the
latent is upscaled in latent space ("Latent", "Latent (bicubic)", "Latent
(nearest)", … with `jax.image.resize`'s weights, ops/resize.py) or decoded,
upscaled in pixels (pipeline/upscalers.py: Lanczos, Nearest, an ESRGAN) and
encoded again, then sampled as an img2img pass over the last
hr_denoising_strength of a `hr_second_pass_steps` schedule, with noise from
a fresh ImageRNG at the hires size and the same seeds, on the base engine
or `hr_checkpoint_name`'s (`p._hr_engine`), at `hr_cfg_scale`, with conds
encoded again for `hr_prompt` or another engine; that engine decodes. The
reference's options `hires_fix_refiner_pass` and the refiner's aesthetic
scores are not read by it either: the refiner runs in the first pass only,
at scores 6.0 and 2.5.

A batch goes through four stages, which the serving pipeline
(runtime/serving.py) runs on three threads: `prepare` (seeds, LoRA, cond,
noise or the init latent), `denoise` (the sampler's loop, enqueued on the
card), `engine.decode_dispatch` / `engine.decode_finish` (the decode and its
copy to the host, the NaN checks) and `finish` (the inpaint composite or
paste). `process_images` runs them in turn, with the refiner's switch
inside `sample` and `hires_pass` between the denoise and the decode.

`Processing` takes only the fields this port reads. Any other field of the
reference's request (scripts, styles, soft inpainting, ...) raises
NotImplementedError rather than being ignored, as do prompt features not
ported yet: `[from:to:when]` editing and `AND` composition.
"""

from __future__ import annotations

import dataclasses
import inspect
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.image_rng import ImageRNG
from ..ops.resize import resize
from ..sampling import cfg as cfg_mod
from ..sampling.samplers import get_sampler
from ..sampling.schedules import get_sigmas
from ..sampling.tiled import make_tiled_apply
from ..text.schedule import get_schedule, split_composable
from .engine import DiffusionEngine
from .extra_networks import activate, parse_prompt
from .images import resize_init_image
from .masking import expand_crop_region, get_crop_region, resize_image

TILED_DIFFUSION_KEYS = ("tile", "overlap")  # the reference's defaults: 96 and 32


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
    initial_noise_multiplier: float = 1.0
    # img2img
    init_images: Optional[List[np.ndarray]] = None  # [H,W,3] uint8 or float in [0, 1]
    resize_mode: int = 0  # 0 just resize, 1 crop and resize, 2 resize and fill, 3 latent
    denoising_strength: float = 0.75
    inpaint_mask: Optional[np.ndarray] = None  # [H,W] float 0..1 (or 0..255), 1 = repaint
    mask_blur: float = 4.0
    inpainting_fill: str = "original"  # fill | original | latent_noise | latent_nothing
    inpaint_full_res: bool = False
    inpaint_full_res_padding: int = 32
    inpainting_mask_invert: bool = False
    controlnets: Optional[List[Any]] = None  # models.controlnet.ControlNetState
    unet_hooks: Optional[Dict[str, Any]] = None  # models/unet.py's attention hook manifest
    tiled_diffusion: Optional[Dict[str, int]] = None  # MultiDiffusion {"tile", "overlap"}
    # hires fix (txt2img)
    enable_hr: bool = False
    hr_scale: float = 2.0
    hr_resize_x: int = 0  # an explicit target size overrides hr_scale
    hr_resize_y: int = 0
    hr_second_pass_steps: int = 0  # 0: steps
    hr_upscaler: str = "Latent"
    hr_denoising_strength: float = 0.7
    hr_checkpoint_name: Optional[str] = None  # another checkpoint for the hires pass
    hr_prompt: str = ""  # "": the first pass's prompts and conds
    hr_negative_prompt: str = ""
    hr_cfg_scale: float = 0.0  # 0: cfg_scale
    # the SDXL refiner's two-pass switch (txt2img)
    refiner_checkpoint: Optional[str] = None
    refiner_switch_at: float = 0.0

    def __setattr__(self, name, value):
        if name not in _FIELDS and name not in _ENGINE_ATTRS:
            raise NotImplementedError(
                f"Processing.{name} is not ported to forge_tpu_torch yet")
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
# engines a caller (or a test) hands the request directly, ahead of ENGINE_RESOLVER
_ENGINE_ATTRS = frozenset(("_hr_engine", "_refiner_engine"))


@dataclasses.dataclass
class Processed:
    images: List[np.ndarray]  # uint8 HWC
    seeds: List[int]
    subseeds: List[int]
    timings: Dict[str, float]


@dataclasses.dataclass
class Job:
    """One batch of a request between the stages: what `prepare` made for
    the sampler, and how `finish` turns the decoded batch into images."""
    p: Processing  # the request the sampler runs ("only masked": its crop)
    x: torch.Tensor  # the noised starting latent, NCHW
    sigmas: np.ndarray
    step_noise: Optional[torch.Tensor]
    cond: Dict[str, torch.Tensor]
    uncond: Dict[str, torch.Tensor]
    unet_params: Any
    mask: Optional[torch.Tensor] = None  # inpainting: the latent mask, 1 = repaint
    init_latent: Optional[torch.Tensor] = None
    paste: Optional[Callable[[np.ndarray], List[np.ndarray]]] = None
    seeds: Optional[List[int]] = None  # the batch's seeds and subseeds (the hires noise)
    subseeds: Optional[List[int]] = None


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
    """`text` with its extra-network tags stripped."""
    if len(split_composable(text)) > 1 or len(get_schedule(text, p.steps)) > 1:
        raise NotImplementedError(
            f"prompt editing / AND composition in {text!r} is not ported yet")


def _auto_schedule(sampler_name: str, scheduler: str) -> str:
    if scheduler and scheduler != "automatic":
        return scheduler
    return "karras" if "Karras" in sampler_name else "normal"


def _add_time(timings: Dict[str, float], key: str, since: float) -> None:
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - since


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


def _image_rng(p: Processing, info, shape, seeds, subseeds) -> ImageRNG:
    return ImageRNG(
        shape, seeds, subseeds=subseeds, subseed_strength=p.subseed_strength,
        seed_resize_from_h=p.seed_resize_from_h, seed_resize_from_w=p.seed_resize_from_w,
        eta_noise_seed_delta=p.eta_noise_seed_delta if info.uses_ensd else 0)


def _conditioning(engine: DiffusionEngine, p: Processing, timings: Dict[str, float]):
    """LoRA activation, then cond and uncond with a shared chunk count →
    (cond, uncond, the UNet params the LoRAs patched)."""
    tl = time.perf_counter()
    prompts, unet_params, patched_tes = activate(engine, [p.prompt] * p.batch_size,
                                                 registry=engine.lora_registry)
    negs = [parse_prompt(p.negative_prompt)[0]] * p.batch_size
    _check_prompt(p, prompts[0])
    _check_prompt(p, negs[0])
    _add_time(timings, "lora", tl)

    tc = time.perf_counter()
    te = engine.text_engines.get("clip_l")
    orig_te = {name: engine.text_engines[name].params for name in patched_tes}
    try:
        for name, params in patched_tes.items():
            engine.text_engines[name].params = params
        max_chunks = (1 if te is None else
                      max(te.tokenize_batch(prompts)[1], te.tokenize_batch(negs)[1]))
        cond = engine.get_learned_conditioning(prompts, p.width, p.height, max_chunks=max_chunks)
        uncond = engine.get_learned_conditioning(negs, p.width, p.height, max_chunks=max_chunks)
    finally:
        for name, params in orig_te.items():
            engine.text_engines[name].params = params
    if engine.family == "flux":
        g = torch.full((p.batch_size,), float(p.distilled_cfg_scale),
                       dtype=torch.float32, device=engine.device)
        cond = dict(cond, guidance=g)
        uncond = dict(uncond, guidance=g)
    _add_time(timings, "cond", tc)
    return cond, uncond, unet_params


def _prep_txt2img(engine: DiffusionEngine, p: Processing, seeds, subseeds, cond, uncond,
                  unet_params, timings: Dict[str, float]) -> Job:
    t_noise = time.perf_counter()
    info = get_sampler(p.sampler_name)
    lc = engine.latent_format.latent_channels
    rng = _image_rng(p, info, (lc, p.height // 8, p.width // 8), seeds, subseeds)
    noise0 = rng.next()  # NCHW, the layout the seeds encode
    sigmas = get_sigmas(_auto_schedule(p.sampler_name, p.scheduler), p.steps, engine.predictor)
    step_noise = _prepare_noise(p, rng, info, len(sigmas) - 1, engine.device)
    x = torch.from_numpy(engine.predictor.noise_scaling(
        np.float32(sigmas[0]), noise0, np.zeros_like(noise0))).to(engine.device)
    _add_time(timings, "noise", t_noise)
    return Job(p, x, sigmas, step_noise, cond, uncond, unet_params)


def _gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """scipy's gaussian_filter over every axis, as the reference blurs."""
    if radius <= 0:
        return img
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma=radius)


def _unit_mask(p: Processing) -> np.ndarray:
    """The inpaint mask as float32 in [0, 1], inverted if asked."""
    m = np.asarray(p.inpaint_mask, np.float32)
    if m.max() > 1.5:
        m = m / 255.0
    return 1.0 - m if p.inpainting_mask_invert else m


def _encode(engine: DiffusionEngine, images: np.ndarray) -> torch.Tensor:
    """[B,H,W,3] float in [-1, 1] → regulated f32 latent [B,C,H/8,W/8] on the device."""
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    return engine.encode_first_stage(x)


def _prep_img2img(engine: DiffusionEngine, p: Processing, seeds, subseeds, cond, uncond,
                  unet_params, timings: Dict[str, float]) -> Job:
    t_encode = time.perf_counter()
    info = get_sampler(p.sampler_name)
    lc = engine.latent_format.latent_channels
    h8, w8 = p.height // 8, p.width // 8
    imgs = []
    for im in p.init_images:
        arr = np.asarray(im)
        if arr.shape[:2] != (p.height, p.width) and p.resize_mode != 3:
            arr = resize_init_image(arr, p.width, p.height, mode=p.resize_mode)
        arr = arr.astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        imgs.append(arr * 2.0 - 1.0)
    batch = np.stack([imgs[min(i, len(imgs) - 1)] for i in range(p.batch_size)])
    init_latent = _encode(engine, batch)
    if p.resize_mode == 3 and tuple(init_latent.shape[2:]) != (h8, w8):
        # 'Just resize (latent upscale)': bilinear in latent space, no antialias
        init_latent = resize(init_latent, (h8, w8), "bilinear", antialias=False)

    mask_latent = None
    if p.inpaint_mask is not None:
        m8 = resize(_gaussian_blur(_unit_mask(p), p.mask_blur), (h8, w8))
        mask_latent = torch.from_numpy(np.clip(m8, 0, 1)[None, None]).to(engine.device)
        if p.inpainting_fill == "fill":
            fill_latent = _encode(engine, _gaussian_blur(batch, 10.0))
            init_latent = init_latent * (1 - mask_latent) + fill_latent * mask_latent
        elif p.inpainting_fill == "latent_nothing":
            init_latent = init_latent * (1 - mask_latent)
    _add_time(timings, "encode", t_encode)

    t_noise = time.perf_counter()
    rng = _image_rng(p, info, (lc, h8, w8), seeds, subseeds)
    noise0 = torch.from_numpy(rng.next()).to(engine.device)
    # the schedule's tail (reference setup_img2img_steps, sd_samplers_common.py:24)
    steps = p.steps
    t_enc = min(int(p.denoising_strength * steps), steps - 1)
    full_sigmas = get_sigmas(_auto_schedule(p.sampler_name, p.scheduler), steps,
                             engine.predictor)
    sigmas = full_sigmas[steps - t_enc - 1:]
    step_noise = _prepare_noise(p, rng, info, len(sigmas) - 1, engine.device)
    if p.inpainting_fill == "latent_noise" and mask_latent is not None:
        init_latent = init_latent + noise0 * mask_latent * float(sigmas[0])
    if p.initial_noise_multiplier != 1.0:
        noise0 = noise0 * p.initial_noise_multiplier
    x = engine.predictor.noise_scaling(float(np.float32(sigmas[0])), noise0, init_latent)
    _add_time(timings, "noise", t_noise)
    job = Job(p, x, sigmas, step_noise, cond, uncond, unet_params, mask=mask_latent,
              init_latent=init_latent)
    if p.inpaint_mask is not None:
        inits = p.init_images
        job.paste = lambda batch: [_composite_inpaint(p, batch[b], inits[min(b, len(inits) - 1)])
                                   for b in range(len(batch))]
    return job


def _prep_inpaint_full_res(engine: DiffusionEngine, p: Processing, seeds, subseeds, cond,
                           uncond, unet_params, timings: Dict[str, float]) -> Job:
    """'Only masked' inpainting (reference processing.py:1684-1842 and
    masking.py): crop around the mask, inpaint the crop at the processing
    size, paste it back scaled under the blurred mask. An empty mask falls
    back to whole-image inpainting."""
    mask = _unit_mask(p)
    orig = np.asarray(p.init_images[0])
    ih, iw = orig.shape[:2]
    region = get_crop_region((mask > 0.5).astype(np.float32), p.inpaint_full_res_padding)
    if region is None:
        q = dataclasses.replace(p, inpaint_full_res=False)
        return _prep_img2img(engine, q, seeds, subseeds, cond, uncond, unet_params, timings)
    x1, y1, x2, y2 = expand_crop_region(region, p.width, p.height, iw, ih)
    crop_mask = mask[y1:y2, x1:x2]
    crop_rs = resize_image(orig[y1:y2, x1:x2], p.width, p.height)
    mask_rs = resize_image((crop_mask * 255).astype(np.uint8), p.width,
                           p.height).astype(np.float32) / 255.0
    # the crop's mask is already inverted where asked: the reference's inner
    # call inverts it a second time (processing.py:1619), which is not kept
    q = dataclasses.replace(p, inpaint_full_res=False, inpainting_mask_invert=False,
                            init_images=[crop_rs], inpaint_mask=mask_rs)
    job = _prep_img2img(engine, q, seeds, subseeds, cond, uncond, unet_params, timings)
    m = np.clip(_gaussian_blur(crop_mask, p.mask_blur), 0, 1)[..., None]

    def paste(batch: np.ndarray) -> List[np.ndarray]:
        results = []
        for b in range(batch.shape[0]):
            gen = resize_image(batch[b], x2 - x1, y2 - y1)
            full = orig.astype(np.float32).copy()
            full[y1:y2, x1:x2] = full[y1:y2, x1:x2] * (1 - m) + gen.astype(np.float32) * m
            results.append(np.clip(full, 0, 255).astype(np.uint8))
        return results

    job.paste = paste
    return job


def _composite_inpaint(p: Processing, generated: np.ndarray, original) -> np.ndarray:
    """Paste generated pixels into the original under the blurred mask."""
    orig = np.asarray(original).astype(np.float32)
    if orig.max() <= 1.5:
        orig = orig * 255.0
    m = np.clip(_gaussian_blur(_unit_mask(p), p.mask_blur), 0, 1)[..., None]
    out = orig * (1 - m) + generated.astype(np.float32) * m
    return np.clip(out, 0, 255).astype(np.uint8)


def prepare(engine: DiffusionEngine, p: Processing, it: int,
            timings: Dict[str, float]) -> Job:
    """The prep stage of batch `it` of a request whose seeds are resolved:
    LoRA activation, cond and uncond, then the starting latent (noise, or
    the encoded init images under noise)."""
    seeds = p.all_seeds[it * p.batch_size:(it + 1) * p.batch_size]
    subseeds = p.all_subseeds[it * p.batch_size:(it + 1) * p.batch_size]
    engine.set_clip_skip(p.clip_skip)
    cond, uncond, unet_params = _conditioning(engine, p, timings)
    args = (engine, p, seeds, subseeds, cond, uncond, unet_params, timings)
    if p.init_images is None:
        job = _prep_txt2img(*args)
    elif p.inpaint_full_res and p.inpaint_mask is not None:
        job = _prep_inpaint_full_res(*args)
    else:
        job = _prep_img2img(*args)
    job.seeds, job.subseeds = seeds, subseeds
    return job


def _tiled(apply_model: Callable, spec: Dict[str, int], x: torch.Tensor) -> Callable:
    unknown = sorted(set(spec) - set(TILED_DIFFUSION_KEYS))
    if unknown:
        raise NotImplementedError(f"tiled_diffusion keys {unknown} are not ported yet "
                                  f"(ported: {TILED_DIFFUSION_KEYS})")
    return make_tiled_apply(apply_model, x.shape[2], x.shape[3], tile=int(spec.get("tile", 96)),
                            overlap=int(spec.get("overlap", 32)))


def denoise(engine: DiffusionEngine, job: Job) -> torch.Tensor:
    """The denoise stage: the sampler's step loop from job.x over its σ,
    enqueued on the engine's device (no wait for the card) → the latent."""
    p = job.p
    info = get_sampler(p.sampler_name)
    net = engine.unet_apply_fn(hooks=p.unet_hooks, controlnets=p.controlnets)
    apply_model = cfg_mod.make_apply_model(net, job.unet_params, engine.predictor,
                                           engine.compute_dtype)
    if p.tiled_diffusion:  # inside CFG: every tile's forward sees the CFG batch
        apply_model = _tiled(apply_model, p.tiled_diffusion, job.x)
    model_fn = cfg_mod.make_cfg_model_fn(apply_model, job.cond,
                                         None if p.cfg_scale == 1.0 else job.uncond, p.cfg_scale)
    if job.mask is not None:
        model_fn = cfg_mod.make_masked_model_fn(model_fn, job.mask, job.init_latent)
    params = inspect.signature(info.fn).parameters
    kwargs = {name: value for name, value in
              (("eta", p.eta), ("s_noise", p.s_noise), ("s_churn", p.s_churn))
              if name in params}
    return info.fn(model_fn, job.x, job.sigmas, job.step_noise, **kwargs)


def finish(job: Job, batch: np.ndarray) -> List[np.ndarray]:
    """The finish stage: decoded uint8 [B,H,W,3] → the request's images."""
    return job.paste(batch) if job.paste is not None else list(batch)


# checkpoint name → DiffusionEngine, installed by whoever holds the engines;
# p._refiner_engine and p._hr_engine take precedence
ENGINE_RESOLVER: Optional[Callable[[str], DiffusionEngine]] = None


def _resolve_engine(p: Processing, name: Optional[str], attr: str) -> DiffusionEngine:
    eng = getattr(p, attr, None)
    if eng is not None:
        return eng
    if name and ENGINE_RESOLVER is not None:
        return ENGINE_RESOLVER(name)
    raise ValueError(f"cannot resolve checkpoint {name!r}: no engine resolver installed")


def _encode_base_conds(engine: DiffusionEngine, p: Processing, prompt: str, negative: str):
    """cond and uncond from another engine's text stack (the refiner's, the
    hires checkpoint's) or for the hires prompts: the prompts with their
    extra-network tags stripped, each at its own chunk count."""
    prompt, negative = parse_prompt(prompt)[0], parse_prompt(negative)[0]
    _check_prompt(p, prompt)
    _check_prompt(p, negative)
    b = p.batch_size
    cond = engine.get_learned_conditioning([prompt] * b, p.width, p.height)
    uncond = engine.get_learned_conditioning([negative] * b, p.width, p.height, is_negative=True)
    return cond, uncond


def _refiner_step(p: Processing, n_steps: int) -> Optional[int]:
    """The step the refiner takes over at, or None for no refiner."""
    switch_at = float(p.refiner_switch_at or 0.0)
    if not (0.0 < switch_at < 1.0 and (p.refiner_checkpoint
                                       or getattr(p, "_refiner_engine", None) is not None)):
        return None
    return max(1, min(n_steps - 1, int(round(switch_at * n_steps))))


def sample(engine: DiffusionEngine, job: Job, timings: Dict[str, float]):
    """`denoise`, with the refiner's two-pass switch where a txt2img request
    asks for it → (latent, the engine that decodes it)."""
    p = job.p
    k = _refiner_step(p, len(job.sigmas) - 1) if p.init_images is None else None
    if k is None:
        return denoise(engine, job), engine
    noise = job.step_noise
    latent = denoise(engine, dataclasses.replace(
        job, sigmas=job.sigmas[:k + 1], step_noise=None if noise is None else noise[:k]))
    refiner = _resolve_engine(p, p.refiner_checkpoint, "_refiner_engine")
    t = time.perf_counter()
    rcond, runcond = _encode_base_conds(refiner, p, p.prompt, p.negative_prompt)
    _add_time(timings, "refiner_cond", t)
    latent = denoise(refiner, Job(p, latent, job.sigmas[k:],
                                  None if noise is None else noise[k:], rcond, runcond,
                                  refiner.loaded.unet))
    return latent, refiner


def _hr_target(p: Processing) -> Optional[Tuple[int, int]]:
    """An explicit hires size (latent units), overriding hr_scale."""
    if p.hr_resize_x > 0 and p.hr_resize_y > 0:
        return (p.hr_resize_y // 8, p.hr_resize_x // 8)
    return None


def _latent_upscale(latent: torch.Tensor, scale: float,
                    target: Optional[Tuple[int, int]] = None,
                    mode: str = "Latent") -> torch.Tensor:
    """The latent modes: "Latent" bilinear, "(bicubic)" bicubic, "(nearest)"
    and "(nearest-exact)" nearest, "antialiased" in the name turning the
    antialias on, all as `jax.image.resize` computes them."""
    h, w = latent.shape[2:]
    size = target if target else (int(h * scale), int(w * scale))
    method = "bicubic" if "bicubic" in mode else "nearest" if "nearest" in mode else "bilinear"
    return resize(latent, size, method, antialias="antialiased" in mode)


def hires_pass(engine: DiffusionEngine, job: Job, latent: torch.Tensor,
               timings: Dict[str, float]):
    """The hires fix's second pass over the first pass's latent → (latent,
    the engine that sampled it and decodes it)."""
    p = job.p
    hr_engine, cond, uncond, unet_params = engine, job.cond, job.uncond, job.unet_params
    reencode = bool(p.hr_prompt or p.hr_negative_prompt)
    if p.hr_checkpoint_name or getattr(p, "_hr_engine", None) is not None:
        hr_engine = _resolve_engine(p, p.hr_checkpoint_name, "_hr_engine")
        unet_params, reencode = hr_engine.loaded.unet, True
    if reencode:
        t = time.perf_counter()
        cond, uncond = _encode_base_conds(hr_engine, p, p.hr_prompt or p.prompt,
                                          p.hr_negative_prompt or p.negative_prompt)
        _add_time(timings, "hires_cond", t)

    t = time.perf_counter()
    target = _hr_target(p)
    if p.hr_upscaler and not p.hr_upscaler.startswith("Latent"):
        from .upscalers import get_default_registry

        registry = hr_engine.upscalers or get_default_registry()
        imgs = hr_engine.decode_finish(hr_engine.decode_dispatch(latent))
        scale = (target[0] * 8 / imgs.shape[1]) if target else p.hr_scale
        upscaler = registry.get(p.hr_upscaler)
        ups = np.stack([np.asarray(upscaler.upscale(img, scale)) for img in imgs])
        ups = ups.astype(np.float32) / 255.0 * 2.0 - 1.0
        if target and ups.shape[1:3] != (target[0] * 8, target[1] * 8):
            ups = resize(ups.transpose(0, 3, 1, 2), (target[0] * 8, target[1] * 8)
                         ).transpose(0, 2, 3, 1)
        _add_time(timings, "hires_upscale", t)
        t = time.perf_counter()
        latent = _encode(hr_engine, ups)
        _add_time(timings, "hires_encode", t)
    else:
        latent = _latent_upscale(latent, p.hr_scale, target, p.hr_upscaler or "Latent")
        _add_time(timings, "hires_upscale", t)

    # an img2img pass over the schedule's tail (reference setup_img2img_steps)
    t = time.perf_counter()
    info = get_sampler(p.sampler_name)
    _, lc, h8, w8 = latent.shape
    steps = p.hr_second_pass_steps or p.steps
    full_sigmas = get_sigmas(_auto_schedule(p.sampler_name, p.scheduler), steps,
                             hr_engine.predictor)
    t_enc = min(int(p.hr_denoising_strength * steps), steps - 1)
    sigmas = full_sigmas[steps - t_enc - 1:]
    rng = ImageRNG((lc, h8, w8), job.seeds, subseeds=job.subseeds,
                   subseed_strength=p.subseed_strength)
    noise0 = torch.from_numpy(rng.next()).to(hr_engine.device)
    step_noise = _prepare_noise(p, rng, info, len(sigmas) - 1, hr_engine.device)
    x = hr_engine.predictor.noise_scaling(float(np.float32(sigmas[0])), noise0, latent.float())
    q = dataclasses.replace(p, cfg_scale=p.hr_cfg_scale or p.cfg_scale)
    latent = denoise(hr_engine, Job(q, x, sigmas, step_noise, cond, uncond, unet_params))
    if latent.is_cuda:
        torch.cuda.synchronize(latent.device)
    _add_time(timings, "hires_sample", t)
    return latent, hr_engine


@torch.no_grad()
def process_images(engine: DiffusionEngine, p: Processing) -> Processed:
    t0 = time.perf_counter()
    _resolve_seeds(p)
    timings: Dict[str, float] = {}
    images: List[np.ndarray] = []
    for it in range(p.n_iter):
        job = prepare(engine, p, it, timings)
        t1 = time.perf_counter()
        latent, out_engine = sample(engine, job, timings)
        if latent.is_cuda:  # for the phase's time only; the decode would wait as well
            torch.cuda.synchronize(latent.device)
        _add_time(timings, "sample", t1)
        if p.enable_hr and p.init_images is None:
            latent, out_engine = hires_pass(engine, job, latent, timings)
        t2 = time.perf_counter()
        batch = out_engine.decode_finish(out_engine.decode_dispatch(latent))
        _add_time(timings, "decode", t2)
        images.extend(finish(job, batch))
    timings["total"] = time.perf_counter() - t0
    return Processed(images=images, seeds=list(p.all_seeds), subseeds=list(p.all_subseeds),
                     timings=timings)

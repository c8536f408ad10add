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
conditionings and samples 16-channel latents; Chroma gets the same
guidance entry, which its network does not read, and samples under real
CFG with the negative prompt; SD3 samples 16-channel latents under real CFG; Playground v2.5's latents go through its channel
format. At CFG 1 the uncond branch is skipped, as for every family.

img2img encodes the init images (resized by `resize_mode`) with the VAE and
samples the tail of the schedule that `denoising_strength` keeps from noise
scaled over that latent; with an `inpaint_mask` the sampler's x0 is blended
with the init latent under the mask taken to latent size, and the decoded
image is pasted into the init image under the blurred mask. `controlnets`
(models/controlnet.py `ControlNetState`s) run beside the UNet at each step;
`unet_hooks` is the UNet's attention hook manifest (models/unet.py; the
IP-Adapter's, pipeline/ipadapter.py); `tiled_diffusion` ({"tile", "overlap"}
in latent pixels) denoises the latent tile by tile (sampling/tiled.py).
The options `img2img_extra_noise` (noise0 · extra noise added after the
noise scaling, the "Extra noise" infotext key) and `img2img_color_correction`
(each image histogram-matched in LAB to its init image in `finish`, before
the inpaint composite; pipeline/images.py) act as in the reference. With
`soft_inpainting` (extensions/soft_inpainting.py) the per-step composite is
the σ-scheduled soft blend instead of the hard one.

Options (runtime/options.py) fill the sampler parameters a request leaves
at their defaults, as the reference's `_apply_option_defaults` does once the
seeds resolve: `s_churn`, `s_noise`, `eta` (`eta_ancestral`), `eta_ddim`,
the ENSD, clip skip and, for img2img, the initial noise multiplier. The
sampler's `SamplerInfo` picks its noise (a Philox stream, or a Brownian
tree per seed over the σ the pass runs for the SDE samplers), whether the
penultimate σ is dropped, the eta it takes (`eta_ddim` for the timestep
samplers) and, for CFG++, the scale's multiplier and the uncond pair.

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
card), `decode_dispatch` / `engine.decode_finish` (the decode the plan and
options pick, its copy to the host, the NaN checks) and `finish` (the inpaint composite or
paste). `process_images` runs them in turn, with the refiner's switch
inside `sample` and `hires_pass` between the denoise and the decode.

The prompt surface: styles (runtime/styles.py) expand into the prompts once,
up front; `[from:to:when]` editing encodes each variant once and stacks them
into per-step conds (sampling/cfg.py `PerStep`) that the step loop selects
by the host σ; `AND` parts and `regional_prompts` ({prompt, weight, area
[x, y, w, h] fractions or mask [H, W], mask_strength, feather}) add cond
branches to the one batched UNet call, the regions blended by multiplier
maps at latent size; textual-inversion trigger words take their vectors in
the text engines (text/textual_inversion.py). cond, uncond and the AND
branches are cached per engine for the last four distinct requests
(`_cond_cache_key`). `cfg_rescale` rescales the CFG result. NGMS (the
`s_min_uncond` option) samples the txt2img pass's σ below the threshold
without the uncond branch; its per-step conds still select by the σ's
position in the whole pass (the reference restarts them at the split).
Every image gets an infotext (pipeline/infotext.py) in `Processed.infotexts`,
and `params.txt` the first one under the `save_write_params_txt` option.

The memory plan (runtime/memory.py `plan_generation`) is made as the request
starts, on the engine's device: it chunks the batch (the chunk divides the
batch, so the seeds keep their layout) and decides whether the VAE runs in
tiles, which the `vae_always_tiled` option forces; a tiled plan tiles the
img2img encode too. `sd_vae_decode_method` "TAESD" decodes with the family's
TAESD weights where they are found and with the full VAE where not;
`Processed.decode_method` says which ran.

The sampler's model calls tick the job state (runtime/state.py): each call
advances `state.sampling_step`, and while a job runs (the API's
`state.begin`) every `show_progress_every_n_steps` calls under
`live_previews_enable` the call's x0 is decoded by `show_progress_type`
("Approx cheap", "Approx NN", "TAESD", "Full") into `state.current_image`.
A preview copies x0 to the host and so waits for the card. While a job runs,
the step loop ends at the next step boundary once `state.interrupted` (the
request: the partial latent decodes, no hires pass follows and no further
batch starts) or `state.skipped` (this batch) is set.

The extension surface: `unet_hooks` is the UNet's hook manifest, its
attention and block slots (models/unet.py; the port's hooks see NCHW where
the reference's see NHWC), and `pre_cfg_hooks`, `post_cfg_hooks` and
`cfg_combine_hook` the CFG hook layer (sampling/cfg.py). A
`cfg_combine_hook` with a `build(sigmas, predictor=)` method (dynamic
thresholding's and the latent modifier's specs, extensions/) is built once a
pass against that pass's σ table and the engine's predictor, as the
reference builds it. Every pass of a request takes the hooks: the base pass,
the NGMS tail (its post hooks only) and the hires pass; the refiner's pass
with the CFG hooks or block-level hooks is refused. The extensions
(extensions/: FreeU, PAG, SAG, dynamic thresholding, latent modifier,
hypernetworks, StyleAlign, ControlLLLite, Kohya HRFix, Fooocus inpaint and
the ControlNet units) fill these fields through their `attach` or `build_*`
functions.

`hook_phases` [(end fraction, extra hooks)] splits a txt2img request's step
loop into segments (`_run_phased`, as the reference's), each with the base
`unet_hooks` merged with its phase's; NGMS does not split such a request,
the hires pass runs with the base hooks, and the refiner or img2img with
hook phases is refused (the reference drops the phases there).
`deferred_hooks` are functions fn(engine, p, cond, uncond) run once a
request, after the first batch's conds are encoded and before its starting
latent is made; they may leave `p._unet_param_override`, a per-request
copy-on-write of the UNet's weights (Fooocus inpaint's patch), and
`p._cn_inpaint`, ControlNet inpaint_only's state: its latent composite on
each pass at its latent's size that has no inpaint mask of its own, and
its final composite before the inpaint paste (after it, for "only masked";
pipeline/cn_inpaint.py).

The image-prompt family: `reference_state` (pipeline/reference_only.py,
left by a ControlNet reference unit's deferred hook) wraps the UNet apply
between the request's apply and CFG with the windowed two passes, its
recording noise drawn in `prepare`; `cond_transform` (PhotoMaker's,
pipeline/photomaker.py) rewrites each batch's cond after the cond cache,
which it bypasses; a Revision unit leaves `p._revision`
(pipeline/revision.py), applied to the conds of every batch, where the
reference rewrites the first batch's only. These take txt2img on SDXL
(reference-only on SD1.5 too), not with img2img, the hires fix, the
refiner, hook phases, AND, regional or prompt-editing conds, tiling or an
NGMS split (each refused, ROADMAP queue 1 item 6 (d)).

The script surface: `scripts` (runtime/scripts.py `ScriptRunner`) has each
hook fired where forge_tpu fires it: `setup`, `before_process` and `process`
once the request is set up, then the `before_process` event
(`process_images`); `after_extra_networks_activate` after the LoRA
activation, `before_process_batch`, `process_batch` and
`process_before_every_sampling` once the batch's conds are made, and
`before_process_init_images` before the init images are read (`prepare`);
`before_hr` (`hires_pass`); `postprocess_batch`, `postprocess_batch_list`,
`on_mask_blend`, `postprocess_image_after_composite` and `postprocess_image`
(`finish`); `postprocess` on the finished `Processed`. The `cfg_denoiser`,
`cfg_denoised` and `cfg_after_cfg` events fire once a sampling pass
(`cfg_model_fn`), and what their callbacks append to `CFGHookParams`' pre- and
post-CFG hooks runs after the request's own at every step of that pass.
`controlnet_units` holds ControlNet unit dicts for a runner's
`ControlNetScript` (extensions/controlnet.py), which attaches them in its
`process` hook.

Saving, as the reference's: under `samples_save` (on by default) and not
`do_not_save_samples`, each finished image is written with its infotext by
pipeline/images.py `save_image` into `outdir_samples`, else the txt2img or
img2img directory, firing `before_image_saved` and `image_saved`; with more
than one image, under `grid_save` and not `do_not_save_grid`, their grid
goes into the grids directory; an OSError prints and the request goes on.
The request ends with a `generation` line in the event log
(runtime/logging.py) and, under `save_write_params_txt`, the first
infotext in `params.txt`.

`restore_faces` (or the `face_restoration` option) restores each image in
`finish` with the restorer `face_restoration_model` names
(postprocessing/faces.py, gfpgan.py); with no checkpoint it raises
`RestorerMissing` (a FileNotFoundError) where the reference prints and
skips.

`Processing` takes only the fields this port reads. Any other field of the
reference's request (tiling, image_cfg_scale, ...)
raises NotImplementedError rather than being ignored, as do
combinations the reference mixes or fails on: AND or regional branches with
the refiner or on Flux and Chroma, regional masks or the base prompt's AND
branches under a hires pass that changes the latent size's masks or
re-encodes the prompt, and `AND` or `[from:to:when]` in a prompt the refiner
or a hires pass encodes itself. On SD2, Playground v2.5, SD3 and Chroma the
features `UNPORTED_BY_FAMILY` lists raise as well: ControlNets, UNet hooks
(the IP-Adapter, the extensions), the CFG hooks, hook phases, deferred
hooks, tiling, the refiner, regional prompts and the image prompts; they
take LoRA (SD3's `lora_te1_`/`lora_te2_` on CLIP-L/CLIP-G, online on a
q8_0 MMDiT's quantized leaves), the hires fix, img2img and inpainting as
every family does. On Flux the CFG hooks and hook phases raise (and, in
the engine, UNet hooks and ControlNets).
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.unet import BLOCK_HOOK_KEYS
from ..ops.image_rng import ImageRNG
from ..ops.resize import resize
from ..runtime.logging import log_event
from ..runtime.memory import Plan, plan_generation, tree_bytes
from ..runtime.options import opts
from ..runtime.scripts import CFGHookParams, callbacks, fire
from ..runtime.state import state
from ..sampling import cfg as cfg_mod
from ..sampling.brownian import brownian_step_noise
from ..sampling.samplers import get_sampler, step_gate
from ..sampling.schedules import get_sigmas
from ..sampling.tiled import make_tiled_apply
from ..text.schedule import get_schedule, split_composable
from .engine import DiffusionEngine
from .extra_networks import activate, parse_prompt
from .cn_inpaint import composite_final
from .images import (apply_color_correction, bilinear_resize, image_grid, resize_init_image,
                     save_image, setup_color_correction)
from .infotext import create_infotext, write_params_txt
from .masking import expand_crop_region, get_crop_region, resize_image
from .taesd import preview_decode, taesd_decoder, taesd_for_family

TILED_DIFFUSION_KEYS = ("tile", "overlap")  # the reference's defaults: 96 and 32
# the request features that no test holds against the reference on a family: each raises
# NotImplementedError there (SD2, Playground v2.5, SD3 and Chroma take txt2img, img2img,
# inpainting, LoRA and the hires fix)
CFG_HOOK_FIELDS = ("pre_cfg_hooks", "post_cfg_hooks", "cfg_combine_hook")
IMAGE_PROMPT_FIELDS = ("reference_state", "cond_transform")
_COMMON_UNPORTED = ("controlnets", "unet_hooks", "tiled_diffusion", "refiner",
                    "regional_prompts", "hook_phases",
                    "deferred_hooks") + CFG_HOOK_FIELDS + IMAGE_PROMPT_FIELDS
UNPORTED_BY_FAMILY = {"sd20": _COMMON_UNPORTED, "sd3": _COMMON_UNPORTED,
                      "chroma": _COMMON_UNPORTED, "playground": _COMMON_UNPORTED,
                      # the reference's Flux apply drops UNet hooks without a word, so PAG's
                      # identity pass would be a plain one
                      "flux": CFG_HOOK_FIELDS + ("hook_phases",) + IMAGE_PROMPT_FIELDS}
_ROADMAP_6D = "ROADMAP queue 1 item 6 (d), the image-prompt family"


@dataclasses.dataclass
class Processing:
    prompt: str = ""
    negative_prompt: str = ""
    styles: Optional[List[str]] = None  # style names from runtime/styles.py's `prompt_styles`
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
    eta_ddim: float = 0.0  # the timestep samplers' eta (DDIM, DDIM CFG++)
    s_churn: float = 0.0
    s_noise: float = 1.0
    clip_skip: int = 1
    eta_noise_seed_delta: int = 0
    all_seeds: Optional[List[int]] = None
    all_subseeds: Optional[List[int]] = None
    initial_noise_multiplier: float = 1.0
    cfg_rescale: float = 0.0
    # the model's name and hash for the infotext
    sd_model_name: Optional[str] = None
    sd_model_hash: Optional[str] = None
    extra_generation_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # regional prompts: {prompt, weight?, area? [x, y, w, h] fractions, mask? [H, W] 0..1,
    # mask_strength?, feather? (latent pixels)}, an area or a mask each
    regional_prompts: Optional[List[Dict[str, Any]]] = None
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
    unet_hooks: Optional[Dict[str, Any]] = None  # models/unet.py's hook manifest
    pre_cfg_hooks: Optional[List[Any]] = None  # fn(eps_c, eps_u, x, σ) → (eps_c, eps_u)
    post_cfg_hooks: Optional[List[Any]] = None  # fn(x0, eps_c, eps_u, x, σ) → x0
    cfg_combine_hook: Optional[Any] = None  # replaces the CFG combine; or a spec with .build
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
    # fn(engine, p, cond, uncond), each run once a request after the first batch's cond encode
    deferred_hooks: Optional[List[Any]] = None
    # [(end fraction, extra unet_hooks)]: the txt2img step loop split into segments
    hook_phases: Optional[List[Tuple[float, Dict[str, Any]]]] = None
    cond_transform: Optional[Any] = None  # fn(cond) → cond after the cond cache (PhotoMaker)
    reference_state: Optional[Any] = None  # pipeline/reference_only.py ReferenceState
    scripts: Optional[Any] = None  # runtime/scripts.py ScriptRunner
    soft_inpainting: Optional[Any] = None  # extensions/soft_inpainting.py SoftInpaintingSettings
    do_not_save_samples: bool = False  # under `samples_save`: no image saved
    do_not_save_grid: bool = False  # under `grid_save`: no grid saved
    # ControlNet unit dicts extensions/controlnet.py `ControlNetScript` attaches
    controlnet_units: Optional[List[Dict[str, Any]]] = None
    restore_faces: bool = False  # postprocessing/faces.py, in `finish`

    def __setattr__(self, name, value):
        if name not in _FIELDS and name not in _INTERNAL_ATTRS:
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
# engines a caller (or a test) hands the request directly, ahead of ENGINE_RESOLVER;
# the engine's family, which the infotext reads; and what deferred hooks leave: a per-request
# copy-on-write of the UNet's weights (fn(params) → params), the ControlNet inpaint_only
# state (pipeline/cn_inpaint.py) and Revision's (embeds, ignore prompt) (pipeline/revision.py)
_INTERNAL_ATTRS = frozenset(("_hr_engine", "_refiner_engine", "_engine_family", "_plan",
                             "_unet_param_override", "_cn_inpaint", "_revision"))


@dataclasses.dataclass
class Processed:
    images: List[np.ndarray]  # uint8 HWC
    seeds: List[int]
    subseeds: List[int]
    infotexts: List[str]
    params: Dict[str, Any]
    timings: Dict[str, float]
    decode_method: str = "full"  # "full", "tiled" or "TAESD", as `decode_dispatch` picked


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
    # "only masked": the decoded crops pasted back into the init image, and the request the
    # crop was made from (its scripts, init images and mask are what `finish` reads)
    uncrop: Optional[Callable[[np.ndarray], List[np.ndarray]]] = None
    request: Optional[Processing] = None
    seeds: Optional[List[int]] = None  # the batch's seeds and subseeds (the hires noise)
    subseeds: Optional[List[int]] = None
    branches: Optional[List[Dict[str, Any]]] = None  # AND parts after the first, then regions
    weights: Optional[List[float]] = None  # one a branch, the first cond's first
    masks: Optional[List[Optional[torch.Tensor]]] = None  # regional maps [1, 1, h, w] or None
    sigma_table: Optional[np.ndarray] = None  # the σ the per-step conds select by (None: sigmas)
    reference_noise: Optional[torch.Tensor] = None  # reference-only's recording noise a step


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


def _apply_option_defaults(p: Processing) -> None:
    """Sampler fields the caller left at their defaults, from the options
    (the reference's `_apply_option_defaults`): an explicit value wins."""
    if p.s_churn == 0.0:
        p.s_churn = float(opts.get("s_churn"))
    if p.s_noise == 1.0:
        p.s_noise = float(opts.get("s_noise"))
    if p.eta == 1.0:
        p.eta = float(opts.get("eta_ancestral"))
    if p.eta_ddim == 0.0:
        p.eta_ddim = float(opts.get("eta_ddim"))
    if p.eta_noise_seed_delta == 0:
        p.eta_noise_seed_delta = int(opts.get("eta_noise_seed_delta"))
    if p.clip_skip <= 1:
        p.clip_skip = int(opts.get("CLIP_stop_at_last_layers"))
    if p.init_images is not None and p.initial_noise_multiplier == 1.0:
        p.initial_noise_multiplier = float(opts.get("initial_noise_multiplier"))


def _record_generation_params(engine: DiffusionEngine, p: Processing) -> None:
    """The infotext's keys the request's options decide, in
    `p.extra_generation_params` (the sampler's eta and σ keys, the img2img
    and inpainting keys, the hires keys, the refiner's), and the model's name
    and hash where the engine has them."""
    info = get_sampler(p.sampler_name)
    eg = p.extra_generation_params
    p._engine_family = engine.family
    if p.sd_model_name is None:
        name = getattr(engine, "checkpoint_name", None)
        if name:
            p.sd_model_name = name.rsplit(".", 1)[0]
    if p.sd_model_hash is None:
        p.sd_model_hash = getattr(engine, "checkpoint_hash", None)

    if info.discard_next_to_last_sigma:
        eg["Discard penultimate sigma"] = "True"
    if info.noise_draws > 0 and info.uses_ensd and p.eta != 1.0:
        eg["Eta"] = p.eta
    if info.uses_eta_ddim and p.eta_ddim > 0:
        eg["Eta DDIM"] = p.eta_ddim
    if p.s_churn:
        eg["Sigma churn"] = p.s_churn
    if p.s_noise != 1.0:
        eg["Sigma noise"] = p.s_noise

    if p.init_images is not None:
        eg["Denoising strength"] = p.denoising_strength
        if p.inpaint_mask is not None:
            eg["Mask blur"] = p.mask_blur if p.mask_blur else None
            if p.inpainting_mask_invert:
                eg["Mask mode"] = "Inpaint not masked"
            if p.inpaint_full_res:
                eg["Inpaint area"] = "Only masked"
                eg["Masked area padding"] = p.inpaint_full_res_padding
            if p.inpainting_fill != "original":
                eg["Masked content"] = p.inpainting_fill.replace("_", " ")
        if p.initial_noise_multiplier != 1.0:
            eg["Noise multiplier"] = p.initial_noise_multiplier
    elif p.enable_hr:
        eg["Denoising strength"] = p.hr_denoising_strength
        eg["Hires upscale"] = p.hr_scale
        if p.hr_resize_x and p.hr_resize_y:
            eg["Hires resize"] = f"{p.hr_resize_x}x{p.hr_resize_y}"
        if p.hr_second_pass_steps:
            eg["Hires steps"] = p.hr_second_pass_steps
        eg["Hires upscaler"] = p.hr_upscaler
        if p.hr_checkpoint_name:
            eg["Hires checkpoint"] = p.hr_checkpoint_name
        if p.hr_prompt:
            eg["Hires prompt"] = p.hr_prompt
        if p.hr_negative_prompt:
            eg["Hires negative prompt"] = p.hr_negative_prompt
        if p.hr_cfg_scale:
            eg["Hires CFG Scale"] = p.hr_cfg_scale

    if p.refiner_checkpoint and 0.0 < p.refiner_switch_at < 1.0:
        eg["Refiner"] = p.refiner_checkpoint
        eg["Refiner switch at"] = p.refiner_switch_at


def _refuse_for_family(engine: DiffusionEngine, p: Processing) -> None:
    """Raise for a request feature `UNPORTED_BY_FAMILY` lists for the engine's family."""
    asked = {
        "refiner": bool(p.refiner_checkpoint or getattr(p, "_refiner_engine", None) is not None)
        and 0.0 < p.refiner_switch_at < 1.0,
        **{name: bool(getattr(p, name)) for name in
           ("controlnets", "unet_hooks", "tiled_diffusion", "regional_prompts",
            "hook_phases", "deferred_hooks", *CFG_HOOK_FIELDS)},
        **{name: getattr(p, name) is not None for name in IMAGE_PROMPT_FIELDS},
    }
    refused = [name for name in UNPORTED_BY_FAMILY.get(engine.family, ()) if asked[name]]
    if refused:
        raise NotImplementedError(f"{', '.join(refused)} on {engine.family} is not ported to "
                                  "forge_tpu_torch yet")


def setup(engine: DiffusionEngine, p: Processing) -> None:
    """A request's setup, once: the features its engine's family does not
    take raise, its styles expand into the prompts (the infotext records the
    styled prompts), then the seeds, the option defaults and the infotext's
    keys."""
    _refuse_for_family(engine, p)
    if p.styles:
        from ..runtime.styles import prompt_styles

        p.prompt = prompt_styles.apply_styles_to_prompt(p.prompt, p.styles)
        p.negative_prompt = prompt_styles.apply_negative_styles_to_prompt(p.negative_prompt,
                                                                          p.styles)
        if p.hr_prompt:
            p.hr_prompt = prompt_styles.apply_styles_to_prompt(p.hr_prompt, p.styles)
        if p.hr_negative_prompt:
            p.hr_negative_prompt = prompt_styles.apply_negative_styles_to_prompt(
                p.hr_negative_prompt, p.styles)
        p.styles = None  # applied once
    _resolve_seeds(p)
    _apply_option_defaults(p)
    _record_generation_params(engine, p)


def plan(engine: DiffusionEngine, p: Processing, chunk: bool = True) -> Plan:
    """The request's memory plan on the engine's device, `vae_always_tiled`
    forcing the tiled VAE, in `p._plan`; with `chunk` a chunked batch is
    applied, to the largest divisor of the batch not above the chunk."""
    pl = plan_generation(p.batch_size, p.height, p.width,
                         weight_bytes=tree_bytes(engine.loaded.unet), device=engine.device)
    if opts.get("vae_always_tiled"):
        pl.tiled_vae = True
    if chunk and 0 < pl.batch_chunk < p.batch_size:
        size = pl.batch_chunk
        while p.batch_size % size:  # the seeds keep their layout: the chunk divides the batch
            size -= 1
        if size < p.batch_size:
            p.n_iter *= p.batch_size // size
            p.batch_size = size
    p._plan = pl
    return pl


def _tiled_vae(p: Processing) -> bool:
    pl = getattr(p, "_plan", None)
    return pl is not None and pl.tiled_vae


def decode_dispatch(engine: DiffusionEngine, latent: torch.Tensor, p: Processing):
    """The decode the request's options and plan pick, enqueued (the engine's
    `decode_dispatch`) → (handle, the method that runs): "TAESD" where the
    `sd_vae_decode_method` option asks for it and the family's weights are
    found, else the full VAE, "tiled" where the plan tiles."""
    tiled = _tiled_vae(p)
    method = "tiled" if tiled else "full"
    if opts.get("sd_vae_decode_method") == "TAESD":
        params = taesd_for_family(engine.family, device=engine.device)
        if params is not None:
            return engine.decode_dispatch(latent, taesd_decoder(engine, params)), "TAESD"
        method += f" (no TAESD weights for {engine.family})"
    decode = engine.decode_first_stage_tiled if tiled else None
    return engine.decode_dispatch(latent, decode), method


def _stop_requested() -> bool:
    """The step gate: a running job was interrupted or its batch skipped."""
    return bool(state.job) and (state.interrupted or state.skipped)


def _progress_tick(engine: DiffusionEngine, x0: torch.Tensor) -> None:
    """After each model call (the reference's `_progress_tick`): advance the
    job's step and, while a job runs, refresh the live preview from x0's
    first image every `show_progress_every_n_steps` calls (≤ 0: none)."""
    with state._lock:  # the API's handler threads read it
        state.sampling_step += 1
    if not state.job or not opts.get("live_previews_enable"):
        return
    every = int(opts.get("show_progress_every_n_steps"))
    if every <= 0 or state.sampling_step % every:
        return
    try:
        state.set_current_image(preview_decode(engine, x0[:1], str(opts.get("show_progress_type")))[0])
    except Exception as e:  # noqa: BLE001 — a failed preview leaves the image as it was
        state.textinfo = f"preview failed: {e}"


def infotexts(p: Processing, seeds: List[int], subseeds: List[int]) -> List[str]:
    return [create_infotext(p, seed, sub) for seed, sub in zip(seeds, subseeds)]


def _simple_params(p: Processing) -> Dict[str, Any]:
    """The request's plain fields (scalars, strings, lists and dicts of
    them), shallow copies: never a deep copy of arrays or tensors. Not
    `controlnet_units`, which the reference sets as a plain attribute of its
    request and so does not record."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(p):
        if f.name == "controlnet_units":
            continue
        v = getattr(p, f.name)
        if v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        elif isinstance(v, (list, tuple)) and all(
                x is None or isinstance(x, (bool, int, float, str)) for x in v):
            out[f.name] = list(v)
        elif isinstance(v, dict) and all(
                x is None or isinstance(x, (bool, int, float, str)) for x in v.values()):
            out[f.name] = dict(v)
    return out


def _auto_schedule(sampler_name: str, scheduler: str) -> str:
    if scheduler and scheduler != "automatic":
        return scheduler
    return "karras" if "Karras" in sampler_name else "normal"


def _merge_hooks(base: Optional[Dict[str, Any]], extra: Dict[str, Any]) -> Dict[str, Any]:
    """Two hook manifests merged: a slot that is a tuple in both chains,
    any other slot of `extra` (an attention replace) takes the place of
    `base`'s."""
    merged = dict(base or {})
    for k, v in extra.items():
        if k in merged and isinstance(v, tuple) and isinstance(merged[k], tuple):
            merged[k] = merged[k] + v
        else:
            merged[k] = v
    return merged


def _add_time(timings: Dict[str, float], key: str, since: float) -> None:
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - since


def _prepare_noise(p: Processing, rng: ImageRNG, info, sigmas: np.ndarray, seeds,
                   device) -> Optional[torch.Tensor]:
    """Per-step sampler noise [n_steps, draws, B, C, h, w] (NCHW) on `device`
    for the pass over `sigmas`, or None for a deterministic sampler. A
    deterministic sampler turns stochastic under `s_churn` (Euler) or
    `eta_ddim` (the DDIM family). The SDE samplers' noise is a Brownian
    tree per seed over these σ, drawn as the reference draws it, (h, w, C)
    a node, then taken to NCHW; the others draw the Philox stream."""
    draws = info.noise_draws
    if draws == 0:
        if "s_churn" in inspect.signature(info.fn).parameters and p.s_churn > 0:
            draws = 1
        elif info.uses_eta_ddim and p.eta_ddim > 0:
            draws = 1
    if draws == 0:
        return None
    if info.brownian_noise:
        c, h, w = rng.shape
        noise = brownian_step_noise(np.asarray(sigmas, np.float64), (h, w, c), seeds, draws=draws)
        return torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 1, 2, 5, 3, 4))).to(device)
    steps = [np.stack([rng.next() for _ in range(draws)]) for _ in range(len(sigmas) - 1)]
    return torch.from_numpy(np.stack(steps)).to(device)


def _image_rng(p: Processing, info, shape, seeds, subseeds) -> ImageRNG:
    return ImageRNG(
        shape, seeds, subseeds=subseeds, subseed_strength=p.subseed_strength,
        seed_resize_from_h=p.seed_resize_from_h, seed_resize_from_w=p.seed_resize_from_w,
        eta_noise_seed_delta=p.eta_noise_seed_delta if info.uses_ensd else 0)


def _build_scheduled_cond(engine: DiffusionEngine, p: Processing, prompts: List[str],
                          max_chunks: Optional[int] = None, is_negative: bool = False,
                          allow_and: bool = True):
    """Encode prompts with their `[from:to:when]` schedules and `AND` parts →
    (cond, the branches after the first, their weights) — (cond, None, None)
    without AND. A scheduled prompt encodes each variant once; its cond
    values are PerStep tensors [steps, B, ...], the variant of each step."""
    def encode(texts):
        return engine.get_learned_conditioning(texts, p.width, p.height, max_chunks=max_chunks,
                                               is_negative=is_negative)

    def encode_scheduled(text):
        sched = get_schedule(text, p.steps)
        if len(sched) == 1:
            return encode([sched[0][1]] * len(prompts))
        variants = [encode([t] * len(prompts)) for _, t in sched]
        idx = np.zeros(p.steps, np.int64)
        start = 0
        for vi, (end, _) in enumerate(sched):
            idx[start:end] = vi
            start = end
        return {k: cfg_mod.PerStep(torch.stack([variants[i][k] for i in idx]))
                for k in variants[0]}

    parts = split_composable(prompts[0]) if allow_and else [(prompts[0], 1.0)]
    conds = [encode_scheduled(text) for text, _ in parts]
    if len(conds) == 1:
        return conds[0], None, None
    return conds[0], conds[1:], [w for _, w in parts]


_COND_CACHE_SIZE = 4


def _cond_cache_key(engine: DiffusionEngine, p: Processing, prompts, negs, max_chunks):
    """The cond cache's key: the engine's weights, the prompts (the raw ones
    carry the LoRA tags that patch the text encoders), steps, size, clip
    skip, the chunk count, the emphasis mode and the embeddings' version.
    Regional prompts carry masks, and a cond transform rewrites the cond: no
    cache for either."""
    if p.regional_prompts or p.cond_transform is not None:
        return None
    return (id(engine.loaded), p.prompt, p.negative_prompt, tuple(prompts), tuple(negs), p.steps,
            p.width, p.height, p.clip_skip, max_chunks, opts.get("emphasis"),
            engine.embedding_db.version)


def _cond_cache_get(engine: DiffusionEngine, key):
    cache = getattr(engine, "_cond_cache", None)
    if key is None or cache is None or key not in cache:
        return None
    cache.move_to_end(key)
    cond, uncond, branches, weights = cache[key]
    return dict(cond), dict(uncond), branches, weights


def _cond_cache_put(engine: DiffusionEngine, key, cond, uncond, branches, weights) -> None:
    if key is None:
        return
    cache = getattr(engine, "_cond_cache", None)
    if cache is None:
        cache = engine._cond_cache = collections.OrderedDict()
    cache[key] = (dict(cond), dict(uncond), branches, weights)
    while len(cache) > _COND_CACHE_SIZE:
        cache.popitem(last=False)


def _region_mult_map(spec: Dict[str, Any], lh: int, lw: int) -> np.ndarray:
    """A regional prompt's multiplier map at latent size [lh, lw]: an area
    rectangle with an 8-step (`feather`) linear ramp on every edge that does
    not touch the canvas, or a mask taken to uint8 and resized as Pillow's
    BILINEAR does, times `mask_strength`."""
    if spec.get("mask") is not None:
        mask = np.asarray(spec["mask"], np.float32)
        if mask.ndim == 3:
            mask = mask.mean(-1)
        if mask.max() > 1.5:
            mask = mask / 255.0
        img = np.clip(mask * 255, 0, 255).astype(np.uint8)
        m = bilinear_resize(img, lw, lh).astype(np.float32) / 255.0
        return m * float(spec.get("mask_strength", 1.0))
    x, y, w, h = spec.get("area", (0.0, 0.0, 1.0, 1.0))
    x0 = int(round(x * lw))
    y0 = int(round(y * lh))
    x1 = min(lw, x0 + max(1, int(round(w * lw))))
    y1 = min(lh, y0 + max(1, int(round(h * lh))))
    m = np.zeros((lh, lw), np.float32)
    m[y0:y1, x0:x1] = 1.0
    rr = int(spec.get("feather", 8))
    for t in range(rr):
        f = (t + 1) / rr
        if y0 != 0 and y0 + t < y1:
            m[y0 + t, x0:x1] *= f
        if y1 != lh and y1 - 1 - t >= y0:
            m[y1 - 1 - t, x0:x1] *= f
        if x0 != 0 and x0 + t < x1:
            m[y0:y1, x0 + t] *= f
        if x1 != lw and x1 - 1 - t >= x0:
            m[y0:y1, x1 - 1 - t] *= f
    return m


def _attach_regional_conds(engine: DiffusionEngine, p: Processing, branches, weights,
                           max_chunks):
    """p.regional_prompts as branches after the AND parts, each with its
    multiplier map; the prompt's own branches keep the whole canvas (None),
    so pixels no region covers fall back to them → (branches, weights, masks)."""
    branches = list(branches or [])
    weights = list(weights or [1.0] * (1 + len(branches)))
    masks: List[Optional[torch.Tensor]] = [None] * (1 + len(branches))
    lh, lw = p.height // 8, p.width // 8
    for spec in p.regional_prompts:
        rcond, _, _ = _build_scheduled_cond(engine, p, [spec["prompt"]] * p.batch_size,
                                            max_chunks=max_chunks, allow_and=False)
        branches.append(rcond)
        weights.append(float(spec.get("weight", 1.0)))
        masks.append(torch.from_numpy(_region_mult_map(spec, lh, lw))[None, None]
                     .to(engine.device))
    return branches, weights, masks


def _conditioning(engine: DiffusionEngine, p: Processing, timings: Dict[str, float],
                  it: int = 0):
    """LoRA activation (then the scripts' `after_extra_networks_activate`),
    then cond, uncond and the AND and regional branches at a shared chunk
    count (from the cache where the request repeats) → (cond, uncond, the
    UNet params the LoRAs patched, branches, weights, masks, the prompts)."""
    tl = time.perf_counter()
    prompts, unet_params, patched_tes = activate(engine, [p.prompt] * p.batch_size,
                                                 registry=engine.lora_registry, p=p)
    if p.scripts is not None:
        p.scripts.after_extra_networks_activate(p, batch_number=it, prompts=prompts)
    negs = [parse_prompt(p.negative_prompt)[0]] * p.batch_size
    _add_time(timings, "lora", tl)

    tc = time.perf_counter()
    te = next((e for e in engine.text_engines.values() if hasattr(e, "tokenize_batch")), None)
    orig_te = {name: engine.text_engines[name].params for name in patched_tes}
    try:
        for name, params in patched_tes.items():
            engine.text_engines[name].params = params
        max_chunks = (1 if te is None else
                      max(te.tokenize_batch(prompts)[1], te.tokenize_batch(negs)[1]))
        key = _cond_cache_key(engine, p, prompts, negs, max_chunks)
        cached = _cond_cache_get(engine, key)
        if cached is not None:
            cond, uncond, branches, weights = cached
        else:
            cond, branches, weights = _build_scheduled_cond(engine, p, prompts, max_chunks)
            uncond, _, _ = _build_scheduled_cond(engine, p, negs, max_chunks, is_negative=True,
                                                 allow_and=False)
            _cond_cache_put(engine, key, cond, uncond, branches, weights)
        masks = None
        if p.regional_prompts:
            branches, weights, masks = _attach_regional_conds(engine, p, branches, weights,
                                                              max_chunks)
    finally:
        for name, params in orig_te.items():
            engine.text_engines[name].params = params
    if p.cond_transform is not None:
        if branches or any(isinstance(v, cfg_mod.PerStep) for v in cond.values()):
            raise NotImplementedError("a cond transform (PhotoMaker) with AND, regional or "
                                      f"prompt-editing conds is not ported: {_ROADMAP_6D}")
        cond = p.cond_transform(cond)
    if engine.family in ("flux", "chroma"):
        if branches:  # the reference adds the guidance to cond and uncond only
            raise NotImplementedError(
                f"AND and regional prompts on {engine.family} are refused: the reference's "
                "branches lack the guidance scale (its batched call raises KeyError 'guidance')")
        g = torch.full((p.batch_size,), float(p.distilled_cfg_scale),
                       dtype=torch.float32, device=engine.device)
        cond = dict(cond, guidance=g)
        uncond = dict(uncond, guidance=g)
    _add_time(timings, "cond", tc)
    return cond, uncond, unet_params, branches, weights, masks, prompts


def _prep_txt2img(engine: DiffusionEngine, p: Processing, seeds, subseeds, cond, uncond,
                  unet_params, timings: Dict[str, float]) -> Job:
    t_noise = time.perf_counter()
    info = get_sampler(p.sampler_name)
    lc = engine.latent_format.latent_channels
    rng = _image_rng(p, info, (lc, p.height // 8, p.width // 8), seeds, subseeds)
    noise0 = rng.next()  # NCHW, the layout the seeds encode
    sigmas = get_sigmas(_auto_schedule(p.sampler_name, p.scheduler), p.steps, engine.predictor,
                        discard_next_to_last=info.discard_next_to_last_sigma)
    step_noise = _prepare_noise(p, rng, info, sigmas, seeds, engine.device)
    x = torch.from_numpy(engine.predictor.noise_scaling(
        np.float32(sigmas[0]), noise0, np.zeros_like(noise0))).to(engine.device)
    cn = getattr(p, "_cn_inpaint", None)
    if cn is not None and cn.get("lama_shift") and cn["latent"].shape[2:] == x.shape[2:]:
        # inpaint_only+lama starts toward the LaMa pre-fill: (noise + z/σmax)·σmax = x + z
        # (reference preprocessor_inpaint.py:160)
        x = x + cn["latent"].to(x.dtype)
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


def _encode(engine: DiffusionEngine, images: np.ndarray, tiled: bool = False) -> torch.Tensor:
    """[B,H,W,3] float in [-1, 1] → regulated f32 latent [B,C,H/8,W/8] on the
    device, encoded whole or in tiles."""
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    return engine.encode_first_stage_tiled(x) if tiled else engine.encode_first_stage(x)


def _prep_img2img(engine: DiffusionEngine, p: Processing, seeds, subseeds, cond, uncond,
                  unet_params, timings: Dict[str, float]) -> Job:
    if p.scripts is not None:
        p.scripts.before_process_init_images(p)
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
    init_latent = _encode(engine, batch, tiled=_tiled_vae(p))  # a tiled plan tiles both ways
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
                             engine.predictor, discard_next_to_last=info.discard_next_to_last_sigma)
    sigmas = full_sigmas[steps - t_enc - 1:]
    step_noise = _prepare_noise(p, rng, info, sigmas, seeds, engine.device)
    if p.inpainting_fill == "latent_noise" and mask_latent is not None:
        init_latent = init_latent + noise0 * mask_latent * float(sigmas[0])
    if p.initial_noise_multiplier != 1.0:
        noise0 = noise0 * p.initial_noise_multiplier
    x = engine.predictor.noise_scaling(float(np.float32(sigmas[0])), noise0, init_latent)
    extra_noise = float(opts.get("img2img_extra_noise"))
    if extra_noise > 0:  # unscaled noise on top of the noised latent (sd_samplers_kdiffusion.py:148)
        p.extra_generation_params["Extra noise"] = extra_noise
        x = x + noise0 * extra_noise
    _add_time(timings, "noise", t_noise)
    return Job(p, x, sigmas, step_noise, cond, uncond, unet_params, mask=mask_latent,
               init_latent=init_latent)


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
        q = _derive(p, inpaint_full_res=False)
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

    def uncrop(batch: np.ndarray) -> List[np.ndarray]:
        results = []
        for b in range(batch.shape[0]):
            gen = resize_image(batch[b], x2 - x1, y2 - y1)
            full = orig.astype(np.float32).copy()
            full[y1:y2, x1:x2] = full[y1:y2, x1:x2] * (1 - m) + gen.astype(np.float32) * m
            results.append(np.clip(full, 0, 255).astype(np.uint8))
        return np.stack(results)

    job.uncrop, job.request = uncrop, p
    return job


def _derive(p: Processing, **changes) -> Processing:
    """`dataclasses.replace` that keeps the request's internal attributes."""
    q = dataclasses.replace(p, **changes)
    for name in _INTERNAL_ATTRS:
        if hasattr(p, name):
            setattr(q, name, getattr(p, name))
    return q


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
    LoRA activation, cond and uncond, the deferred hooks (batch 0 only) and
    the per-request weight override they may leave, then the starting
    latent (noise, or the encoded init images under noise)."""
    seeds = p.all_seeds[it * p.batch_size:(it + 1) * p.batch_size]
    subseeds = p.all_subseeds[it * p.batch_size:(it + 1) * p.batch_size]
    engine.set_clip_skip(p.clip_skip)
    cond, uncond, unet_params, branches, weights, masks, prompts = _conditioning(engine, p,
                                                                                timings, it)
    if it == 0:  # the conds come from the prompts, the same in every batch
        for build in p.deferred_hooks or ():
            build(engine, p, cond, uncond)
    elif getattr(p, "_revision", None) is not None:  # every batch takes Revision
        from .revision import revise

        revise(p, cond, uncond)
    override = getattr(p, "_unet_param_override", None)
    if override is not None:  # a copy on write: the engine's weights stay as they are
        unet_params = override(unet_params)
    runner = p.scripts
    if runner is not None:
        runner.before_process_batch(p, batch_number=it, prompts=prompts, seeds=seeds)
        runner.process_batch(p, batch_number=it, prompts=prompts, seeds=seeds)
        runner.process_before_every_sampling(p, cond=cond, uncond=uncond)
    args = (engine, p, seeds, subseeds, cond, uncond, unet_params, timings)
    if p.init_images is None:
        job = _prep_txt2img(*args)
    elif p.inpaint_full_res and p.inpaint_mask is not None:
        job = _prep_inpaint_full_res(*args)
    else:
        job = _prep_img2img(*args)
    job.seeds, job.subseeds = seeds, subseeds
    job.branches, job.weights, job.masks = branches, weights, masks
    if p.reference_state is not None:
        from .reference_only import reference_step_noise

        t_noise = time.perf_counter()
        job.reference_noise = reference_step_noise(p.reference_state, len(job.sigmas) - 1)
        _add_time(timings, "noise", t_noise)
    return job


def _tiled(apply_model: Callable, spec: Dict[str, int], x: torch.Tensor) -> Callable:
    unknown = sorted(set(spec) - set(TILED_DIFFUSION_KEYS))
    if unknown:
        raise NotImplementedError(f"tiled_diffusion keys {unknown} are not ported yet "
                                  f"(ported: {TILED_DIFFUSION_KEYS})")
    return make_tiled_apply(apply_model, x.shape[2], x.shape[3], tile=int(spec.get("tile", 96)),
                            overlap=int(spec.get("overlap", 32)))


CFG_EVENTS = ("cfg_denoiser", "cfg_denoised", "cfg_after_cfg")


def _event_cfg_hooks(p: Processing, sigmas: np.ndarray):
    """The CFG events, fired once for a pass over `sigmas` where a callback
    is registered → (the pre-CFG hooks, the post-CFG hooks) their callbacks
    appended."""
    if not any(callbacks(event) for event in CFG_EVENTS):
        return (), ()
    hp = CFGHookParams(p, np.asarray(sigmas, np.float32), len(sigmas) - 1)
    for event in CFG_EVENTS:
        fire(event, hp)
    return tuple(hp.pre_cfg_hooks), tuple(hp.post_cfg_hooks)


def cfg_model_fn(engine: DiffusionEngine, job: Job) -> Callable:
    """The model_fn(x, σ) a job's pass integrates: the UNet with the
    request's hooks and ControlNets, its tiles, CFG with the branches and
    the CFG hooks (the request's, then those the CFG events add), and the
    inpaint composite, hard or soft."""
    p = job.p
    info = get_sampler(p.sampler_name)
    event_pre, event_post = _event_cfg_hooks(p, job.sigmas)

    def make_apply(hooks):
        return cfg_mod.make_apply_model(
            engine.unet_apply_fn(hooks=hooks, controlnets=p.controlnets), job.unet_params,
            engine.predictor, engine.compute_dtype)

    apply_model = make_apply(p.unet_hooks)
    if p.reference_state is not None:  # between the request's apply and CFG, as the reference
        from .reference_only import wrap_reference

        apply_model = wrap_reference(apply_model, make_apply, p, p.reference_state, job.sigmas,
                                     p.cfg_scale == 1.0 or job.uncond is None,
                                     job.reference_noise)
    if p.tiled_diffusion:  # inside CFG: every tile's forward sees the CFG batch
        apply_model = _tiled(apply_model, p.tiled_diffusion, job.x)
        p.extra_generation_params.setdefault(
            "Tiled Diffusion", f"MultiDiffusion tile {p.tiled_diffusion.get('tile', 96)}")
    combine = p.cfg_combine_hook
    if hasattr(combine, "build"):  # a spec: built against this pass's σ, as the reference does
        combine = combine.build(np.asarray(job.sigmas, np.float32), predictor=engine.predictor)
    model_fn = cfg_mod.make_cfg_model_fn(
        apply_model, job.cond, None if p.cfg_scale == 1.0 else job.uncond,
        p.cfg_scale * info.cfg_multiplier, cfg_rescale=p.cfg_rescale,
        sigmas_np=job.sigmas if job.sigma_table is None else job.sigma_table,
        cond_branches=job.branches, branch_weights=job.weights, branch_masks=job.masks,
        return_uncond=info.needs_uncond, pre_cfg_hooks=tuple(p.pre_cfg_hooks or ()) + event_pre,
        post_cfg_hooks=tuple(p.post_cfg_hooks or ()) + event_post, cfg_combine_fn=combine)
    mask, init_latent = job.mask, job.init_latent
    cn = getattr(p, "_cn_inpaint", None)
    if mask is None and cn is not None and cn["latent"].shape[2:] == job.x.shape[2:]:
        # ControlNet inpaint_only: its composite, on a pass at its latent's size
        mask, init_latent = cn["latent_mask"], cn["latent"]
    if mask is not None and p.soft_inpainting is not None:
        from ..extensions.soft_inpainting import make_soft_masked_model_fn

        model_fn = make_soft_masked_model_fn(model_fn, mask, init_latent, p.soft_inpainting)
    elif mask is not None:
        masked = cfg_mod.make_masked_pair_fn if info.needs_uncond else cfg_mod.make_masked_model_fn
        model_fn = masked(model_fn, mask, init_latent)
    return model_fn


def denoise(engine: DiffusionEngine, job: Job) -> torch.Tensor:
    """The denoise stage: the sampler's step loop from job.x over its σ,
    enqueued on the engine's device (no wait for the card) → the latent."""
    p = job.p
    info = get_sampler(p.sampler_name)
    inner = cfg_model_fn(engine, job)

    def ticking(x, sigma):
        out = inner(x, sigma)
        _progress_tick(engine, out[0] if isinstance(out, tuple) else out)
        return out

    params = inspect.signature(info.fn).parameters
    eta = p.eta_ddim if info.uses_eta_ddim else p.eta
    kwargs = {name: value for name, value in
              (("eta", eta), ("s_noise", p.s_noise), ("s_churn", p.s_churn))
              if name in params}
    with step_gate(_stop_requested):
        return info.fn(ticking, job.x, job.sigmas, job.step_noise, **kwargs)


def finish(job: Job, batch: np.ndarray, batch_number: int = 0,
           device: Optional[torch.device] = None) -> List[np.ndarray]:
    """The finish stage: decoded uint8 [B,H,W,3] → the request's images, in
    the reference's order: "only masked" crops pasted back, the scripts'
    `postprocess_batch` and `postprocess_batch_list`, then each image's
    face restoration (`restore_faces` or the `face_restoration` option, on
    `device`), colour correction (img2img under the option), ControlNet
    inpaint_only's final composite, the inpaint paste with `on_mask_blend`
    and `postprocess_image_after_composite` (not for "only masked", whose
    paste is done, as the reference's), and `postprocess_image`."""
    p = job.request if job.request is not None else job.p
    runner = p.scripts
    if job.uncrop is not None:
        batch = job.uncrop(batch)
    if runner is not None:
        batch = runner.postprocess_batch(p, batch, batch_number=batch_number)
        listed = runner.postprocess_batch_list(p, [batch[i] for i in range(len(batch))],
                                               batch_number=batch_number)
        if listed is not None:
            batch = listed
    restorer = None
    if p.restore_faces or opts.get("face_restoration"):
        from ..postprocessing.faces import RestorerMissing, get_face_restorer

        restorer = get_face_restorer(device)
        if not restorer.available:  # the reference prints and skips (processing.py:788-789)
            raise RestorerMissing(f"restore_faces: no {restorer.name} checkpoint under "
                                  f"{restorer.model_dir}")
        p.restore_faces = True  # the infotext's "Face restoration"
    is_img2img = p.init_images is not None
    correct = is_img2img and bool(opts.get("img2img_color_correction"))
    images = []
    for b in range(len(batch)):
        img = batch[b]
        init = p.init_images[min(b, len(p.init_images) - 1)] if is_img2img else None
        if restorer is not None:
            img = restorer.restore(img)
        if correct:
            img = apply_color_correction(setup_color_correction(init), img)
        img = composite_final(p, img)
        if is_img2img and p.inpaint_mask is not None and job.uncrop is None:
            img = _composite_inpaint(p, img, init)
            if runner is not None:
                blended = runner.on_mask_blend(p, img, index=b)
                if blended is not None:
                    img = blended
                after = runner.postprocess_image_after_composite(p, img, index=b)
                if after is not None:
                    img = after
        if runner is not None:
            img = runner.postprocess_image(p, img, index=b)
        images.append(img)
    return images


def _outdir(kind: str, is_img2img: bool) -> str:
    """`outdir_samples` or `outdir_grids` where set, else the txt2img or
    img2img directory of `kind` ("samples" or "grids")."""
    return (opts.get(f"outdir_{kind}")
            or opts.get(f"outdir_{'img2img' if is_img2img else 'txt2img'}_{kind}"))


def _save_samples(p: Processing, images: List[np.ndarray], texts: List[str], seeds: List[int],
                  it: int) -> None:
    """Each finished image of batch `it` saved with its infotext (an OSError
    printed, as the reference does, and the request goes on)."""
    outdir = _outdir("samples", p.init_images is not None)
    for b, img in enumerate(images):
        try:
            save_image(img, outdir=outdir, infotext=texts[b], seed=seeds[b], prompt=p.prompt,
                       width=p.width, height=p.height, model_name=p.sd_model_name or "",
                       model_hash=p.sd_model_hash or "", sampler=p.sampler_name, steps=p.steps,
                       cfg=p.cfg_scale, batch_number=b, generation_number=it * p.batch_size + b)
        except OSError as e:
            print(f"image save failed: {e}")


def _save_grid(p: Processing, images: List[np.ndarray], text: str) -> None:
    """The request's images in one grid (`n_rows` rows, or the reference's
    square-root default), saved under the first image's infotext."""
    n_rows = int(opts.get("n_rows"))
    grid = image_grid(images, rows=n_rows if n_rows > 0 else None)
    try:
        save_image(grid, outdir=_outdir("grids", p.init_images is not None), infotext=text,
                   seed=p.all_seeds[0], prompt=p.prompt,
                   filename_pattern="grid-[seed]-[prompt_words]")
    except OSError as e:
        print(f"grid save failed: {e}")


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
    extra-network tags stripped, each at its own chunk count. These conds
    are plain (`_refuse_mixed` refuses `AND` and `[from:to:when]` here)."""
    prompt, negative = parse_prompt(prompt)[0], parse_prompt(negative)[0]
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


def _ngms_split(p: Processing, job: Job) -> Optional[int]:
    """NGMS: the first step whose σ is below the `s_min_uncond` option, where
    the uncond branch is dropped, or None (no threshold, CFG 1, AND or
    regional branches, or no σ on each side of it)."""
    thr = float(opts.get("s_min_uncond") or 0.0)
    if thr <= 0 or p.cfg_scale == 1.0 or job.branches:
        return None
    below = np.asarray(job.sigmas[:-1]) < thr
    if not below.any() or below.all():
        return None
    k = int(np.argmax(below))
    return k if 0 < k < len(job.sigmas) - 1 else None


def _refuse_mixed(p: Processing, job: Job) -> None:
    """The combinations the reference mixes or fails on raise, before the
    first denoise."""
    if p.init_images is not None:
        if p.hook_phases:
            raise NotImplementedError(
                "hook_phases on img2img are not ported: the reference's img2img never reads "
                "them (a Fooocus inpaint window short of 0-1 loses its head there)")
        return
    refiner = _refiner_step(p, len(job.sigmas) - 1) is not None
    if refiner and p.hook_phases:
        raise NotImplementedError("hook_phases with the refiner are not ported: the reference "
                                  "drops the phases without a word")
    hr_reencode = p.enable_hr and bool(p.hr_prompt or p.hr_negative_prompt
                                       or p.hr_checkpoint_name
                                       or getattr(p, "_hr_engine", None) is not None)
    if refiner and (any(getattr(p, name) for name in CFG_HOOK_FIELDS)
                    or set(p.unet_hooks or ()) & BLOCK_HOOK_KEYS):
        raise NotImplementedError("the CFG hooks and the UNet's block-level hooks with the "
                                  "refiner are not ported: no test holds the reference's "
                                  "refiner pass with them")
    if job.branches and refiner:
        raise NotImplementedError("AND or regional prompts with the refiner are not ported: "
                                  "the reference joins the refiner's conds with the base's "
                                  "branches of another width")
    if job.branches and p.enable_hr and job.masks:
        raise NotImplementedError("regional prompts with the hires fix are not ported: the "
                                  "reference applies the first pass's masks to the hires latent")
    if job.branches and hr_reencode:
        raise NotImplementedError("AND prompts with a hires pass that encodes its own conds "
                                  "are not ported: the reference keeps the first prompt's "
                                  "branches beside them")
    # the refiner's and a re-encoding hires pass's conds are plain (_encode_base_conds)
    texts = [p.prompt, p.negative_prompt] if refiner else []
    if hr_reencode:
        texts += [p.hr_prompt or p.prompt, p.hr_negative_prompt or p.negative_prompt]
    for text in texts:
        text = parse_prompt(text)[0]
        if len(split_composable(text)) > 1 or len(get_schedule(text, p.steps)) > 1:
            raise NotImplementedError(
                f"AND or [from:to:when] in {text!r} for the refiner or a hires pass's own "
                "conds is not ported: the reference encodes it as literal text")


def _refuse_image_prompt(engine: DiffusionEngine, p: Processing, job: Job) -> None:
    """Reference-only, a cond transform and Revision raise, before the first
    denoise, in the combinations no test holds against the reference."""
    asked = [name for name, on in (("reference_state", p.reference_state is not None),
                                   ("cond_transform", p.cond_transform is not None),
                                   ("Revision", getattr(p, "_revision", None) is not None))
             if on]
    if not asked:
        return
    families = ("sd15", "sdxl") if asked == ["reference_state"] else ("sdxl",)
    combos = {
        f"the {engine.family} family": engine.family not in families,
        "img2img": p.init_images is not None,
        "the hires fix": p.enable_hr,
        "the refiner": _refiner_step(p, len(job.sigmas) - 1) is not None,
        "hook phases": bool(p.hook_phases),
        "AND or regional prompts": bool(job.branches),
        "prompt editing": any(isinstance(v, cfg_mod.PerStep)
                              for c in (job.cond, job.uncond) for v in c.values()),
        "tiled diffusion": bool(p.tiled_diffusion),
        "an NGMS split": _ngms_split(p, job) is not None,
    }
    refused = [name for name, on in combos.items() if on]
    if refused:
        raise NotImplementedError(f"{', '.join(asked)} with {', '.join(refused)} is not "
                                  f"ported: {_ROADMAP_6D}")


def _run_phased(engine: DiffusionEngine, job: Job) -> torch.Tensor:
    """`hook_phases`: the step loop as consecutive `denoise` segments, each
    over σ[k_prev:k_end + 1] with its step noise and the base `unet_hooks`
    merged with its phase's (tuple slots chain, others replace), k_end =
    max(min(round(end·n), n), k_prev); an empty segment is skipped, steps
    past the last phase's end are not run, and the multistep history starts
    afresh at each seam, as in the reference. Per-step conds take their row
    from the whole pass's σ table. The loop ends between segments on an
    interrupt or skip; `p.unet_hooks` is restored after."""
    p = job.p
    n = len(job.sigmas) - 1
    noise = job.step_noise
    base = p.unet_hooks
    latent, k_prev = job.x, 0
    try:
        for end_frac, extra in p.hook_phases:
            k_end = max(min(int(round(end_frac * n)), n), k_prev)
            if k_end == k_prev:
                continue
            p.unet_hooks = _merge_hooks(base, extra) if extra else base
            latent = denoise(engine, dataclasses.replace(
                job, x=latent, sigmas=job.sigmas[k_prev:k_end + 1], sigma_table=job.sigmas,
                step_noise=None if noise is None else noise[k_prev:k_end]))
            k_prev = k_end
            if _stop_requested():
                break
    finally:
        p.unet_hooks = base
    return latent


def sample(engine: DiffusionEngine, job: Job, timings: Dict[str, float]):
    """`denoise`, with the refiner's two-pass switch, the hook phases or the
    NGMS split (not under hook phases, as in the reference) where a txt2img
    request asks for it → (latent, the engine that decodes it)."""
    p = job.p
    _refuse_image_prompt(engine, p, job)
    _refuse_mixed(p, job)
    k = _refiner_step(p, len(job.sigmas) - 1) if p.init_images is None else None
    noise = job.step_noise
    if k is None and p.hook_phases:
        return _run_phased(engine, job), engine
    if k is None:
        k = _ngms_split(p, job) if p.init_images is None else None
        if k is None:
            return denoise(engine, job), engine
        # NGMS: the tail without the uncond, its conds selected in the whole σ table
        head = dataclasses.replace(job, sigmas=job.sigmas[:k + 1], sigma_table=job.sigmas,
                                   step_noise=None if noise is None else noise[:k])
        tail = dataclasses.replace(job, x=denoise(engine, head), sigmas=job.sigmas[k:],
                                   sigma_table=job.sigmas, uncond=None,
                                   step_noise=None if noise is None else noise[k:])
        p.extra_generation_params.setdefault("NGMS", float(opts.get("s_min_uncond")))
        return denoise(engine, tail), engine
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
    if p.scripts is not None:
        p.scripts.before_hr(p)
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
                             hr_engine.predictor,
                             discard_next_to_last=info.discard_next_to_last_sigma)
    t_enc = min(int(p.hr_denoising_strength * steps), steps - 1)
    sigmas = full_sigmas[steps - t_enc - 1:]
    rng = ImageRNG((lc, h8, w8), job.seeds, subseeds=job.subseeds,
                   subseed_strength=p.subseed_strength)
    noise0 = torch.from_numpy(rng.next()).to(hr_engine.device)
    step_noise = _prepare_noise(p, rng, info, sigmas, job.seeds, hr_engine.device)
    x = hr_engine.predictor.noise_scaling(float(np.float32(sigmas[0])), noise0, latent.float())
    q = _derive(p, cfg_scale=p.hr_cfg_scale or p.cfg_scale)
    latent = denoise(hr_engine, Job(q, x, sigmas, step_noise, cond, uncond, unet_params,
                                    branches=job.branches, weights=job.weights))
    if latent.is_cuda:
        torch.cuda.synchronize(latent.device)
    _add_time(timings, "hires_sample", t)
    return latent, hr_engine


@torch.no_grad()
def process_images(engine: DiffusionEngine, p: Processing) -> Processed:
    t0 = time.perf_counter()
    setup(engine, p)
    runner = p.scripts
    if runner is not None:
        runner.setup(p)
        runner.before_process(p)
        runner.process(p)
    fire("before_process", p)
    plan(engine, p)
    timings: Dict[str, float] = {}
    images: List[np.ndarray] = []
    texts: List[str] = []
    methods = []
    for it in range(p.n_iter):
        if it and state.job and state.interrupted:
            break
        job = prepare(engine, p, it, timings)
        t1 = time.perf_counter()
        latent, out_engine = sample(engine, job, timings)
        if latent.is_cuda:  # for the phase's time only; the decode would wait as well
            torch.cuda.synchronize(latent.device)
        _add_time(timings, "sample", t1)
        if p.enable_hr and p.init_images is None and not _stop_requested():
            latent, out_engine = hires_pass(engine, job, latent, timings)
        t2 = time.perf_counter()
        handle, method = decode_dispatch(out_engine, latent, p)
        batch = out_engine.decode_finish(handle)
        _add_time(timings, "decode", t2)
        methods.append(method)
        done = finish(job, batch, it, device=out_engine.device)
        images.extend(done)
        last = len(job.seeds) - 1  # a script may have added images to the batch
        seeds = [job.seeds[min(b, last)] for b in range(len(done))]
        batch_texts = infotexts(p, seeds, [job.subseeds[min(b, last)] for b in range(len(done))])
        texts.extend(batch_texts)
        if opts.get("samples_save") and not p.do_not_save_samples:
            _save_samples(p, done, batch_texts, seeds, it)
        state.skipped = False  # a skip ends one batch
    if (len(images) > 1 and not p.do_not_save_grid and opts.get("grid_save")
            and (not opts.get("grid_only_if_multiple") or len(images) > 1)):
        _save_grid(p, images, texts[0])
    timings["total"] = time.perf_counter() - t0
    log_event("generation", sampler=p.sampler_name, steps=p.steps, width=p.width,
              height=p.height, batch_size=p.batch_size, n_iter=p.n_iter, seed=p.seed,
              is_img2img=p.init_images is not None,
              **{f"t_{k}": round(v, 4) for k, v in timings.items()})
    processed = Processed(images=images, seeds=list(p.all_seeds), subseeds=list(p.all_subseeds),
                          infotexts=texts, params=_simple_params(p), timings=timings,
                          decode_method=", ".join(dict.fromkeys(methods)))
    if runner is not None:
        runner.postprocess(p, processed)
    if texts and opts.get("save_write_params_txt"):
        write_params_txt(texts[0])
    return processed

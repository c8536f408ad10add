"""Reference-only and reference-adain guidance, weightless style transfer
(port of forge_tpu/pipeline/reference_only.py, itself of Forge's
forge_preprocessor_reference).

Each step inside the guidance window runs the UNet twice:

  1. a recording pass at batch 1 on the reference image's latent noised to
     the step's σ (xt = z_ref + n_t·σ, a fresh draw a step from the Philox
     stream of seed + 1) with the first row of each cond, in which every
     self-attention's (k, v) and every block output's channel statistics
     (std, mean) are kept by block;
  2. the CFG pass, where the cond rows' self-attention attends over [own
     k, v ‖ recorded k, v], the uncond rows blend the plain and the joined
     attention by `style_fidelity`, and the adain variants renormalise block
     outputs to the recorded statistics.

The reference traces both passes into one XLA program, which deletes what
the recorded tensors do not need and gates the window with `lax.cond`; here
the recording pass is a whole forward, run before the CFG pass of each step
in the window, and the window is a host `if` on the step's index. The index
is the reference's: searchsorted of −σ in −σ[:-1], in float32, side
"right", less 1, clipped, so a second-order sampler's intermediate σ lands
on the step it belongs to. Block statistics are over H and W, axes (2, 3)
of NCHW; the channel gates read q's last axis in attention and h's axis 1
for block outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.attention import attention
from ..sampling.cfg import step_index


@dataclasses.dataclass
class ReferenceState:
    """What a reference unit ("reference_only", "reference_adain",
    "reference_adain+attn") leaves on the request (`p.reference_state`)."""

    latent: torch.Tensor      # [1, C, h, w] the reference image's regulated latent, f32
    style_fidelity: float     # 0..1, already cubed on the SDXL family
    weight: float             # the unit's weight: the channel gates
    use_attn: bool
    use_adain: bool
    start_percent: float = 0.0
    end_percent: float = 1.0
    seed: int = 1             # the recording pass's noise stream


@torch.no_grad()
def attach_reference(engine, p, img_u8: np.ndarray, module: str, style_fidelity: float = 0.5,
                     weight: float = 1.0, start: float = 0.0, end: float = 1.0) -> ReferenceState:
    """The unit's deferred hook: the reference image resized bilinearly to the
    request's size, VAE-encoded, and a ReferenceState on `p`."""
    from ..preprocessors.cv import bilinear_resize

    use_attn = "attn" in module or module == "reference_only"
    use_adain = "adain" in module
    if engine.family in ("sdxl", "playground"):  # SDXL is very sensitive to reference guidance
        style_fidelity = float(style_fidelity) ** 3.0
    arr = bilinear_resize(np.asarray(img_u8, np.float32) / 255.0, p.height, p.width)
    x = torch.from_numpy(np.ascontiguousarray((arr * 2.0 - 1.0).transpose(2, 0, 1)[None]))
    state = ReferenceState(latent=engine.encode_first_stage(x).float(),
                           style_fidelity=float(style_fidelity), weight=float(weight),
                           use_attn=use_attn, use_adain=use_adain, start_percent=float(start),
                           end_percent=float(end), seed=int(p.seed or 0) + 1)
    p.reference_state = state
    p.extra_generation_params.setdefault("Reference", module)
    return state


def reference_step_noise(ref: ReferenceState, n_steps: int) -> torch.Tensor:
    """The recording pass's noise [n_steps, 1, C, h, w], one Philox draw
    (C, h, w) a step from Generator(seed) (the reference draws the same and
    transposes it to NHWC), on the latent's device."""
    from ..ops.rng_philox import Generator

    _, c, h, w = ref.latent.shape
    g = Generator(ref.seed)
    steps = np.stack([g.randn((c, h, w)) for _ in range(n_steps)]).astype(np.float32)
    return torch.from_numpy(steps[:, None]).to(ref.latent.device)


def _adain(h: torch.Tensor, std: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    m = h.mean(dim=(2, 3), keepdim=True)
    v = (h - m).square().mean(dim=(2, 3), keepdim=True)
    s = torch.sqrt(torch.clamp(v, min=1e-12))
    return ((h - m) / s) * std.to(h.dtype) + mean.to(h.dtype)


def _std_mean(h: torch.Tensor):
    hf = h.float()
    m = hf.mean(dim=(2, 3), keepdim=True)
    v = (hf - m).square().mean(dim=(2, 3), keepdim=True)
    return torch.sqrt(torch.clamp(v, min=1e-12)), m


def build_reference_hooks(ref: ReferenceState, base_hooks: Optional[Mapping[str, Any]],
                          n_cond_rows: int, skip_uncond: bool):
    """→ (capture hooks, consume hooks), each the request's hooks extended:
    the capture hooks record into dicts the consume hooks read. A recorded
    block is gated by channels ≥ 1500 − 1280·weight (attention) or ≥ 1500 −
    1000·weight (block outputs)."""
    rec_kv: Dict[Any, Any] = {}
    rec_h: Dict[Any, Any] = {}
    min_ch_attn = 1500.0 - 1280.0 * ref.weight
    min_ch_adain = 1500.0 - 1000.0 * ref.weight
    fid = float(ref.style_fidelity)
    capture = dict(base_hooks or {})
    consume = dict(base_hooks or {})

    if ref.use_attn:
        def cap_attn(q, k, v, extra):
            if q.shape[-1] >= min_ch_attn:
                rec_kv[(extra["block"], extra.get("block_index", 0))] = (k, v)
            return attention(q, k, v, heads=extra["n_heads"])

        def con_attn(q, k, v, extra):
            heads = extra["n_heads"]
            rec = rec_kv.get((extra["block"], extra.get("block_index", 0)))
            if rec is None:
                return attention(q, k, v, heads=heads)
            k_r, v_r = rec

            def cat_r(a, r):
                return torch.cat([a, r.expand((a.shape[0],) + tuple(r.shape[1:])).to(a.dtype)],
                                 dim=1)

            if skip_uncond:
                return attention(q, cat_r(k, k_r), cat_r(v, v_r), heads=heads)
            b = n_cond_rows
            o_c = attention(q[:b], cat_r(k[:b], k_r), cat_r(v[:b], v_r), heads=heads)
            o_uc_strong = attention(q[b:], k[b:], v[b:], heads=heads)
            o_uc_weak = attention(q[b:], cat_r(k[b:], k_r), cat_r(v[b:], v_r), heads=heads)
            return torch.cat([o_c, o_uc_weak + (o_uc_strong - o_uc_weak) * fid])

        capture["attn1_replace_all"] = cap_attn
        consume["attn1_replace_all"] = con_attn

    if ref.use_adain:
        def cap_block(h, block_id):
            if h.shape[1] >= min_ch_adain:
                rec_h[block_id] = _std_mean(h)
            return h

        def con_block(h, block_id):
            if block_id not in rec_h:
                return h
            std, mean = rec_h[block_id]
            if skip_uncond:
                return _adain(h, std, mean)
            b = n_cond_rows
            o_uc_weak = _adain(h[b:], std, mean)
            return torch.cat([_adain(h[:b], std, mean), o_uc_weak + (h[b:] - o_uc_weak) * fid])

        for slot in ("input_block_patch", "middle_block_patch", "output_block_patch_after"):
            capture[slot] = tuple(capture.get(slot, ())) + (cap_block,)
            consume[slot] = tuple(consume.get(slot, ())) + (con_block,)

    return capture, consume


def wrap_reference(apply_plain: Callable, make_apply: Callable, p, ref: ReferenceState,
                   sigmas_np: np.ndarray, skip_uncond: bool, noise: torch.Tensor) -> Callable:
    """The σ-space apply(x, σ, cond) with the windowed two passes.
    `apply_plain` is the request's apply for steps outside the window;
    `make_apply(hooks)` the σ-space apply of the UNet with those hooks and
    the request's ControlNets; `noise` the recording pass's [n_steps, 1, C,
    h, w] (`reference_step_noise`)."""
    capture_hooks, consume_hooks = build_reference_hooks(ref, p.unet_hooks, p.batch_size,
                                                         skip_uncond)
    apply_capture, apply_consume = make_apply(capture_hooks), make_apply(consume_hooks)
    last = np.float32(max(len(sigmas_np) - 2, 1))  # the last step's index, the fraction's unit
    lo = np.float32(float(ref.start_percent) - 1e-6)
    hi = np.float32(float(ref.end_percent) + 1e-6)

    def apply_ref(x, sigma, cond):
        idx = step_index(sigmas_np, sigma)
        frac = np.float32(idx) / last
        if not lo <= frac <= hi:
            return apply_plain(x, sigma, cond)
        xt = ref.latent + noise[idx] * float(np.float32(sigma))
        cond1 = {k: v[:1] if torch.is_tensor(v) and v.dim() > 0 else v for k, v in cond.items()}
        apply_capture(xt, sigma, cond1)  # its output is not read: it fills the records
        return apply_consume(x, sigma, cond)

    return apply_ref

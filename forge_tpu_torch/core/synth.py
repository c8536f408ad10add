# Copied from forge_tpu/core/synth.py (the SD1.5, SDXL, Flux, MMDiT, T5 and ControlNet state dicts); numpy only, so the port imports no JAX.
# `DeviceFill`, `LazyTensor`, the SD2, SDXL refiner, Playground, SD3 and Chroma checkpoints, the bitsandbytes writer and the CLIP-vision, IP-Adapter, ESRGAN and TAESD state dicts are the port's own.
"""Synthetic checkpoint synthesis: reference-format state dicts with real key
names/shapes but generated weights.

Two uses: (1) tiny random checkpoints for pipeline tests (the analog of
upstream A1111's empty.pt dummy checkpoint, SURVEY.md §4); (2) full-size
zero-filled checkpoints for performance benchmarking on TPU without model
downloads — matmul timing is data-independent, so zeros benchmark exactly
like trained weights. The port adds (3): `fill=DeviceFill(device, seed)`
makes every weight a `LazyTensor` that the loader materializes on the card
one at a time (and quantizes there), so a full-width Flux-dev never sits on
the host: ~16.7 B parameters would be ~67 GB of f32 and minutes of numpy.

The UNet builder mirrors the ldm UNetModel construction algorithm (level/block
layout, skip-channel bookkeeping) so key sets match real checkpoints of the
same hyperparameters.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class _Fill:
    def __init__(self, mode: str, seed: int = 0, scale: float = 0.02):
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.scale = scale

    def w(self, *shape, scale: Optional[float] = None):
        if self.mode == "zeros":
            return np.zeros(shape, np.float32)
        return (self.rng.standard_normal(shape) * (self.scale if scale is None else scale)
                ).astype(np.float32)

    def ones(self, *shape):
        return np.ones(shape, np.float32)

    def zeros(self, *shape):
        return np.zeros(shape, np.float32)


class LazyTensor:
    """A weight whose shape (and dtype) is known before it exists; `materialize()` makes it."""

    def __init__(self, shape: Tuple[int, ...], make: Callable[[], torch.Tensor],
                 dtype: torch.dtype = torch.float32):
        self.shape = tuple(shape)
        self.dtype = dtype
        self._make = make

    def to(self, dtype: torch.dtype) -> "LazyTensor":
        """The same weight, made in `dtype`."""
        return LazyTensor(self.shape, lambda: self._make().to(dtype), dtype)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def materialize(self) -> torch.Tensor:
        return self._make()


class DeviceFill:
    """`fill=` for the synth functions: N(0, 0.02²) weights, ones and zeros
    made as f32 `LazyTensor`s on `device`. Weight i of the function seeded `seed`
    comes from its own `torch.Generator(device)` seeded (seed, i), so every
    tensor is the same whatever order the loader makes them in."""

    def __init__(self, device, seed: int = 0, scale: float = 0.02):
        self.device = torch.device(device)
        self.seed = seed
        self.scale = scale
        self._count = 0

    def seeded(self, seed: int) -> "DeviceFill":
        return DeviceFill(self.device, self.seed * 1_000_003 + seed, self.scale)

    def w(self, *shape, scale: Optional[float] = None):
        index, self._count = self._count, self._count + 1
        dev, seed = self.device, self.seed * 100_003 + index
        scale = self.scale if scale is None else scale

        def make():
            gen = torch.Generator(device=dev).manual_seed(seed)
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

        return LazyTensor(shape, make)

    def ones(self, *shape):
        return LazyTensor(shape, lambda: torch.ones(shape, device=self.device))

    def zeros(self, *shape):
        return LazyTensor(shape, lambda: torch.zeros(shape, device=self.device))


FillSpec = Union[str, DeviceFill]


def _fill(fill: FillSpec, seed: int):
    return fill.seeded(seed) if isinstance(fill, DeviceFill) else _Fill(fill, seed)


def synth_unet_sd(
    model_channels: int = 320,
    channel_mult: Sequence[int] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    transformer_depth: Sequence[int] = (1, 1, 1, 0),
    context_dim: int = 768,
    adm_in_channels: Optional[int] = None,
    in_channels: int = 4,
    out_channels: int = 4,
    ff_mult: int = 4,
    middle_depth: Optional[int] = None,
    encoder_hid_dim: Optional[int] = None,  # Kolors 4096→context projection
    fill: FillSpec = "zeros",
    seed: int = 1,
    prefix: str = "model.diffusion_model.",
) -> Dict[str, np.ndarray]:
    f = _fill(fill, seed)
    sd: Dict[str, np.ndarray] = {}
    emb = model_channels * 4
    if encoder_hid_dim:
        sd[prefix + "encoder_hid_proj.weight"] = f.w(context_dim, encoder_hid_dim)
        sd[prefix + "encoder_hid_proj.bias"] = f.zeros(context_dim)

    def norm(key, ch):
        sd[key + ".weight"] = f.ones(ch)
        sd[key + ".bias"] = f.zeros(ch)

    def lin(key, o, i, bias=True):
        sd[key + ".weight"] = f.w(o, i)
        if bias:
            sd[key + ".bias"] = f.zeros(o)

    def conv(key, o, i, k=3):
        sd[key + ".weight"] = f.w(o, i, k, k)
        sd[key + ".bias"] = f.zeros(o)

    def resblock(key, cin, cout):
        norm(key + ".in_layers.0", cin)
        conv(key + ".in_layers.2", cout, cin)
        lin(key + ".emb_layers.1", cout, emb)
        norm(key + ".out_layers.0", cout)
        conv(key + ".out_layers.3", cout, cout)
        if cin != cout:
            conv(key + ".skip_connection", cout, cin, 1)

    def transformer(key, ch, depth):
        norm(key + ".norm", ch)
        linear_proj = context_dim >= 1024  # SD2/SDXL use linear projections
        if linear_proj:
            lin(key + ".proj_in", ch, ch)
        else:
            conv(key + ".proj_in", ch, ch, 1)
        for d in range(depth):
            tb = f"{key}.transformer_blocks.{d}"
            for an, ctx in (("attn1", ch), ("attn2", context_dim)):
                lin(f"{tb}.{an}.to_q", ch, ch, bias=False)
                lin(f"{tb}.{an}.to_k", ch, ctx, bias=False)
                lin(f"{tb}.{an}.to_v", ch, ctx, bias=False)
                lin(f"{tb}.{an}.to_out.0", ch, ch)
            norm(tb + ".norm1", ch)
            norm(tb + ".norm2", ch)
            norm(tb + ".norm3", ch)
            lin(tb + ".ff.net.0.proj", ch * ff_mult * 2, ch)
            lin(tb + ".ff.net.2", ch, ch * ff_mult)
        if linear_proj:
            lin(key + ".proj_out", ch, ch)
        else:
            conv(key + ".proj_out", ch, ch, 1)

    lin(prefix + "time_embed.0", emb, model_channels)
    lin(prefix + "time_embed.2", emb, emb)
    if adm_in_channels:
        lin(prefix + "label_emb.0.0", emb, adm_in_channels)
        lin(prefix + "label_emb.0.2", emb, emb)

    # -- input blocks -------------------------------------------------------
    conv(prefix + "input_blocks.0.0", model_channels, in_channels)
    skip_chans = [model_channels]
    ch = model_channels
    idx = 1
    nlevels = len(channel_mult)
    for level, mult in enumerate(channel_mult):
        out_ch = model_channels * mult
        for _ in range(num_res_blocks):
            resblock(f"{prefix}input_blocks.{idx}.0", ch, out_ch)
            ch = out_ch
            if transformer_depth[level] > 0:
                transformer(f"{prefix}input_blocks.{idx}.1", ch, transformer_depth[level])
            skip_chans.append(ch)
            idx += 1
        if level != nlevels - 1:
            conv(f"{prefix}input_blocks.{idx}.0.op", ch, ch)
            skip_chans.append(ch)
            idx += 1

    # -- middle -------------------------------------------------------------
    md = middle_depth if middle_depth is not None else (transformer_depth[-1] or transformer_depth[-2] or 1)
    resblock(prefix + "middle_block.0", ch, ch)
    transformer(prefix + "middle_block.1", ch, md)
    resblock(prefix + "middle_block.2", ch, ch)

    # -- output blocks ------------------------------------------------------
    idx = 0
    for level in reversed(range(nlevels)):
        out_ch = model_channels * channel_mult[level]
        for r in range(num_res_blocks + 1):
            skip = skip_chans.pop()
            resblock(f"{prefix}output_blocks.{idx}.0", ch + skip, out_ch)
            ch = out_ch
            j = 1
            if transformer_depth[level] > 0:
                transformer(f"{prefix}output_blocks.{idx}.{j}", ch, transformer_depth[level])
                j += 1
            if level != 0 and r == num_res_blocks:
                conv(f"{prefix}output_blocks.{idx}.{j}.conv", ch, ch)
            idx += 1

    norm(prefix + "out.0", model_channels)
    conv(prefix + "out.2", out_channels, model_channels)
    return sd


def synth_vae_sd(
    ch: int = 128,
    ch_mult: Sequence[int] = (1, 2, 4, 4),
    num_res: int = 2,
    z_channels: int = 4,
    fill: FillSpec = "zeros",
    seed: int = 2,
    prefix: str = "first_stage_model.",
) -> Dict[str, np.ndarray]:
    f = _fill(fill, seed)
    sd: Dict[str, np.ndarray] = {}

    def norm(key, c):
        sd[key + ".weight"] = f.ones(c)
        sd[key + ".bias"] = f.zeros(c)

    def conv(key, o, i, k=3):
        sd[key + ".weight"] = f.w(o, i, k, k)
        sd[key + ".bias"] = f.zeros(o)

    def res(key, cin, cout):
        norm(key + ".norm1", cin)
        conv(key + ".conv1", cout, cin)
        norm(key + ".norm2", cout)
        conv(key + ".conv2", cout, cout)
        if cin != cout:
            conv(key + ".nin_shortcut", cout, cin, 1)

    def attn(key, c):
        norm(key + ".norm", c)
        for n in ("q", "k", "v", "proj_out"):
            conv(key + "." + n, c, c, 1)

    nlev = len(ch_mult)
    e = prefix + "encoder."
    conv(e + "conv_in", ch, 3)
    cur = ch
    for level, mult in enumerate(ch_mult):
        out_c = ch * mult
        for b in range(num_res):
            res(f"{e}down.{level}.block.{b}", cur, out_c)
            cur = out_c
        if level != nlev - 1:
            conv(f"{e}down.{level}.downsample.conv", cur, cur)
    res(e + "mid.block_1", cur, cur)
    attn(e + "mid.attn_1", cur)
    res(e + "mid.block_2", cur, cur)
    norm(e + "norm_out", cur)
    conv(e + "conv_out", z_channels * 2, cur)

    d = prefix + "decoder."
    conv(d + "conv_in", cur, z_channels)
    res(d + "mid.block_1", cur, cur)
    attn(d + "mid.attn_1", cur)
    res(d + "mid.block_2", cur, cur)
    for level in reversed(range(nlev)):
        out_c = ch * ch_mult[level]
        for b in range(num_res + 1):
            res(f"{d}up.{level}.block.{b}", cur, out_c)
            cur = out_c
        if level != 0:
            conv(f"{d}up.{level}.upsample.conv", cur, cur)
    norm(d + "norm_out", cur)
    conv(d + "conv_out", 3, cur)

    conv(prefix + "quant_conv", z_channels * 2, z_channels * 2, 1)
    conv(prefix + "post_quant_conv", z_channels, z_channels, 1)
    return sd


def synth_clip_sd(
    width: int = 768,
    layers: int = 12,
    vocab: int = 49408,
    fill: FillSpec = "zeros",
    seed: int = 3,
    prefix: str = "cond_stage_model.transformer.",
    text_projection: bool = False,
) -> Dict[str, np.ndarray]:
    f = _fill(fill, seed)
    sd: Dict[str, np.ndarray] = {}
    tm = prefix + "text_model."
    sd[tm + "embeddings.token_embedding.weight"] = f.w(vocab, width)
    sd[tm + "embeddings.position_embedding.weight"] = f.w(77, width)
    for i in range(layers):
        base = f"{tm}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[base + f"self_attn.{n}.weight"] = f.w(width, width)
            sd[base + f"self_attn.{n}.bias"] = f.zeros(width)
        for n in ("layer_norm1", "layer_norm2"):
            sd[base + n + ".weight"] = f.ones(width)
            sd[base + n + ".bias"] = f.zeros(width)
        sd[base + "mlp.fc1.weight"] = f.w(width * 4, width)
        sd[base + "mlp.fc1.bias"] = f.zeros(width * 4)
        sd[base + "mlp.fc2.weight"] = f.w(width, width * 4)
        sd[base + "mlp.fc2.bias"] = f.zeros(width)
    sd[tm + "final_layer_norm.weight"] = f.ones(width)
    sd[tm + "final_layer_norm.bias"] = f.zeros(width)
    if text_projection:
        sd[prefix + "text_projection.weight"] = f.w(width, width)
    return sd


def synth_sd15_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, np.ndarray]:
    """Full-size SD1.5: 320ch UNet, 768-wide CLIP-L×12, 128ch VAE."""
    sd = {}
    sd.update(synth_unet_sd(fill=fill, seed=seed + 1))
    sd.update(synth_vae_sd(fill=fill, seed=seed + 2))
    sd.update(synth_clip_sd(fill=fill, seed=seed + 3))
    return sd


def synth_sdxl_checkpoint(fill: FillSpec = "zeros", seed: int = 0,
                          transformer_depth=(0, 2, 10), middle_depth: int = 10,
                          clip_g_layers: int = 32) -> Dict[str, object]:
    """Full-size SDXL base: 320ch UNet mult(1,2,4) depths(0,2,10), dual TEs.
    The depths and CLIP-G's layer count may be cut; the widths stay."""
    sd: Dict[str, object] = {}
    sd.update(
        synth_unet_sd(
            channel_mult=(1, 2, 4),
            transformer_depth=tuple(transformer_depth),
            context_dim=2048,
            adm_in_channels=2816,
            middle_depth=middle_depth,
            fill=fill,
            seed=seed + 1,
        )
    )
    sd.update(synth_vae_sd(fill=fill, seed=seed + 2))
    sd.update(synth_clip_sd(fill=fill, seed=seed + 3, prefix="conditioner.embedders.0.transformer."))
    sd.update(_open_clip_text_sd(_fill(fill, seed + 4), "conditioner.embedders.1.model.",
                                 layers=clip_g_layers))
    return sd


def _open_clip_text_sd(f, prefix: str, width: int = 1280, layers: int = 32) -> Dict[str, object]:
    """An open_clip text tower in open_clip layout under `prefix`: OpenCLIP-bigG's
    by default, ViT-H/14's at width 1024 and 24 layers."""
    sd: Dict[str, object] = {}
    g = prefix
    sd[g + "positional_embedding"] = f.w(77, width)
    sd[g + "token_embedding.weight"] = f.w(49408, width)
    sd[g + "ln_final.weight"] = f.ones(width)
    sd[g + "ln_final.bias"] = f.zeros(width)
    sd[g + "text_projection"] = f.w(width, width)
    for i in range(layers):
        base = f"{g}transformer.resblocks.{i}."
        sd[base + "attn.in_proj_weight"] = f.w(width * 3, width)
        sd[base + "attn.in_proj_bias"] = f.zeros(width * 3)
        sd[base + "attn.out_proj.weight"] = f.w(width, width)
        sd[base + "attn.out_proj.bias"] = f.zeros(width)
        sd[base + "ln_1.weight"] = f.ones(width)
        sd[base + "ln_1.bias"] = f.zeros(width)
        sd[base + "ln_2.weight"] = f.ones(width)
        sd[base + "ln_2.bias"] = f.zeros(width)
        sd[base + "mlp.c_fc.weight"] = f.w(width * 4, width)
        sd[base + "mlp.c_fc.bias"] = f.zeros(width * 4)
        sd[base + "mlp.c_proj.weight"] = f.w(width, width * 4)
        sd[base + "mlp.c_proj.bias"] = f.zeros(width)
    return sd


def synth_sdxl_refiner_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, object]:
    """Full-size SDXL refiner (stabilityai sd_xl_refiner_1.0): 384ch UNet,
    mult (1,2,4,4), depths (0,4,4,0), middle depth 4, context 1280, adm
    2560; OpenCLIP-bigG alone, under `conditioner.embedders.0.model.`; the
    SDXL VAE."""
    sd: Dict[str, object] = {}
    sd.update(synth_unet_sd(model_channels=384, channel_mult=(1, 2, 4, 4),
                            transformer_depth=(0, 4, 4, 0), context_dim=1280,
                            adm_in_channels=2560, middle_depth=4, fill=fill, seed=seed + 1))
    sd.update(synth_vae_sd(fill=fill, seed=seed + 2))
    sd.update(_open_clip_text_sd(_fill(fill, seed + 4), "conditioner.embedders.0.model."))
    return sd


def synth_sd2_checkpoint(fill: FillSpec = "zeros", seed: int = 0,
                         v_prediction: bool = True) -> Dict[str, object]:
    """Full-size SD2.1 (stabilityai v2-inference-v.yaml): 320ch UNet, mult
    (1,2,4,4), depths (1,1,1,0), 64-wide heads, linear projections, context
    1024; OpenCLIP ViT-H/14's text tower (1024 wide, 24 layers) under
    `cond_stage_model.model.`; the 4-channel VAE. `v_prediction` adds the
    `v_pred` marker key that tells the loader the 768-v objective."""
    sd: Dict[str, object] = {}
    sd.update(synth_unet_sd(context_dim=1024, fill=fill, seed=seed + 1))
    sd.update(synth_vae_sd(fill=fill, seed=seed + 2))
    f = _fill(fill, seed + 3)
    sd.update(_open_clip_text_sd(f, "cond_stage_model.model.", width=1024, layers=24))
    if v_prediction:
        sd["v_pred"] = f.zeros()
    return sd


def synth_playground_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, object]:
    """Full-size Playground v2.5 (playgroundai/playground-v2.5-1024px-aesthetic):
    SDXL base's geometry, with the `edm_mean`/`edm_std` marker keys of its
    single-file export that tell the loader the EDM objective."""
    sd = synth_sdxl_checkpoint(fill=fill, seed=seed)
    f = _fill(fill, seed + 5)
    sd["edm_mean"] = f.zeros(4)
    sd["edm_std"] = f.ones(4)
    return sd


def synth_flux_sd(
    hidden: int = 3072,
    num_heads: int = 24,
    depth: int = 19,
    depth_single: int = 38,
    context_dim: int = 4096,
    pooled_dim: int = 768,
    in_channels: int = 64,
    guidance: bool = True,
    mlp_ratio: float = 4.0,
    fill: FillSpec = "zeros",
    seed: int = 5,
    prefix: str = "model.diffusion_model.",
):
    """Flux-format state dict (flux-dev defaults; pass smaller dims for tests)."""
    f = _fill(fill, seed)
    sd = {}
    mlp = int(hidden * mlp_ratio)
    head_dim = hidden // num_heads

    def lin(key, o, i):
        sd[key + ".weight"] = f.w(o, i)
        sd[key + ".bias"] = f.zeros(o)

    lin(prefix + "img_in", hidden, in_channels)
    lin(prefix + "txt_in", hidden, context_dim)
    lin(prefix + "time_in.in_layer", hidden, 256)
    lin(prefix + "time_in.out_layer", hidden, hidden)
    lin(prefix + "vector_in.in_layer", hidden, pooled_dim)
    lin(prefix + "vector_in.out_layer", hidden, hidden)
    if guidance:
        lin(prefix + "guidance_in.in_layer", hidden, 256)
        lin(prefix + "guidance_in.out_layer", hidden, hidden)

    for i in range(depth):
        b = f"{prefix}double_blocks.{i}."
        for s in ("img", "txt"):
            lin(b + f"{s}_mod.lin", hidden * 6, hidden)
            lin(b + f"{s}_attn.qkv", hidden * 3, hidden)
            sd[b + f"{s}_attn.norm.query_norm.scale"] = f.ones(head_dim)
            sd[b + f"{s}_attn.norm.key_norm.scale"] = f.ones(head_dim)
            lin(b + f"{s}_attn.proj", hidden, hidden)
            lin(b + f"{s}_mlp.0", mlp, hidden)
            lin(b + f"{s}_mlp.2", hidden, mlp)

    for i in range(depth_single):
        b = f"{prefix}single_blocks.{i}."
        lin(b + "linear1", hidden * 3 + mlp, hidden)
        lin(b + "linear2", hidden, hidden + mlp)
        sd[b + "norm.query_norm.scale"] = f.ones(head_dim)
        sd[b + "norm.key_norm.scale"] = f.ones(head_dim)
        lin(b + "modulation.lin", hidden * 3, hidden)

    lin(prefix + "final_layer.linear", in_channels, hidden)
    lin(prefix + "final_layer.adaLN_modulation.1", hidden * 2, hidden)
    return sd


def synth_mmdit_sd(
    hidden: int = 1536,
    depth: int = 24,
    context_dim: int = 4096,
    pooled_dim: int = 2048,
    in_channels: int = 16,
    patch: int = 2,
    pos_max: int = 192,
    qk_norm: bool = False,
    x_attn2: bool = False,
    fill: FillSpec = "zeros",
    seed: int = 6,
    prefix: str = "model.diffusion_model.",
):
    """SD3-format state dict (sd3-medium defaults). `qk_norm` adds SD3.5's
    q/k RMSNorm weights, `x_attn2` the x-only second attention of
    SD3.5-medium's MMDiT-X."""
    f = _fill(fill, seed)
    sd = {}
    mlp = hidden * 4

    def lin(key, o, i):
        sd[key + ".weight"] = f.w(o, i)
        sd[key + ".bias"] = f.zeros(o)

    sd[prefix + "x_embedder.proj.weight"] = f.w(hidden, in_channels, patch, patch)
    sd[prefix + "x_embedder.proj.bias"] = f.zeros(hidden)
    sd[prefix + "pos_embed"] = f.w(1, pos_max * pos_max, hidden)
    lin(prefix + "t_embedder.mlp.0", hidden, 256)
    lin(prefix + "t_embedder.mlp.2", hidden, hidden)
    lin(prefix + "y_embedder.mlp.0", hidden, pooled_dim)
    lin(prefix + "y_embedder.mlp.2", hidden, hidden)
    lin(prefix + "context_embedder", hidden, context_dim)

    for i in range(depth):
        pre_only = i == depth - 1
        for blk in ("context_block", "x_block"):
            b = f"{prefix}joint_blocks.{i}.{blk}."
            lin(b + "attn.qkv", hidden * 3, hidden)
            if qk_norm:
                sd[b + "attn.ln_q.weight"] = f.ones(hidden // (hidden // 64))
                sd[b + "attn.ln_k.weight"] = f.ones(hidden // (hidden // 64))
            if blk == "context_block" and pre_only:
                lin(b + "adaLN_modulation.1", hidden * 2, hidden)
                continue
            lin(b + "attn.proj", hidden, hidden)
            n_mod = 9 if (x_attn2 and blk == "x_block") else 6
            lin(b + "adaLN_modulation.1", hidden * n_mod, hidden)
            lin(b + "mlp.fc1", mlp, hidden)
            lin(b + "mlp.fc2", hidden, mlp)
            if x_attn2 and blk == "x_block":
                lin(b + "attn2.qkv", hidden * 3, hidden)
                lin(b + "attn2.proj", hidden, hidden)

    lin(prefix + "final_layer.linear", patch * patch * in_channels, hidden)
    lin(prefix + "final_layer.adaLN_modulation.1", hidden * 2, hidden)
    return sd


def synth_t5_sd(
    width: int = 4096,
    layers: int = 24,
    heads: int = 64,
    ff: int = 10240,
    vocab: int = 32128,
    fill: FillSpec = "zeros",
    seed: int = 7,
    prefix: str = "text_encoders.t5xxl.transformer.",
):
    f = _fill(fill, seed)
    sd = {}
    kv = 64 * heads

    def w(key, o, i):
        sd[key + ".weight"] = f.w(o, i)

    sd[prefix + "shared.weight"] = f.w(vocab, width)
    for i in range(layers):
        b = f"{prefix}encoder.block.{i}.layer."
        for n in ("q", "k", "v"):
            w(b + f"0.SelfAttention.{n}", kv, width)
        w(b + "0.SelfAttention.o", width, kv)
        if i == 0:
            sd[b + "0.SelfAttention.relative_attention_bias.weight"] = f.w(32, heads)
        sd[b + "0.layer_norm.weight"] = f.ones(width)
        w(b + "1.DenseReluDense.wi_0", ff, width)
        w(b + "1.DenseReluDense.wi_1", ff, width)
        w(b + "1.DenseReluDense.wo", width, ff)
        sd[b + "1.layer_norm.weight"] = f.ones(width)
    sd[prefix + "encoder.final_layer_norm.weight"] = f.ones(width)
    return sd


def synth_flux_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, object]:
    """Full-width Flux-dev merged checkpoint: the 19 + 38 block transformer
    (hidden 3072, 24 heads), the 16-channel VAE, CLIP-L and T5-XXL."""
    sd: Dict[str, object] = {}
    sd.update(synth_flux_sd(fill=fill, seed=seed + 5))
    sd.update(synth_vae_sd(z_channels=16, fill=fill, seed=seed + 2))
    sd.update(synth_clip_sd(fill=fill, seed=seed + 3, prefix="text_encoders.clip_l.transformer."))
    sd.update(synth_t5_sd(fill=fill, seed=seed + 7))
    return sd


def synth_sd3_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, object]:
    """Full-size SD3-medium single-file checkpoint (stabilityai
    stable-diffusion-3-medium): the 24-block MMDiT (hidden 1536, 24 heads,
    pos_embed_max_size 192, context 4096, pooled 2048), CLIP-L (768 × 12) and
    CLIP-G (1280 × 32, with its text projection) in HF layout, T5-XXL, and
    the 16-channel VAE."""
    sd: Dict[str, object] = {}
    sd.update(synth_mmdit_sd(fill=fill, seed=seed + 6))
    sd.update(synth_vae_sd(z_channels=16, fill=fill, seed=seed + 2))
    sd.update(synth_clip_sd(fill=fill, seed=seed + 3, prefix="text_encoders.clip_l.transformer."))
    sd.update(synth_clip_sd(width=1280, layers=32, fill=fill, seed=seed + 4,
                            prefix="text_encoders.clip_g.transformer.", text_projection=True))
    sd.update(synth_t5_sd(fill=fill, seed=seed + 7))
    return sd


def synth_chroma_sd(
    hidden: int = 3072,
    num_heads: int = 24,
    depth: int = 19,
    depth_single: int = 38,
    context_dim: int = 4096,
    approx_hidden: int = 5120,
    approx_layers: int = 5,
    fill: FillSpec = "zeros",
    seed: int = 8,
    prefix: str = "model.diffusion_model.",
):
    """Chroma-format state dict: Flux's blocks without their modulation
    linears, time, vector and guidance embedders, plus the
    `distilled_guidance_layer` Approximator (in 64 = 16 + 16 + 32)."""
    sd = synth_flux_sd(hidden=hidden, num_heads=num_heads, depth=depth,
                       depth_single=depth_single, context_dim=context_dim,
                       pooled_dim=16, guidance=False, fill=fill, seed=seed,
                       prefix=prefix)
    for k in list(sd):  # the flux-only modulation, vector and time paths
        if any(t in k for t in ("img_mod.lin", "txt_mod.lin", "modulation.lin",
                                "time_in.", "vector_in.", "adaLN_modulation")):
            del sd[k]
    f = _fill(fill, seed + 1)
    g = prefix + "distilled_guidance_layer."
    sd[g + "in_proj.weight"] = f.w(approx_hidden, 64)
    sd[g + "in_proj.bias"] = f.zeros(approx_hidden)
    for i in range(approx_layers):
        sd[g + f"layers.{i}.in_layer.weight"] = f.w(approx_hidden, approx_hidden)
        sd[g + f"layers.{i}.in_layer.bias"] = f.zeros(approx_hidden)
        sd[g + f"layers.{i}.out_layer.weight"] = f.w(approx_hidden, approx_hidden)
        sd[g + f"layers.{i}.out_layer.bias"] = f.zeros(approx_hidden)
        sd[g + f"norms.{i}.scale"] = f.ones(approx_hidden)
    sd[g + "out_proj.weight"] = f.w(hidden, approx_hidden)
    sd[g + "out_proj.bias"] = f.zeros(hidden)
    return sd


def synth_chroma_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, object]:
    """Full-width Chroma merged checkpoint (lodestones/Chroma): the 19 + 38
    block transformer (hidden 3072, 24 heads) with its 5120 × 5
    Approximator, the 16-channel VAE and T5-XXL (Chroma has no CLIP-L)."""
    sd: Dict[str, object] = {}
    sd.update(synth_chroma_sd(fill=fill, seed=seed + 8))
    sd.update(synth_vae_sd(z_channels=16, fill=fill, seed=seed + 2))
    sd.update(synth_t5_sd(fill=fill, seed=seed + 7))
    return sd


# -- kohya LoRA files -------------------------------------------------------------

# the trainers' prefix for each text engine of SD2, SDXL, Playground, SD3, Flux and Chroma (SD1.5
# names its one CLIP-L `lora_te_`)
KOHYA_TE_PREFIX = {"clip_h": "lora_te_", "clip_l": "lora_te1_", "clip_g": "lora_te2_",
                   "t5xxl": "lora_te3_"}


def kohya_lora_targets(shapes: Dict[str, Tuple[int, ...]], prefix: str,
                       select: Optional[Callable[[str], bool]] = None
                       ) -> Dict[str, Tuple[int, int]]:
    """{kohya module name: (out, in)} for every 2-D `.weight` of a flat
    {dotted key: shape} map (a linear's): the key without `.weight`, its dots
    made underscores, after `prefix` ("lora_unet_", "lora_te1_", ...);
    `select(key)` narrows the keys."""
    out = {}
    for key, shape in shapes.items():
        if key.endswith(".weight") and len(shape) == 2 and (select is None or select(key)):
            out[prefix + key[:-len(".weight")].replace(".", "_")] = (shape[0], shape[1])
    return out


def synth_kohya_lora(targets: Dict[str, Tuple[int, int]], rank: int = 4,
                     alpha: Optional[float] = None, fill: FillSpec = "random", seed: int = 0,
                     scale: float = 0.05) -> Dict[str, object]:
    """A LoRA in kohya's layout over `targets` ({module name: (out, in)}):
    `lora_up` [out, rank], `lora_down` [rank, in], N(0, scale²), and `alpha`
    where given (ΔW = up·down·alpha/rank)."""
    f = _fill(fill, seed)
    sd: Dict[str, object] = {}
    for base, (o, i) in targets.items():
        sd[base + ".lora_up.weight"] = f.w(o, rank, scale=scale)
        sd[base + ".lora_down.weight"] = f.w(rank, i, scale=scale)
        if alpha is not None:
            sd[base + ".alpha"] = np.full((), alpha, np.float32)
    return sd


# -- the bitsandbytes serialized layout ---------------------------------------

# bitsandbytes' FP4 (e2m1) code table, by code
BNB_FP4_CODE = (0.0, 0.0052083333, 0.6666667, 1.0, 0.33333334, 0.5, 0.16666667, 0.25,
                -0.0, -0.0052083333, -0.6666667, -1.0, -0.33333334, -0.5, -0.16666667, -0.25)
BNB_NESTED_BLOCK = 256


def bnb_dynamic_map() -> np.ndarray:
    """bitsandbytes' signed 8-bit dynamic map (create_dynamic_map(signed=True)),
    the code table of a double-quantized absmax: 256 values in [-1, 1]."""
    data = []
    for i in range(7):  # 7 exponent steps, 2^i fractions each, both signs
        bounds = np.linspace(0.1, 1.0, 2 ** i + 1, dtype=np.float32)
        means = (bounds[:-1] + bounds[1:]) / 2.0
        data += list((10.0 ** (i - 6)) * means) + list(-(10.0 ** (i - 6)) * means)
    data += [0.0, 1.0]
    return np.sort(np.asarray(data, np.float32))


def _nearest(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Index of the nearest entry of a sorted table, for every value of v."""
    mids = (table[:-1] + table[1:]) * 0.5
    return torch.searchsorted(mids, v.contiguous())


def bnb_serialize(key: str, weight, qtype: str = "nf4", double_quant: bool = False,
                  blocksize: int = 64) -> Dict[str, torch.Tensor]:
    """A weight → the tensors bitsandbytes saves for a Params4bit `{key}`:
    `{key}` uint8 [n/2, 1] (the first element in the high nibble),
    `{key}.absmax` (f32, or with `double_quant` uint8 codes with
    `{key}.nested_absmax` and `{key}.nested_quant_map`), `{key}.quant_map`
    and `{key}.quant_state.bitsandbytes__{qtype}` (its JSON as uint8). NF4
    codes are the port's quantizer's (ops/quant.py); FP4 takes the nearest
    of bitsandbytes' FP4 table. Tensors stay on the weight's device."""
    from ..ops.quant import NF4_CODE, quantize_nf4

    w = weight.materialize() if isinstance(weight, LazyTensor) else torch.as_tensor(weight)
    dev = w.device
    if qtype == "nf4":
        leaf = quantize_nf4(w, block=blocksize)
        codes, absmax, table = leaf.codes, leaf.scales, NF4_CODE
    elif qtype == "fp4":
        blocks = w.reshape(-1, blocksize).float()
        absmax = blocks.abs().amax(dim=1)
        scaled = blocks / torch.where(absmax == 0, torch.ones_like(absmax), absmax)[:, None]
        order = sorted(range(16), key=lambda i: BNB_FP4_CODE[i])
        table_sorted = torch.tensor([BNB_FP4_CODE[i] for i in order], device=dev)
        idx = torch.tensor(order, device=dev)[_nearest(table_sorted, scaled)].to(torch.uint8)
        flat = idx.reshape(-1)
        codes, table = (flat[0::2] << 4) | flat[1::2], BNB_FP4_CODE
    else:
        raise ValueError(f"bitsandbytes quant type {qtype!r}: nf4 or fp4")
    meta = {"quant_type": qtype, "blocksize": blocksize, "dtype": "bfloat16",
            "shape": list(w.shape)}
    out = {key: codes.reshape(-1, 1),
           key + ".quant_map": torch.tensor(table, dtype=torch.float32, device=dev)}
    if double_quant:
        offset = float(absmax.mean())
        centered = absmax - offset
        pad = (-centered.numel()) % BNB_NESTED_BLOCK
        blocks = torch.cat([centered, centered.new_zeros(pad)]).reshape(-1, BNB_NESTED_BLOCK)
        nested = blocks.abs().amax(dim=1)
        nested = torch.where(nested == 0, torch.ones_like(nested), nested)
        nmap = torch.from_numpy(bnb_dynamic_map()).to(dev)
        codes8 = _nearest(nmap, blocks / nested[:, None]).to(torch.uint8)
        out[key + ".absmax"] = codes8.reshape(-1)[: centered.numel()]
        out[key + ".nested_absmax"] = nested
        out[key + ".nested_quant_map"] = nmap
        meta.update(nested_blocksize=BNB_NESTED_BLOCK, nested_offset=offset,
                    nested_dtype="float32")
    else:
        out[key + ".absmax"] = absmax
    text = json.dumps(meta).encode()
    out[key + f".quant_state.bitsandbytes__{qtype}"] = torch.tensor(list(text), dtype=torch.uint8)
    return out


def synth_controlnet_sd(
    model_channels: int = 320,
    channel_mult: Sequence[int] = (1, 2, 4),
    num_res_blocks: int = 2,
    transformer_depth: Sequence[int] = (0, 2, 10),
    context_dim: int = 2048,
    adm_in_channels: Optional[int] = 2816,
    fill: FillSpec = "zeros",
    seed: int = 7,
) -> Dict[str, object]:
    """Full-size cldm ControlNet state dict (SDXL geometry by default):
    the UNet encoder copy + zero convs + canonical 8-conv hint ladder
    (reference backend/nn/cnets/cldm.py:7 ControlNet.__init__)."""
    f = _fill(fill, seed)
    sd = {
        k: v for k, v in synth_unet_sd(
            model_channels=model_channels, channel_mult=channel_mult,
            num_res_blocks=num_res_blocks, transformer_depth=transformer_depth,
            context_dim=context_dim, adm_in_channels=adm_in_channels,
            fill=fill, seed=seed, prefix="",
        ).items()
        if k.startswith(("time_embed", "label_emb", "input_blocks", "middle_block"))
    }

    def conv(key, o, i, k=3):
        sd[key + ".weight"] = f.w(o, i, k, k)
        sd[key + ".bias"] = f.zeros(o)

    # per-input-block output channels: conv_in, then res blocks + downsamples
    chans = [model_channels]
    ch = model_channels
    for li, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            ch = model_channels * mult
            chans.append(ch)
        if li != len(channel_mult) - 1:
            chans.append(ch)  # downsample block keeps channels
    for i, c in enumerate(chans):
        conv(f"zero_convs.{i}.0", c, c, 1)
    conv("middle_block_out.0", ch, ch, 1)
    ladder = [(16, 3, 1), (16, 16, 1), (32, 16, 2), (32, 32, 1),
              (96, 32, 2), (96, 96, 1), (256, 96, 2), (model_channels, 256, 1)]
    for pos, (o, i, _s) in enumerate(ladder):
        conv(f"input_hint_block.{pos * 2}", o, i)
    return sd


# The image encoder and adapter of an SDXL IP-Adapter (the port's own: the
# reference's bench.py makes random IP layers and skips the encoder).

# SDXL's cross-attention widths in forward order: input level 1 (2 blocks ×
# depth 2) at 640, input level 2 (2 × 10), the middle (10) and output level 2
# (3 × 10) at 1280, output level 1 (3 × 2) at 640
SDXL_ATTN2_WIDTHS = (640,) * 4 + (1280,) * 60 + (640,) * 6


def synth_clip_vision_sd(
    width: int = 1280,
    layers: int = 32,
    mlp: int = 5120,
    patch: int = 14,
    image: int = 224,
    projection: int = 1024,
    fill: FillSpec = "zeros",
    seed: int = 11,
) -> Dict[str, object]:
    """HF CLIPVisionModelWithProjection state dict; the defaults are laion
    CLIP-ViT-H-14-laion2B-s32B-b79K's vision tower (16 heads, gelu: the
    heads and activation are not stored)."""
    f = _fill(fill, seed)
    sd: Dict[str, object] = {}
    v = "vision_model."

    def lin(key, o, i, bias=True):
        sd[key + ".weight"] = f.w(o, i)
        if bias:
            sd[key + ".bias"] = f.zeros(o)

    def norm(key):
        sd[key + ".weight"] = f.ones(width)
        sd[key + ".bias"] = f.zeros(width)

    sd[v + "embeddings.patch_embedding.weight"] = f.w(width, 3, patch, patch)
    sd[v + "embeddings.class_embedding"] = f.w(width)
    sd[v + "embeddings.position_embedding.weight"] = f.w((image // patch) ** 2 + 1, width)
    norm(v + "pre_layrnorm")
    for i in range(layers):
        base = f"{v}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(base + "self_attn." + n, width, width)
        norm(base + "layer_norm1")
        norm(base + "layer_norm2")
        lin(base + "mlp.fc1", mlp, width)
        lin(base + "mlp.fc2", width, mlp)
    norm(v + "post_layernorm")
    lin("visual_projection", projection, width, bias=False)
    return sd


def synth_ip_adapter_sd(
    clip_dim: int = 1024,
    context_dim: int = 2048,
    n_tokens: int = 4,
    widths: Sequence[int] = SDXL_ATTN2_WIDTHS,
    fill: FillSpec = "zeros",
    seed: int = 12,
) -> Dict[str, object]:
    """A simple (non-plus) IP-Adapter state dict; the defaults are h94's
    ip-adapter_sdxl_vit-h: image_proj 1024 → 4 tokens × 2048 and a LayerNorm,
    then to_k_ip/to_v_ip (context → the layer's width) for each
    cross-attention in forward order, numbered 1, 3, 5, …"""
    f = _fill(fill, seed)
    sd: Dict[str, object] = {
        "image_proj.proj.weight": f.w(n_tokens * context_dim, clip_dim),
        "image_proj.proj.bias": f.zeros(n_tokens * context_dim),
        "image_proj.norm.weight": f.ones(context_dim),
        "image_proj.norm.bias": f.zeros(context_dim),
    }
    for i, width in enumerate(widths):
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"ip_adapter.{2 * i + 1}.{name}.weight"] = f.w(width, context_dim)
    return sd


def _synth_perceiver(sd: Dict[str, object], f, prefix: str, dim: int, depth: int,
                     in_dim: int, out_dim: int, queries: int = 0, ff_mult: int = 4) -> None:
    """A perceiver resampler under `prefix` (IPAdapterPlus resampler.py's keys):
    proj_in in_dim → dim, `depth` layers of (norm1, norm2, to_q, to_kv, to_out;
    LayerNorm, Linear ×ff_mult, Linear), proj_out dim → out_dim, norm_out;
    with `queries`, its learned latents [1, queries, dim]."""
    def norm(key, d):
        sd[key + ".weight"] = f.ones(d)
        sd[key + ".bias"] = f.zeros(d)

    if queries:
        sd[prefix + "latents"] = f.w(1, queries, dim)
    sd[prefix + "proj_in.weight"], sd[prefix + "proj_in.bias"] = f.w(dim, in_dim), f.zeros(dim)
    for i in range(depth):
        b = f"{prefix}layers.{i}."
        norm(b + "0.norm1", dim)
        norm(b + "0.norm2", dim)
        sd[b + "0.to_q.weight"] = f.w(dim, dim)
        sd[b + "0.to_kv.weight"] = f.w(2 * dim, dim)
        sd[b + "0.to_out.weight"] = f.w(dim, dim)
        norm(b + "1.0", dim)
        sd[b + "1.1.weight"] = f.w(ff_mult * dim, dim)
        sd[b + "1.3.weight"] = f.w(dim, ff_mult * dim)
    sd[prefix + "proj_out.weight"] = f.w(out_dim, dim)
    sd[prefix + "proj_out.bias"] = f.zeros(out_dim)
    norm(prefix + "norm_out", out_dim)


def synth_faceid_sd(
    id_dim: int = 512,
    context_dim: int = 2048,
    n_tokens: int = 4,
    widths: Sequence[int] = SDXL_ATTN2_WIDTHS,
    plus: bool = False,
    clip_dim: int = 1280,
    depth: int = 4,
    fill: FillSpec = "zeros",
    seed: int = 14,
) -> Dict[str, object]:
    """An IP-Adapter FaceID state dict; the defaults are h94's
    ip-adapter-faceid_sdxl: image_proj the MLP id_dim → 2·id_dim → n_tokens ×
    context and a LayerNorm, then to_k_ip/to_v_ip for each cross-attention,
    numbered 0, 1, 2, …. `plus` adds FaceID-Plus's face perceiver (dim =
    context, `depth` layers, heads of 64) over CLIP-ViT-H's hidden states."""
    f = _fill(fill, seed)
    sd: Dict[str, object] = {
        "image_proj.proj.0.weight": f.w(2 * id_dim, id_dim),
        "image_proj.proj.0.bias": f.zeros(2 * id_dim),
        "image_proj.proj.2.weight": f.w(n_tokens * context_dim, 2 * id_dim),
        "image_proj.proj.2.bias": f.zeros(n_tokens * context_dim),
        "image_proj.norm.weight": f.ones(context_dim),
        "image_proj.norm.bias": f.zeros(context_dim),
    }
    if plus:
        _synth_perceiver(sd, f, "image_proj.perceiver_resampler.", context_dim, depth, clip_dim,
                         context_dim)
    for i, width in enumerate(widths):
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"ip_adapter.{i}.{name}.weight"] = f.w(width, context_dim)
    return sd


def synth_instantid_sd(
    id_dim: int = 512,
    dim: int = 1280,
    depth: int = 4,
    queries: int = 16,
    context_dim: int = 2048,
    widths: Sequence[int] = SDXL_ATTN2_WIDTHS,
    fill: FillSpec = "zeros",
    seed: int = 15,
) -> Dict[str, object]:
    """InstantID's ip-adapter.bin: image_proj a Resampler (dim 1280, depth 4,
    heads of 64, 16 queries, the 512-d id embedding in, context out), then
    to_k_ip/to_v_ip for each cross-attention, numbered 1, 3, 5, …"""
    f = _fill(fill, seed)
    sd: Dict[str, object] = {}
    _synth_perceiver(sd, f, "image_proj.", dim, depth, id_dim, context_dim, queries=queries)
    for i, width in enumerate(widths):
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"ip_adapter.{2 * i + 1}.{name}.weight"] = f.w(width, context_dim)
    return sd


def synth_photomaker_sd(
    width: int = 1024,
    layers: int = 24,
    mlp: int = 4096,
    patch: int = 14,
    context_dim: int = 2048,
    qformer_dim: int = 0,
    qformer_tokens: int = 2,
    id_dim: int = 512,
    fill: FillSpec = "zeros",
    seed: int = 16,
) -> Dict[str, object]:
    """A PhotoMaker checkpoint in forge_tpu's layout (pipeline/photomaker.py):
    the id encoder's CLIP-ViT-L/14 tower under `id_encoder.vision_model.`,
    `id_encoder.visual_projection` width → context, the fuse module's
    mlp1 (2·context → context → context), mlp2 and LayerNorm; with
    `qformer_dim`, a one-layer qformer over the 512-d face embedding."""
    f = _fill(fill, seed)
    vision = synth_clip_vision_sd(width=width, layers=layers, mlp=mlp, patch=patch,
                                  projection=context_dim, fill=fill, seed=seed + 1)
    sd: Dict[str, object] = {"id_encoder." + k: v for k, v in vision.items()}
    if qformer_dim:
        _synth_perceiver(sd, f, "id_encoder.qformer.", qformer_dim, 1, id_dim, context_dim)
        sd["id_encoder.qformer.latents"] = f.w(qformer_tokens, qformer_dim)
    fm = "id_encoder.fuse_module."
    for key, (o, i) in (("mlp1.0", (context_dim, 2 * context_dim)),
                        ("mlp1.2", (context_dim, context_dim)),
                        ("mlp2.0", (context_dim, context_dim)),
                        ("mlp2.2", (context_dim, context_dim))):
        sd[fm + key + ".weight"], sd[fm + key + ".bias"] = f.w(o, i), f.zeros(o)
    sd[fm + "layer_norm.weight"], sd[fm + "layer_norm.bias"] = (f.ones(context_dim),
                                                                f.zeros(context_dim))
    return sd


def synth_esrgan_sd(num_feat: int = 64, num_block: int = 23, num_grow: int = 32,
                    scale: int = 4, old_layout: bool = False, fill: FillSpec = "zeros",
                    seed: int = 13) -> Dict[str, object]:
    """ESRGAN's RRDBNet state dict; the defaults are RealESRGAN_x4plus's
    (64 features, 23 RRDBs, growth 32, ×4). `old_layout` writes the old
    ESRGAN `model.N` keys (model.1.sub.N.RDBk.convj.0 for the body,
    model.1.sub.{num_block} for conv_body; ×4 only) in place of the new names."""
    f = _fill(fill, seed)
    sd: Dict[str, object] = {}

    def conv(key, o, i):
        sd[key + ".weight"] = f.w(o, i, 3, 3)
        sd[key + ".bias"] = f.zeros(o)

    names = {"conv_first": "model.0", "conv_body": f"model.1.sub.{num_block}",
             "conv_up1": "model.3", "conv_up2": "model.6", "conv_hr": "model.8",
             "conv_last": "model.10"} if old_layout else {}
    conv(names.get("conv_first", "conv_first"), num_feat, 3)
    for b in range(num_block):
        for r in range(1, 4):
            for c in range(1, 6):
                key = (f"model.1.sub.{b}.RDB{r}.conv{c}.0" if old_layout
                       else f"body.{b}.rdb{r}.conv{c}")
                conv(key, num_feat if c == 5 else num_grow, num_feat + (c - 1) * num_grow)
    conv(names.get("conv_body", "conv_body"), num_feat, num_feat)
    for up in ("conv_up1", "conv_up2")[:{2: 1, 4: 2}[scale]]:
        conv(names.get(up, up), num_feat, num_feat)
    conv(names.get("conv_hr", "conv_hr"), num_feat, num_feat)
    conv(names.get("conv_last", "conv_last"), 3, num_feat)
    return sd


def synth_taesd_sd(latent_channels: int = 4, fill: FillSpec = "zeros",
                   seed: int = 14, scale: float = 0.045) -> Dict[str, object]:
    """A TAESD state dict in the `.pth` files' layout (taesd and taesdxl at 4
    latent channels; taesd3 and taef1 at 16): `decoder.<i>.…` and
    `encoder.<i>.…` by `nn.Sequential` index, 64 channels, OIHW kernels, the
    residual blocks' convs at 0, 2 and 4, the upsample and stride-2 convs
    without bias. Weights are N(0, scale²): at 0.045 the decoder's RGB
    spreads over [0, 0.5] and no residual stack blows up."""
    f = (DeviceFill(fill.device, fill.seed, scale).seeded(seed) if isinstance(fill, DeviceFill)
         else _Fill(fill, seed, scale))
    sd: Dict[str, object] = {}

    def conv(key, o, i, bias=True):
        sd[key + ".weight"] = f.w(o, i, 3, 3)
        if bias:
            sd[key + ".bias"] = f.zeros(o)

    def block(key):
        for j in (0, 2, 4):
            conv(f"{key}.conv.{j}", 64, 64)

    conv("decoder.1", 64, latent_channels)
    for i in (3, 4, 5, 8, 9, 10, 13, 14, 15, 18):
        block(f"decoder.{i}")
    for i in (7, 12, 17):
        conv(f"decoder.{i}", 64, 64, bias=False)
    conv("decoder.19", 3, 64)
    conv("encoder.0", 64, 3)
    for i in (1, 3, 4, 5, 7, 8, 9, 11, 12, 13):
        block(f"encoder.{i}")
    for i in (2, 6, 10):
        conv(f"encoder.{i}", 64, 64, bias=False)
    conv("encoder.14", latent_channels, 64)
    return sd


# -- restoration networks: upscalers and face restorers, in their released files' key spaces.
# Weights are N(0, (gain/√fan_in)²) (`_Net.w`), so activations keep their scale through the
# residual stacks; attention bias tables N(0, 0.02²); norms at weight 1, bias 0.


class _Net:
    """A state dict under construction with fan-in scaled weights."""

    def __init__(self, fill: FillSpec, seed: int, gain: float = 1.0):
        self.f = _fill(fill, seed)
        self.gain = gain
        self.sd: Dict[str, object] = {}

    def w(self, *shape):
        return self.f.w(*shape, scale=self.gain / float(np.sqrt(np.prod(shape[1:]))))

    def conv(self, key, o, i, k=3, bias=True):
        self.sd[key + ".weight"] = self.w(o, i, k, k)
        if bias:
            self.sd[key + ".bias"] = self.f.zeros(o)

    def linear(self, key, o, i, bias=True):
        self.sd[key + ".weight"] = self.w(o, i)
        if bias:
            self.sd[key + ".bias"] = self.f.zeros(o)

    def norm(self, key, c):
        self.sd[key + ".weight"], self.sd[key + ".bias"] = self.f.ones(c), self.f.zeros(c)

    def bn(self, key, c):
        self.norm(key, c)
        self.sd[key + ".running_mean"], self.sd[key + ".running_var"] = (self.f.zeros(c),
                                                                           self.f.ones(c))

    def table(self, key, *shape, scale=0.02):
        self.sd[key] = self.f.w(*shape, scale=scale)


def _swin_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _swin_attn_mask(img_size: int, ws: int) -> np.ndarray:
    img = np.zeros((img_size, img_size), np.float32)
    cnt, shift = 0, ws // 2
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(img_size // ws, ws, img_size // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


def _upsample_tail(n: _Net, embed: int, num_feat: int, scale: int, upsampler: str) -> None:
    n.conv("conv_after_body", embed, embed)
    if upsampler == "nearest+conv":
        n.conv("conv_before_upsample.0", num_feat, embed)
        for key in ("conv_up1", "conv_up2")[: 2 if scale == 4 else 1]:
            n.conv(key, num_feat, num_feat)
        n.conv("conv_hr", num_feat, num_feat)
    else:  # pixelshuffle: a conv to 4·num_feat and a ×2 shuffle, twice for ×4
        n.conv("conv_before_upsample.0", num_feat, embed)
        for i in range({2: 1, 4: 2, 8: 3}[scale]):
            n.conv(f"upsample.{2 * i}", 4 * num_feat, num_feat)
    n.conv("conv_last", 3, num_feat)


def synth_swinir_sd(embed: int = 180, depths: Sequence[int] = (6,) * 6, heads: int = 6,
                    window: int = 8, mlp_ratio: float = 2.0, num_feat: int = 64, scale: int = 4,
                    upsampler: str = "nearest+conv", resi_connection: str = "1conv",
                    img_size: int = 64, fill: FillSpec = "random", seed: int = 20) -> Dict[str, object]:
    """SwinIR (network_swinir.py) as its released files hold it; the defaults
    are 003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN's (embed 180, six RSTBs
    of six blocks, six heads, window 8, MLP ×2, "nearest+conv", 1conv), with
    the `relative_position_index` and shifted blocks' `attn_mask` buffers
    (at `img_size`, as upstream registers them)."""
    n = _Net(fill, seed)
    hidden = int(embed * mlp_ratio)
    n.conv("conv_first", embed, 3)
    n.norm("patch_embed.norm", embed)
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}."
            n.norm(b + "norm1", embed)
            n.table(b + "attn.relative_position_bias_table", (2 * window - 1) ** 2, heads)
            n.sd[b + "attn.relative_position_index"] = _swin_index(window)
            n.linear(b + "attn.qkv", 3 * embed, embed)
            n.linear(b + "attn.proj", embed, embed)
            n.norm(b + "norm2", embed)
            n.linear(b + "mlp.fc1", hidden, embed)
            n.linear(b + "mlp.fc2", embed, hidden)
            if j % 2:
                n.sd[b + "attn_mask"] = _swin_attn_mask(img_size, window)
        if resi_connection == "1conv":
            n.conv(f"layers.{i}.conv", embed, embed)
        else:  # 3conv: conv 3×3 to embed/4, 1×1, 3×3 back
            n.conv(f"layers.{i}.conv.0", embed // 4, embed)
            n.conv(f"layers.{i}.conv.2", embed // 4, embed // 4, k=1)
            n.conv(f"layers.{i}.conv.4", embed, embed // 4)
    n.norm("norm", embed)
    _upsample_tail(n, embed, num_feat, scale, upsampler)
    return n.sd


def synth_hat_sd(embed: int = 180, depths: Sequence[int] = (6,) * 6, heads: int = 6,
                 window: int = 16, overlap_ratio: float = 0.5, compress_ratio: int = 3,
                 squeeze_factor: int = 30, mlp_ratio: float = 2.0, num_feat: int = 64,
                 scale: int = 4, fill: FillSpec = "random", seed: int = 21) -> Dict[str, object]:
    """HAT (hat_arch.py); the defaults are HAT_SRx4's (embed 180, six RHAGs
    of six blocks, six heads, window 16, overlap 0.5, compress 3, squeeze
    30, pixelshuffle ×4), with its top-level index buffers."""
    n = _Net(fill, seed)
    hidden = int(embed * mlp_ratio)
    owin = int(overlap_ratio * window) + window
    cab, sq = embed // compress_ratio, embed // squeeze_factor
    n.conv("conv_first", embed, 3)
    n.norm("patch_embed.norm", embed)
    n.sd["relative_position_index_SA"] = _swin_index(window)
    co = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(owin), np.arange(owin), indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0) + (window - 1)
    n.sd["relative_position_index_OCA"] = (rel[..., 0] * (window + owin - 1)
                                           + rel[..., 1]).astype(np.int64)
    for i, depth in enumerate(depths):
        g = f"layers.{i}.residual_group."
        for j in range(depth):
            b = g + f"blocks.{j}."
            n.norm(b + "norm1", embed)
            n.table(b + "attn.relative_position_bias_table", (2 * window - 1) ** 2, heads)
            n.linear(b + "attn.qkv", 3 * embed, embed)
            n.linear(b + "attn.proj", embed, embed)
            n.conv(b + "conv_block.cab.0", cab, embed)
            n.conv(b + "conv_block.cab.2", embed, cab)
            n.conv(b + "conv_block.cab.3.attention.1", sq, embed, k=1)
            n.conv(b + "conv_block.cab.3.attention.3", embed, sq, k=1)
            n.norm(b + "norm2", embed)
            n.linear(b + "mlp.fc1", hidden, embed)
            n.linear(b + "mlp.fc2", embed, hidden)
        o = g + "overlap_attn."
        n.norm(o + "norm1", embed)
        n.linear(o + "qkv", 3 * embed, embed)
        n.table(o + "relative_position_bias_table", (window + owin - 1) ** 2, heads)
        n.linear(o + "proj", embed, embed)
        n.norm(o + "norm2", embed)
        n.linear(o + "mlp.fc1", hidden, embed)
        n.linear(o + "mlp.fc2", embed, hidden)
        n.conv(f"layers.{i}.conv", embed, embed)
    n.norm("norm", embed)
    _upsample_tail(n, embed, num_feat, scale, "pixelshuffle")
    return n.sd


def synth_dat_sd(embed: int = 180, depths: Sequence[int] = (6,) * 6, heads: int = 6,
                 expansion: float = 4.0, num_feat: int = 64, scale: int = 4,
                 fill: FillSpec = "random", seed: int = 22) -> Dict[str, object]:
    """DAT (dat_arch.py); the defaults are DAT_x4's (embed 180, six groups of
    six blocks, six heads, split 8 × 32, expansion 4, pixelshuffle ×4).
    Even blocks are spatial (two axial branches, each with its dynamic
    position bias MLP of width embed/2/4/4), odd ones channel attention."""
    n = _Net(fill, seed)
    hidden = int(embed * expansion)
    pos = (embed // 2 // 4) // 4
    n.conv("conv_first", embed, 3)
    n.norm("before_RG.1", embed)
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}."
            n.norm(b + "norm1", embed)
            n.linear(b + "attn.qkv", 3 * embed, embed)
            n.linear(b + "attn.proj", embed, embed)
            if j % 2:
                n.sd[b + "attn.temperature"] = n.f.ones(heads, 1, 1)
            else:
                for a in (0, 1):
                    p = b + f"attn.attns.{a}.pos."
                    n.linear(p + "pos_proj", pos, 2)
                    for stage in ("pos1", "pos2", "pos3"):
                        n.norm(p + stage + ".0", pos)
                        n.linear(p + stage + ".2", heads // 2 if stage == "pos3" else pos, pos)
            n.conv(b + "attn.dwconv.0", embed, 1)
            n.bn(b + "attn.dwconv.1", embed)
            n.conv(b + "attn.channel_interaction.1", embed // 8, embed, k=1)
            n.bn(b + "attn.channel_interaction.2", embed // 8)
            n.conv(b + "attn.channel_interaction.4", embed, embed // 8, k=1)
            n.conv(b + "attn.spatial_interaction.0", embed // 16, embed, k=1)
            n.bn(b + "attn.spatial_interaction.1", embed // 16)
            n.conv(b + "attn.spatial_interaction.3", 1, embed // 16, k=1)
            n.norm(b + "norm2", embed)
            n.linear(b + "ffn.fc1", hidden, embed)
            n.norm(b + "ffn.sg.norm", hidden // 2)
            n.conv(b + "ffn.sg.conv", hidden // 2, 1)
            n.linear(b + "ffn.fc2", embed, hidden // 2)
        n.conv(f"layers.{i}.conv", embed, embed)
    n.norm("norm", embed)
    _upsample_tail(n, embed, num_feat, scale, "pixelshuffle")
    return n.sd


def synth_scunet_sd(dim: int = 64, config: Sequence[int] = (4,) * 7, head_dim: int = 32,
                    window: int = 8, fill: FillSpec = "random", seed: int = 23) -> Dict[str, object]:
    """SCUNet (network_scunet.py); the defaults are scunet_color_real_psnr's
    (dim 64, config [4]×7, head dim 32, window 8). `relative_position_params`
    is written [(2·window−1)², heads], the layout the reference reads
    (upstream's files hold it [heads, 2·window−1, 2·window−1]). Its conv
    branches have no norm: weights at half the gain keep the UNet's output
    in range."""
    n = _Net(fill, seed, gain=0.5)

    def blocks(stage, channels, count, first):
        half = channels // 2
        for k in range(first, first + count):
            b = f"{stage}.{k}."
            n.conv(b + "conv1_1", channels, channels, k=1)
            n.conv(b + "conv1_2", channels, channels, k=1)
            n.conv(b + "conv_block.0", half, half, bias=False)
            n.conv(b + "conv_block.2", half, half, bias=False)
            n.norm(b + "trans_block.ln1", half)
            n.linear(b + "trans_block.msa.embedding_layer", 3 * half, half)
            n.table(b + "trans_block.msa.relative_position_params", (2 * window - 1) ** 2,
                    half // head_dim)
            n.linear(b + "trans_block.msa.linear", half, half)
            n.norm(b + "trans_block.ln2", half)
            n.linear(b + "trans_block.mlp.0", 4 * half, half)
            n.linear(b + "trans_block.mlp.2", half, 4 * half)

    n.conv("m_head.0", dim, 3, bias=False)
    for s, (stage, mult) in enumerate((("m_down1", 1), ("m_down2", 2), ("m_down3", 4))):
        blocks(stage, dim * mult, config[s], 0)
        n.conv(f"{stage}.{config[s]}", 2 * dim * mult, dim * mult, k=2, bias=False)
    blocks("m_body", 8 * dim, config[3], 0)
    for s, (stage, mult) in enumerate((("m_up3", 4), ("m_up2", 2), ("m_up1", 1))):
        n.sd[f"{stage}.0.weight"] = n.w(2 * dim * mult, dim * mult, 2, 2)  # transposed [I,O,k,k]
        blocks(stage, dim * mult, config[4 + s], 1)
    n.conv("m_tail.0", 3, dim, bias=False)
    return n.sd


def synth_codeformer_sd(nf: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                        res_blocks: int = 2, emb_dim: int = 256, codebook: int = 1024,
                        dim_embd: int = 512, n_layers: int = 9, img_size: int = 512,
                        connect: Sequence[int] = (32, 64, 128, 256),
                        fill: FillSpec = "random", seed: int = 24) -> Dict[str, object]:
    """CodeFormer (codeformer_arch.py, vqgan_arch.py); the defaults are
    codeformer-v0.1.0's: a VQGAN of nf 64, ch_mult [1,2,2,4,4,8], two res
    blocks a level and attention at 16², a 1024 × 256 codebook, a 9-layer
    transformer 512 wide (MLP 1024) over the 16² latent, and the SFT fuse
    blocks at 32, 64, 128 and 256 (channels as `fuse_convs_dict` has them)."""
    n = _Net(fill, seed)
    levels = len(ch_mult)
    attn_res = img_size // 2 ** (levels - 1)

    def res(key, cin, cout):
        n.norm(key + ".norm1", cin)
        n.conv(key + ".conv1", cout, cin)
        n.norm(key + ".norm2", cout)
        n.conv(key + ".conv2", cout, cout)
        if cin != cout:
            n.conv(key + ".conv_out", cout, cin, k=1)

    def attn(key, c):
        n.norm(key + ".norm", c)
        for name in ("q", "k", "v", "proj_out"):
            n.conv(f"{key}.{name}", c, c, k=1)

    size = img_size
    enc = "encoder.blocks."
    n.conv(enc + "0", nf, 3)
    i, cin = 1, nf
    ins = (1,) + tuple(ch_mult)
    channels_at = {}
    for lvl in range(levels):
        cin, cout = nf * ins[lvl], nf * ch_mult[lvl]
        for _ in range(res_blocks):
            res(enc + str(i), cin, cout)
            cin, i = cout, i + 1
            if size == attn_res:
                attn(enc + str(i), cin)
                i += 1
        channels_at[size] = cin
        if lvl != levels - 1:
            n.conv(enc + f"{i}.conv", cin, cin)
            i, size = i + 1, size // 2
    res(enc + str(i), cin, cin)
    attn(enc + str(i + 1), cin)
    res(enc + str(i + 2), cin, cin)
    n.norm(enc + str(i + 3), cin)
    n.conv(enc + str(i + 4), emb_dim, cin)

    gen = "generator.blocks."
    cin = nf * ch_mult[-1]
    n.conv(gen + "0", cin, emb_dim)
    res(gen + "1", cin, cin)
    attn(gen + "2", cin)
    res(gen + "3", cin, cin)
    i, size = 4, attn_res
    for lvl in reversed(range(levels)):
        cout = nf * ch_mult[lvl]
        for _ in range(res_blocks):
            res(gen + str(i), cin, cout)
            cin, i = cout, i + 1
            if size == attn_res:
                attn(gen + str(i), cin)
                i += 1
        if lvl != 0:
            n.conv(gen + f"{i}.conv", cin, cin)
            i, size = i + 1, size * 2
    n.norm(gen + str(i), cin)
    n.conv(gen + str(i + 1), 3, cin)

    n.sd["quantize.embedding.weight"] = n.f.w(codebook, emb_dim, scale=1.0)
    n.table("position_emb", attn_res * attn_res, dim_embd)
    n.linear("feat_emb", dim_embd, emb_dim)
    for layer in range(n_layers):
        b = f"ft_layers.{layer}."
        n.sd[b + "self_attn.in_proj_weight"] = n.w(3 * dim_embd, dim_embd)
        n.sd[b + "self_attn.in_proj_bias"] = n.f.zeros(3 * dim_embd)
        n.linear(b + "self_attn.out_proj", dim_embd, dim_embd)
        n.linear(b + "linear1", 2 * dim_embd, dim_embd)
        n.linear(b + "linear2", dim_embd, 2 * dim_embd)
        n.norm(b + "norm1", dim_embd)
        n.norm(b + "norm2", dim_embd)
    n.norm("idx_pred_layer.0", dim_embd)
    n.linear("idx_pred_layer.1", codebook, dim_embd, bias=False)
    for size in connect:
        c = channels_at[size]
        b = f"fuse_convs_dict.{size}."
        res(b + "encode_enc", 2 * c, c)
        for branch in ("scale", "shift"):
            n.conv(b + branch + ".0", c, c)
            n.conv(b + branch + ".2", c, c)
    return n.sd


def synth_gfpgan_sd(out_size: int = 512, num_style_feat: int = 512, channel_multiplier: int = 2,
                    narrow: float = 1.0, num_mlp: int = 8, fill: FillSpec = "random",
                    seed: int = 25) -> Dict[str, object]:
    """GFPGANv1Clean (gfpganv1_clean_arch.py) with its StyleGAN2 clean decoder
    (stylegan2_clean_arch.py, SFT on half the channels); the defaults are
    GFPGANv1.4's (512², 512 style features, channel multiplier 2): the
    U-Net at half the decoder's width, the W+ code of 16 × 512 from a
    4·4·256 bottleneck, modulated convs [1, O, I, k, k], the stored noises."""
    n = _Net(fill, seed)
    log_size = int(np.log2(out_size))

    def unet_ch(res):
        half = narrow * 0.5
        return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier,
                128: 128 * channel_multiplier, 256: 64 * channel_multiplier,
                512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}[res] * half

    def dec_ch(res):
        return int({4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier,
                    128: 128 * channel_multiplier, 256: 64 * channel_multiplier,
                    512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}[res] * narrow)

    def resblock(key, cin, cout):
        n.conv(key + ".conv1", cin, cin)
        n.conv(key + ".conv2", cout, cin)
        n.conv(key + ".skip", cout, cin, k=1, bias=False)

    cin = int(unet_ch(out_size))
    n.conv("conv_body_first", cin, 3, k=1)
    for k, i in enumerate(range(log_size, 2, -1)):
        cout = int(unet_ch(2 ** (i - 1)))
        resblock(f"conv_body_down.{k}", cin, cout)
        cin = cout
    n.conv("final_conv", int(unet_ch(4)), cin)
    cin = int(unet_ch(4))
    for k, i in enumerate(range(3, log_size + 1)):
        cout = int(unet_ch(2 ** i))
        resblock(f"conv_body_up.{k}", cin, cout)
        cin = cout
        n.conv(f"toRGB.{k}", 3, cout, k=1)
        for which in ("condition_scale", "condition_shift"):
            n.conv(f"{which}.{k}.0", cout, cout)
            n.conv(f"{which}.{k}.2", cout, cout)
    n.linear("final_linear", (2 * log_size - 2) * num_style_feat, int(unet_ch(4)) * 16)

    d = "stylegan_decoder."
    for k in range(num_mlp):
        n.linear(d + f"style_mlp.{2 * k + 1}", num_style_feat, num_style_feat)
    n.sd[d + "constant_input.weight"] = n.f.w(1, dec_ch(4), 4, 4, scale=1.0)

    def modulated(key, cout, cin, k):  # upstream's init: randn/√fan_in, modulation bias 1
        n.sd[key + ".weight"] = n.f.w(1, cout, cin, k, k, scale=1 / float(np.sqrt(cin * k * k)))
        n.linear(key + ".modulation", cin, num_style_feat)
        n.sd[key + ".modulation.bias"] = n.f.ones(cin)

    def style_conv(key, cin, cout):
        modulated(key + ".modulated_conv", cout, cin, 3)
        n.sd[key + ".weight"] = n.f.zeros(1)
        n.sd[key + ".bias"] = n.f.zeros(1, cout, 1, 1)

    def to_rgb(key, cin):
        modulated(key + ".modulated_conv", 3, cin, 1)
        n.sd[key + ".bias"] = n.f.zeros(1, 3, 1, 1)

    cin = dec_ch(4)
    style_conv(d + "style_conv1", cin, cin)
    to_rgb(d + "to_rgb1", cin)
    n.sd[d + "noises.noise0"] = n.f.w(1, 1, 4, 4, scale=1.0)
    for k, i in enumerate(range(3, log_size + 1)):
        cout = dec_ch(2 ** i)
        style_conv(d + f"style_convs.{2 * k}", cin, cout)
        style_conv(d + f"style_convs.{2 * k + 1}", cout, cout)
        to_rgb(d + f"to_rgbs.{k}", cout)
        for j in (2 * k + 1, 2 * k + 2):
            n.sd[d + f"noises.noise{j}"] = n.f.w(1, 1, 2 ** i, 2 ** i, scale=1.0)
        cin = cout
    return n.sd

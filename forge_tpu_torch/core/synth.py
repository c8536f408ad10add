# Copied from forge_tpu/core/synth.py (the SD1.5, SDXL, Flux, MMDiT, T5 and ControlNet state dicts); numpy only, so the port imports no JAX.
# `DeviceFill`, `LazyTensor`, the SD2, SDXL refiner, Playground and SD3 checkpoints and the CLIP-vision, IP-Adapter, ESRGAN and TAESD state dicts are the port's own.
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

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class _Fill:
    def __init__(self, mode: str, seed: int = 0, scale: float = 0.02):
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.scale = scale

    def w(self, *shape):
        if self.mode == "zeros":
            return np.zeros(shape, np.float32)
        return (self.rng.standard_normal(shape) * self.scale).astype(np.float32)

    def ones(self, *shape):
        return np.ones(shape, np.float32)

    def zeros(self, *shape):
        return np.zeros(shape, np.float32)


class LazyTensor:
    """A weight whose shape is known before it exists; `materialize()` makes it."""

    def __init__(self, shape: Tuple[int, ...], make: Callable[[], torch.Tensor]):
        self.shape = tuple(shape)
        self._make = make

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

    def w(self, *shape):
        index, self._count = self._count, self._count + 1
        dev, scale, seed = self.device, self.scale, self.seed * 100_003 + index

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


def synth_sdxl_checkpoint(fill: FillSpec = "zeros", seed: int = 0) -> Dict[str, object]:
    """Full-size SDXL base: 320ch UNet mult(1,2,4) depths(0,2,10), dual TEs."""
    sd: Dict[str, object] = {}
    sd.update(
        synth_unet_sd(
            channel_mult=(1, 2, 4),
            transformer_depth=(0, 2, 10),
            context_dim=2048,
            adm_in_channels=2816,
            middle_depth=10,
            fill=fill,
            seed=seed + 1,
        )
    )
    sd.update(synth_vae_sd(fill=fill, seed=seed + 2))
    sd.update(synth_clip_sd(fill=fill, seed=seed + 3, prefix="conditioner.embedders.0.transformer."))
    sd.update(_open_clip_text_sd(_fill(fill, seed + 4), "conditioner.embedders.1.model."))
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

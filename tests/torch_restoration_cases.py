"""Tiny restoration networks for the port's tests, shared by the test files
of the upscalers, the face restorers, the restore_faces slice and the
extras routes.

Each is a `core/synth.py` state dict at a small width, in its released
files' key space; `write` saves it as a `.safetensors` file both packages
read. forge_tpu's pixel shuffle reads an upsample conv's channels in
another order than torch's (the order upstream trains): `reference_sd`
reorders those convs so that forge_tpu computes on the copy what the port
computes on the original (`reference_shuffle_order`).
forge_tpu's `GFPGAN.load` transposes the 4-d `constant_input` as if it were
a conv kernel: `reference_gfpgan_tree` is what it loads, with that one leaf
left as it is in the file.
"""

import os

import numpy as np

TINY = {
    "swinir": dict(embed=16, depths=(2, 2), heads=2, window=4, num_feat=8, img_size=8),
    "hat": dict(embed=16, depths=(2,), heads=2, window=4, compress_ratio=2, squeeze_factor=4,
                num_feat=8, scale=2),
    "dat": dict(embed=32, depths=(4,), heads=2, num_feat=8, scale=2),
    "scunet": dict(dim=8, config=(1,) * 7, head_dim=2),  # key 0 plain, the up stages' key 1 shifted
}
# codeformer-v0.1.0's layout at face size 512 with 4–8 channels, a 32 × 8 codebook and a
# 2-layer transformer 16 wide (8 heads of 2)
TINY_CODEFORMER = dict(nf=4, ch_mult=(1, 1, 1, 2, 2, 2), emb_dim=8, codebook=32, dim_embd=16,
                       n_layers=2)
TINY_GFPGAN = dict(num_style_feat=16, channel_multiplier=2, narrow=1 / 16, num_mlp=2)


def tiny_sd(arch, seed=0, **over):
    """A tiny state dict of `arch` ("swinir", "hat", "dat", "scunet",
    "codeformer", "gfpgan"), f32 numpy."""
    from forge_tpu_torch.core import synth

    spec = {"codeformer": TINY_CODEFORMER, "gfpgan": TINY_GFPGAN}.get(arch, TINY.get(arch))
    fn = getattr(synth, f"synth_{arch}_sd")
    return fn(**dict(spec, **over), fill="random", seed=seed)


def shuffle_convs(sd):
    """(the `upsample.N` convs each followed by a ×2 shuffle, or DAT's one-step
    conv with its scale) → (keys, r)."""
    keys = sorted({k[:-len(".weight")] for k in sd
                   if k.startswith("upsample.") and k.endswith(".weight")})
    if "conv_before_upsample.0.weight" not in sd and keys:  # pixelshuffledirect
        return keys, int(np.sqrt(sd[keys[0] + ".weight"].shape[0] // 3))
    return keys, 2


def reference_shuffle_order(sd, keys, r):
    """A copy of `sd` with each named conv's output channels (weight and
    bias) reordered from torch's shuffle order (c·r² + s) to forge_tpu's
    (s·C + c), so forge_tpu's shuffle of the copy equals torch's of the
    original."""
    out = dict(sd)
    for key in keys:
        for leaf in ("weight", "bias"):
            v = sd.get(f"{key}.{leaf}")
            if v is not None:
                co = v.shape[0] // (r * r)
                out[f"{key}.{leaf}"] = v[np.arange(v.shape[0]).reshape(co, r * r).T.reshape(-1)]
    return out


def reference_sd(sd):
    keys, r = shuffle_convs(sd)
    return reference_shuffle_order(sd, keys, r)


def write(sd, path):
    from forge_tpu_torch.core.save import save_safetensors

    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_safetensors(sd, path)
    return path


def port_tree(sd, device="cpu"):
    """The port's nested tree of a flat state dict, f32, index buffers kept."""
    import torch

    from forge_tpu_torch.core.convert import nest, tree_to

    return tree_to(nest(dict(sd)), device, torch.float32)


def reference_tree(sd):
    """What forge_tpu's loaders make of the file: conv kernels HWIO, nested."""
    import jax.numpy as jnp

    from forge_tpu.core.state_dict import transform_for_jax
    from forge_tpu.core.tree import nest

    return nest({k: jnp.asarray(v) for k, v in transform_for_jax(dict(sd)).items()})


def reference_gfpgan_tree(sd):
    """forge_tpu's `GFPGAN.load` of the file, its constant input as in the file."""
    import jax.numpy as jnp

    from forge_tpu.core.tree import nest

    return nest({k: jnp.asarray(np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 and not any(
        s in k for s in ("modulated_conv", "noise", "constant_input")) else v)
        for k, v in sd.items()})


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def nchw(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())

"""Tiny networks for the port's tests of OneFormer, DensePose, U²-Net,
Sapiens and the Spaces.

Each is a `core/synth_annotators.py` state dict at a small width, in its
file's key space (`tiny_sd`); forge_tpu reads it as its loaders do
(tests/torch_annotator_cases.py `reference_tree`), the port as its loaders
do. `write` saves one under the directory and file name its loader looks
for.
"""

import os

import numpy as np

from torch_annotator_cases import image, port_tree, reference_tree, rel_err  # noqa: F401

# name: (synth function, small-width arguments, its directory, its file)
TINY = {
    "oneformer_ade20k": ("synth_oneformer_sd", dict(
        embed=16, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=4, conv_dim=32, mask_dim=32,
        enc_layers=2, enc_ffn=64, hidden=32, dec_layers=3, class_dec_layers=1, ffn=64,
        queries=10, classes=150), "oneformer", "250_16_swin_l_oneformer_ade20k_160k.pth"),
    "oneformer_coco": ("synth_oneformer_sd", dict(
        embed=16, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=4, conv_dim=32, mask_dim=32,
        enc_layers=2, enc_ffn=64, hidden=32, dec_layers=3, class_dec_layers=1, ffn=64,
        queries=8, classes=133, seed=55), "oneformer", "150_16_swin_l_oneformer_coco_100ep.pth"),
    "densepose": ("synth_densepose_sd", dict(layers=(1, 1, 1, 1), stem=8, fpn=16, box_fc=32,
                                             head=16, head_convs=2, aspp=16),
                  "densepose", "densepose_r50_fpn_dl.safetensors"),
    "u2net": ("synth_u2net_sd", dict(
        stages=(("stage1", 7, 3, 4, 4), ("stage2", 6, 4, 4, 8), ("stage3", 5, 8, 4, 16),
                ("stage4", 4, 16, 4, 32), ("stage5", 4, 32, 4, 32), ("stage6", 4, 32, 4, 32),
                ("stage5d", 4, 64, 4, 32), ("stage4d", 4, 64, 4, 16), ("stage3d", 5, 32, 4, 8),
                ("stage2d", 6, 16, 4, 4), ("stage1d", 7, 8, 4, 4)),
        sides=(4, 4, 8, 16, 32, 32)), "u2net", "u2net.safetensors"),
    "sapiens": ("synth_sapiens_sd", dict(width=64, depth=2, mlp=128, deconvs=(32, 16), final_k=3),
                "sapiens", "sapiens_1b_normal.safetensors"),
}


def tiny_sd(name, **kw):
    from forge_tpu_torch.core import synth_annotators

    fn, tiny, _, _ = TINY[name]
    return getattr(synth_annotators, fn)(**{**tiny, **kw})


def write(root, name, sd=None):
    """The tiny network `name` under root/<its directory>/<its file> → that directory."""
    import torch

    from forge_tpu_torch.core.save import save_safetensors

    _, _, d, f = TINY[name]
    sd = tiny_sd(name) if sd is None else sd
    os.makedirs(os.path.join(root, d), exist_ok=True)
    path = os.path.join(root, d, f)
    if f.endswith(".pth"):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    else:
        save_safetensors(sd, path)
    return os.path.join(root, d)


def nchw(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)

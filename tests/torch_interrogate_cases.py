"""Tiny networks for the port's tests of interrogation (BLIP, the CLIP
interrogator, DeepDanbooru) and of the depth, segmentation and LaMa
annotators (LeReS, ZoeDepth, Marigold, UniFormer, the anime face, LaMa).

Each is a `core/synth_annotators.py` state dict at a small width, in its
released file's key space (`tiny_sd`); forge_tpu reads it as its loaders
do (tests/torch_annotator_cases.py `reference_tree`), the port as its
loaders do. `write` saves one under the file name its loader looks for.
"""

import os

import numpy as np

from torch_annotator_cases import image, port_tree, reference_tree, rel_err, write_torch  # noqa: F401

# name: (synth function, small-width arguments, its directory, its file)
TINY = {
    "blip": ("synth_blip_sd", dict(width=48, depth=2, layers=2, mlp=96, positions=64),
             "BLIP", "model_base_caption_capfilt_large.safetensors"),
    "clip": ("synth_clip_interrogator_sd", dict(text_width=64, text_layers=2, vision_width=64,
                                                vision_layers=2, projection=32),
             "interrogate", "clip_vit_l_14.safetensors"),
    "deepbooru": ("synth_deepbooru_sd", dict(stages=((8, 2, None), (16, 3, 1), (32, 2, None)),
                                             tags=40),
                  "torch_deepdanbooru", "model-resnet_custom_v3.pt"),
    "leres": ("synth_leres_sd", dict(layers=(1, 2, 1, 1), groups=2, group_width=32,
                                     planes=(8, 16, 32, 64), mids=(16, 16, 16, 32), stem=16),
              "leres", "res101.pth"),
    "zoe": ("synth_zoe_sd", dict(width=64, depth=4, heads=2, grid=4, features=16,
                                 out_channels=(8, 16, 32, 32), n_bins=8, attractors=(4, 2, 2, 1),
                                 embed=8, bin_mlp=16),
            "zoedepth", "ZoeD_M12_N.safetensors"),
    "marigold": ("synth_marigold_sd", dict(text_width=64, text_layers=2, vae_ch=32,
                                           model_channels=64, channel_mult=(1, 2),
                                           num_res_blocks=1, transformer_depth=(1, 1),
                                           middle_depth=1),
                 "marigold", "marigold.safetensors"),
    "uniformer": ("synth_uniformer_sd", dict(dims=(16, 32, 64, 128), layers=(1, 1, 2, 1),
                                             channels=32, classes=150),
                  "uniformer", "upernet_global_small.pth"),
    "anime_face": ("synth_anime_face_sd", {}, "anime_face_segment", "UNet.pth"),
    "lama": ("synth_lama_sd", dict(ngf=8, blocks=2), "lama", "ControlNetLama.pth"),
}


def tiny_sd(name, seed=None, **kw):
    from forge_tpu_torch.core import synth_annotators

    fn, tiny, _, _ = TINY[name]
    kw = {**tiny, **kw}
    if seed is not None:
        kw["seed"] = seed
    return getattr(synth_annotators, fn)(**kw)


def write(root, name, sd=None, **extra):
    """The tiny network `name` under root/<its directory>/<its file> → the path;
    `extra` entries (a tag list) go into a `.pt`/`.pth` beside the tensors."""
    import torch

    from forge_tpu_torch.core.save import save_safetensors

    _, _, d, f = TINY[name]
    sd = tiny_sd(name) if sd is None else sd
    os.makedirs(os.path.join(root, d), exist_ok=True)
    path = os.path.join(root, d, f)
    if f.endswith((".pth", ".pt")):
        torch.save({**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                    **extra}, path)
    else:
        save_safetensors(sd, path)
    return path


def nchw(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)

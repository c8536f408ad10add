"""Weights and runners shared by the image-prompt tests
(tests/test_torch_image_prompts*.py, test_torch_reference_only*.py): tiny
FaceID, FaceID-Plus, InstantID, CLIP-vision and PhotoMaker state dicts made
from a seed (`forge_tpu_torch/core/synth.py`) over the tiny SDXL of
tests/test_torch_sdxl.py (cross-attention widths 64, context 128, y 1600),
each loaded by both packages' own loaders from the same flat numpy dict.
"""

import numpy as np

from test_torch_ipadapter import CV_WIDTH, TINY_ATTN2, tiny_clip_vision_sd
from test_torch_sdxl import CTX, GW

ID_DIM = 32  # the tiny stand-in for insightface's 512-d id embedding
IP_SCALE = 10.0  # to_k_ip, to_v_ip of a scale that moves the tiny image
# weight 1.5 takes the channel gates (1500 − 1280·w, 1500 − 1000·w) below the tiny UNet's
# 32- and 64-channel blocks, so every block records
REF_WEIGHT = 1.5


def _scaled(sd, prefix="ip_adapter."):
    return {k: v * IP_SCALE if k.startswith(prefix) else v for k, v in sd.items()}


def tiny_faceid_sd(plus=False, seed=41):
    from forge_tpu_torch.core.synth import synth_faceid_sd

    return _scaled(synth_faceid_sd(id_dim=ID_DIM, context_dim=CTX, widths=TINY_ATTN2, plus=plus,
                                   clip_dim=CV_WIDTH, depth=2, fill="random", seed=seed))


def tiny_instantid_sd(seed=42):
    from forge_tpu_torch.core.synth import synth_instantid_sd

    return _scaled(synth_instantid_sd(id_dim=ID_DIM, dim=64, depth=2, queries=4,
                                      context_dim=CTX, widths=TINY_ATTN2, fill="random",
                                      seed=seed))


def tiny_revision_sd(seed=43):
    """A tiny CLIP vision tower whose projection is the tiny CLIP-G's width,
    the slot of `y` Revision writes."""
    return tiny_clip_vision_sd(projection=GW, seed=seed)


def tiny_photomaker_sd(qformer=True, seed=44):
    from forge_tpu_torch.core.synth import synth_photomaker_sd

    sd = synth_photomaker_sd(width=CV_WIDTH, layers=2, mlp=256, patch=32, context_dim=CTX,
                             qformer_dim=64 if qformer else 0, id_dim=ID_DIM, fill="random",
                             seed=seed)
    sd["id_encoder.vision_model.embeddings.class_embedding"] *= 25.0  # a class token of unit scale
    for key in [k for k in sd if k.startswith("id_encoder.fuse_module.mlp")]:
        sd[key] = sd[key] * 10.0  # a fuse that moves the tiny image
    return sd


def face_embed(seed=45, n=1):
    return np.random.default_rng(seed).standard_normal((n, ID_DIM)).astype(np.float32)


def photo(h=64, w=64, seed=46):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def jax_tree(sd):
    """forge_tpu's tree of a flat dict, as its loaders make it."""
    import jax.numpy as jnp

    from forge_tpu.core.state_dict import transform_for_jax
    from forge_tpu.core.tree import nest

    return nest({k: jnp.asarray(v) for k, v in transform_for_jax(dict(sd)).items()})


def port_tree(sd):
    import torch

    from forge_tpu_torch.core.loader import to_device_tree

    return to_device_tree(sd, torch.float32, "cpu")

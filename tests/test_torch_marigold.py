"""The port's Marigold (forge_tpu_torch/preprocessors/marigold.py) against
forge_tpu's on the CPU, f32, on a tiny checkpoint (tests/
torch_interrogate_cases.py: an 8-channel UNet of 64 channels over two
levels, a 32-channel VAE, a 2-layer 64-wide text tower), one file with the
`unet.`, `vae.` and `text_encoder.` prefixes.

The port runs the UNet at SD2's geometry (heads of 64 channels), as
Marigold's SD2 UNet is built; forge_tpu calls its UNet with the default
config, 8 heads of any width. Shown from both sides: forge_tpu as it is
equals the port with its UNet held to 8 heads, and differs from the port;
the other tests give forge_tpu's UNet SD2's geometry
(`_sd2_heads_in_reference`). Then the DDIM loop's depth in [-1, 1] agrees
within 1e-4 (eps and v prediction, 2 and 3 steps, the start noise drawn
by `np.random.default_rng(seed)` in forge_tpu's NHWC order on both sides),
and the uint8 maps within one level on at most 0.5 % of the pixels, the
detector's multiple-of-64 resizes included. `prediction_type` comes from the
file's safetensors metadata in the port; forge_tpu's reader drops the
metadata and takes epsilon (both sides). `diffusers_unet_to_ldm` maps
diffusers' keys as forge_tpu's does.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from torch_interrogate_cases import image, reference_tree, rel_err, tiny_sd  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny checkpoint twice: with no metadata (epsilon) and marked v_prediction."""
    from forge_tpu_torch.core.save import save_safetensors

    sd = tiny_sd("marigold")
    d = tmp_path_factory.mktemp("models")
    paths = {}
    for kind, meta in (("epsilon", None), ("v_prediction", {"prediction_type": "v_prediction"})):
        os.makedirs(d / kind)
        paths[kind] = str(d / kind / "marigold.safetensors")
        save_safetensors(sd, paths[kind], metadata=meta)
    return sd, paths


def _sd2_heads_in_reference(monkeypatch):
    from forge_tpu.models import unet as junet

    monkeypatch.setattr(junet, "unet_apply", functools.partial(
        junet.unet_apply, cfg=junet.UNetConfig(context_dim=64, head_dim=64)))


def _reference(sd, kind):
    from forge_tpu.preprocessors.marigold import MarigoldPipeline

    def part(prefix):
        return reference_tree({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})

    return MarigoldPipeline(part("unet."), part("vae."), part("text_encoder."),
                            prediction_type=kind)


def _inputs(seed, h=64, w=64):
    img = image(seed, h, w)
    rgb = img.astype(np.float32)[None] / 127.5 - 1.0
    noise = np.random.default_rng(seed).standard_normal((1, h // 8, w // 8, 4)).astype(np.float32)
    return img, rgb, noise


def _port_infer(pipe, rgb, noise, steps):
    return pipe.infer(torch.from_numpy(np.ascontiguousarray(rgb.transpose(0, 3, 1, 2))),
                      torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))),
                      steps).numpy()


@pytest.mark.parametrize("kind", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("steps,seed", [(2, 0), (3, 1)])
def test_pipeline_matches_reference(files, monkeypatch, kind, steps, seed):
    from forge_tpu_torch.preprocessors.marigold import MarigoldPipeline

    _sd2_heads_in_reference(monkeypatch)
    sd, paths = files
    port = MarigoldPipeline.from_file(paths[kind], "cpu", torch.float32)
    assert port.prediction_type == kind and tuple(port.empty_embed.shape) == (1, 2, 64)
    ref = _reference(sd, kind)
    img, rgb, noise = _inputs(seed)
    want = np.asarray(ref._infer(ref.unet, ref.vae, jnp.asarray(rgb), jnp.asarray(noise),
                                 ref.empty_embed, steps=steps))
    got = _port_infer(port, rgb, noise, steps)
    assert got.shape == want.shape == (64, 64)
    assert rel_err(got, want) < TOL
    a, b = port.run(img, steps=steps, seed=seed), ref.run(img, steps=steps, seed=seed)
    diff = np.abs(a.astype(np.int16) - b)
    assert a.dtype == np.uint8 and diff.max() <= 1 and (diff > 0).mean() <= 0.005


def test_unet_heads_from_both_sides(files):
    """forge_tpu's Marigold runs its UNet at 8 heads; the port at heads of 64."""
    from forge_tpu_torch.models import unet as tunet
    from forge_tpu_torch.preprocessors.marigold import MarigoldPipeline

    sd, paths = files
    port = MarigoldPipeline.from_file(paths["epsilon"], "cpu", torch.float32)
    ref = _reference(sd, "epsilon")
    _, rgb, noise = _inputs(2)
    want = np.asarray(ref._infer(ref.unet, ref.vae, jnp.asarray(rgb), jnp.asarray(noise),
                                 ref.empty_embed, steps=2))
    ours = _port_infer(port, rgb, noise, 2)
    with pytest.MonkeyPatch.context() as mp:
        original = tunet.unet_apply
        mp.setattr(tunet, "unet_apply", lambda *a, cfg, **kw: original(
            *a, cfg=tunet.UNetConfig(context_dim=cfg.context_dim, num_heads=8), **kw))
        eight = _port_infer(port, rgb, noise, 2)
    assert rel_err(eight, want) < TOL and rel_err(ours, want) > 1e-5
    # one UNet forward with sharp attention (q and k ×30): the geometries part clearly
    from forge_tpu.models.unet import unet_apply as ref_unet
    from forge_tpu_torch.core.convert import nest, tree_to

    unet = {k[len("unet."):]: v * (30.0 if k.endswith(("to_q.weight", "to_k.weight")) else 1.0)
            for k, v in sd.items() if k.startswith("unet.")}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 2, 64)).astype(np.float32)
    want = np.asarray(ref_unet(reference_tree(unet), jnp.asarray(x), jnp.asarray([500.0]),
                               jnp.asarray(ctx)))
    tree = tree_to(nest(unet), "cpu", torch.float32)
    args = (tree, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.tensor([500.0]),
            torch.from_numpy(ctx))
    eight = tunet.unet_apply(*args, cfg=tunet.UNetConfig(context_dim=64, num_heads=8))
    sd2 = tunet.unet_apply(*args, cfg=tunet.UNetConfig(context_dim=64, head_dim=64))
    assert rel_err(eight.numpy().transpose(0, 2, 3, 1), want) < TOL
    assert rel_err(sd2.numpy().transpose(0, 2, 3, 1), want) > 1e-2


def test_prediction_type_from_both_sides(files):
    from forge_tpu.preprocessors.marigold import MarigoldPipeline as Ref
    from forge_tpu_torch.preprocessors.marigold import MarigoldPipeline, safetensors_metadata

    _, paths = files
    assert safetensors_metadata(paths["v_prediction"]) == {"prediction_type": "v_prediction"}
    assert MarigoldPipeline.from_file(paths["v_prediction"], "cpu",
                                      torch.float32).prediction_type == "v_prediction"
    assert Ref.from_file(paths["v_prediction"]).prediction_type == "epsilon"


def test_detector_resizes_match_reference(files, monkeypatch):
    from forge_tpu.preprocessors import marigold as jmarigold
    from forge_tpu_torch.preprocessors import PREPROCESSORS
    from forge_tpu_torch.preprocessors import marigold

    _sd2_heads_in_reference(monkeypatch)
    _, paths = files
    d = os.path.dirname(paths["epsilon"])
    port = marigold.MarigoldDetector(model_dir=d, device="cpu")
    ref = jmarigold.MarigoldDetector(model_dir=d)
    img = image(3, 70, 90)
    got, want = port.detect(img, steps=2, seed=4), ref.detect(img, steps=2, seed=4)
    diff = np.abs(got.astype(np.int16) - want)
    assert got.shape == (70, 90, 3) and diff.max() <= 1 and (diff > 0).mean() <= 0.005
    monkeypatch.setattr(marigold, "_DETECTOR", port)
    monkeypatch.setattr(jmarigold, "_DETECTOR", ref)
    entry = PREPROCESSORS["depth_marigold"]
    got = entry(img, 64, 0, 0)  # the entry's 20 steps, seed 0
    want = jmarigold._depth_marigold(img, 64, 0, 0)
    diff = np.abs(np.rint(got * 255) - np.rint(want * 255))
    assert got.shape == (64, 80, 3) and diff.max() <= 1 and (diff > 0).mean() <= 0.005


def test_diffusers_keys_map_as_the_reference():
    from forge_tpu.core.state_dict import diffusers_unet_to_ldm as ref
    from forge_tpu_torch.core.state_dict import diffusers_unet_to_ldm

    keys = ["conv_in.weight", "conv_in.bias", "time_embedding.linear_1.weight",
            "time_embedding.linear_2.bias", "conv_norm_out.weight", "conv_out.bias",
            "mid_block.resnets.0.norm1.weight", "mid_block.attentions.0.proj_in.weight",
            "mid_block.resnets.1.conv_shortcut.weight"]
    for i in range(3):
        for j in range(2):
            keys += [f"down_blocks.{i}.resnets.{j}.{n}.weight"
                     for n in ("norm1", "conv1", "time_emb_proj", "norm2", "conv2")]
            if i < 2:
                keys.append(f"down_blocks.{i}.attentions.{j}.transformer_blocks.0.attn1.to_q.weight")
        if i < 2:
            keys.append(f"down_blocks.{i}.downsamplers.0.conv.weight")
        for j in range(3):
            keys += [f"up_blocks.{i}.resnets.{j}.conv1.weight",
                     f"up_blocks.{i}.resnets.{j}.conv_shortcut.bias"]
            if i > 0:
                keys.append(f"up_blocks.{i}.attentions.{j}.proj_out.weight")
        if i < 2:
            keys.append(f"up_blocks.{i}.upsamplers.0.conv.weight")
    sd = {k: np.full((1,), n, np.float32) for n, k in enumerate(keys)}
    got, want = diffusers_unet_to_ldm(sd), ref(sd)
    assert got.keys() == want.keys() and len(got) == len(keys)
    assert all(got[k] is want[k] for k in got)

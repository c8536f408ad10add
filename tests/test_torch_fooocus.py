"""Fooocus inpaint (extensions/fooocus_inpaint.py) against forge_tpu (CPU,
f32): the uint8 diffs' dequant, the inpaint head's feature, a `.patch` file
written by `torch.save` (3-element groups; the port reads it through
`load_torch_object`, the reference's `load_state_dict` drops the groups:
both sides shown), the patched img2img inpaint request through both
`process_images` on the tiny SDXL and SD1.5 (PSNR ≥ 80 dB), the engine's weights left
as they were, and a window short of 0–1 from both sides (the reference's
img2img drops the head; the port refuses)."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_sdxl import _assert_close  # noqa: E402
from torch_controls_cases import (SD15_REQUEST, SDXL_REQUEST, assert_slice,  # noqa: E402
                                  init_and_mask, processing, run_both, sd15_engines,
                                  sdxl_engines)


@pytest.fixture(scope="module")
def all_engines():
    return {"sdxl": sdxl_engines(), "sd15": sd15_engines()}


@pytest.fixture(scope="module")
def engines(all_engines):
    return all_engines["sdxl"]


def _group(rng, shape, per_channel=False):
    diff = rng.integers(0, 256, size=shape, dtype=np.uint8)
    lo = -0.02 - 0.01 * np.asarray(
        rng.random(shape[:1] + (1,) * (len(shape) - 1) if per_channel else ()))
    return [diff, lo.astype(np.float32), (lo + 0.04).astype(np.float32)]


def patch_groups(unet_tree, seed=7, skip_every=5):
    """{`diffusion_model.<key>`: [uint8 diff, min, max]} for the UNet's
    weights of two or more dimensions (every `skip_every`-th left out), and
    one plain tensor the patch format skips."""
    from forge_tpu_torch.core.convert import flatten

    rng = np.random.default_rng(seed)
    keys = [k for k, v in flatten(unet_tree).items() if v.dim() >= 2]
    sd = {f"diffusion_model.{k}": _group(rng, tuple(flatten(unet_tree)[k].shape), i % 3 == 0)
          for i, k in enumerate(keys) if i % skip_every}
    sd["diffusion_model.time_embed.0.weight"] = _group(
        rng, tuple(flatten(unet_tree)["time_embed.0.weight"].shape))
    sd["a plain tensor"] = rng.standard_normal(3).astype(np.float32)
    return sd


def _save_patch(path, sd):
    torch.save({k: [torch.from_numpy(np.asarray(a)) for a in v] if isinstance(v, list)
                else torch.from_numpy(v) for k, v in sd.items()}, str(path))


def _files(engine, d, seed):
    sd = patch_groups(engine.loaded.unet, seed=seed)
    _save_patch(d / "inpaint_tiny.patch", sd)
    head = np.random.default_rng(seed).standard_normal((32, 5, 3, 3)).astype(np.float32) * 0.3
    torch.save({"head.weight": torch.from_numpy(head)}, str(d / "inpaint_head_tiny.pth"))
    return str(d / "inpaint_tiny.patch"), str(d / "inpaint_head_tiny.pth"), sd, head


@pytest.fixture(scope="module")
def all_files(all_engines, tmp_path_factory):
    return {model: _files(all_engines[model][1], tmp_path_factory.mktemp(f"fooocus_{model}"),
                          seed)
            for model, seed in (("sdxl", 7), ("sd15", 8))}


@pytest.fixture(scope="module")
def files(all_files):
    return all_files["sdxl"]


def test_dequantize_matches():
    from forge_tpu.extensions.fooocus_inpaint import dequantize_fooocus as jdequant
    from forge_tpu_torch.extensions.fooocus_inpaint import dequantize_fooocus

    rng = np.random.default_rng(1)
    for shape, per_channel in (((5, 7), False), ((4, 3, 3, 3), True), ((9,), False)):
        group = _group(rng, shape, per_channel)
        got = dequantize_fooocus(group).numpy()
        want = jdequant(group)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
        as_torch = [torch.from_numpy(np.asarray(a)) for a in group]
        assert np.array_equal(dequantize_fooocus(as_torch).numpy(), got)


def test_patch_file_from_both_sides(files):
    """The port reads the groups back from the pickle; the reference's
    `load_state_dict` keeps only top-level tensors, so its `attach` given
    the path would patch nothing (its own `load_torch_object` reads them)."""
    from forge_tpu.core.state_dict import load_state_dict as jload_state_dict
    from forge_tpu.core.state_dict import load_torch_object as jload_object
    from forge_tpu.extensions.fooocus_inpaint import load_fooocus_patches as jpatches
    from forge_tpu_torch.core.state_dict import load_torch_object
    from forge_tpu_torch.extensions.fooocus_inpaint import (is_fooocus_patch,
                                                            load_fooocus_patches)

    path, _, sd, _ = files
    read = load_torch_object(path)
    assert is_fooocus_patch(read) and not is_fooocus_patch({"x": read["a plain tensor"]})
    groups = {k for k, v in sd.items() if isinstance(v, list)}
    assert {k for k, v in read.items() if isinstance(v, list)} == groups
    for k in groups:
        assert all(np.array_equal(a, b) for a, b in zip(read[k], sd[k]))
    patches, s = load_fooocus_patches(read, 0.7)
    assert s == 0.7 and set(patches) == {k[len("diffusion_model."):] for k in groups}
    key = "time_embed.0.weight"
    want = jpatches(jload_object(path), 0.7)[0][key].tensors["diff"]
    np.testing.assert_allclose(patches[key].tensors["diff"].materialize().numpy(), want,
                               rtol=0, atol=1e-8)
    jsd = jload_state_dict(path)
    assert not any(k in jsd for k in groups) and not jpatches(jsd)[0]


def test_inpaint_head_feature_and_hooks_match(files):
    from forge_tpu.extensions.fooocus_inpaint import build_inpaint_head_hooks as jhooks
    from forge_tpu.extensions.fooocus_inpaint import inpaint_head_feature as jfeature
    from forge_tpu_torch.extensions.fooocus_inpaint import (build_inpaint_head_hooks,
                                                            inpaint_head_feature)

    head = files[3]
    rng = np.random.default_rng(2)
    mask = (rng.random((1, 1, 8, 12)) > 0.5).astype(np.float32)
    latent = rng.standard_normal((1, 4, 8, 12)).astype(np.float32)
    got = inpaint_head_feature(torch.from_numpy(head), torch.from_numpy(mask),
                               torch.from_numpy(latent))
    want = jfeature(jnp.asarray(head.transpose(2, 3, 1, 0)),
                    jnp.asarray(mask.transpose(0, 2, 3, 1)),
                    jnp.asarray(latent.transpose(0, 2, 3, 1)))
    _assert_close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), rel=1e-5)
    h = rng.standard_normal((2, 32, 8, 12)).astype(np.float32)
    (patch,) = build_inpaint_head_hooks(got)["input_block_patch"]
    (jpatch,) = jhooks(want)["input_block_patch"]
    for bid in (("input", 0), ("input", 1)):
        out = patch(torch.from_numpy(h), bid).numpy()
        jout = np.asarray(jpatch(jnp.asarray(h.transpose(0, 2, 3, 1)), bid)).transpose(0, 3, 1, 2)
        _assert_close(out, jout, rel=1e-5)


def _request(model="sdxl", **fields):
    init, mask = init_and_mask()
    return dict(SDXL_REQUEST if model == "sdxl" else SD15_REQUEST, init_images=[init],
                inpaint_mask=mask, denoising_strength=1.0, **fields)


def _attach(files, **args):
    path, head_path, _, _ = files

    def attach(package, p):
        if package == "forge_tpu":
            from forge_tpu.core.state_dict import load_torch_object as jload_object
            from forge_tpu.extensions.fooocus_inpaint import attach as jattach

            jattach(p, dict(args, head=head_path), patch_sd=jload_object(path))
        else:
            from forge_tpu_torch.extensions.fooocus_inpaint import attach as tattach

            tattach(p, dict(args, patch=path, head=head_path))

    return attach


@pytest.mark.parametrize("model, args", [("sdxl", {}), ("sdxl", {"weight": 0.6}), ("sd15", {})],
                         ids=["sdxl, weight 1", "sdxl, weight 0.6", "sd15, weight 1"])
def test_fooocus_request_matches_forge_tpu(all_engines, all_files, model, args):
    engines, files = all_engines[model], all_files[model]
    teng = engines[1]
    before = {k: v.clone() for k, v in teng.loaded.unet["input_blocks"]["1"]["0"]["in_layers"]
              ["2"].items()}
    got, want, tp = run_both(engines, _request(model), _attach(files, **args))
    print(args, assert_slice(got, want))
    assert tp.extra_generation_params["Fooocus inpaint"] == "True"
    for k, v in teng.loaded.unet["input_blocks"]["1"]["0"]["in_layers"]["2"].items():
        assert torch.equal(v, before[k])  # the patch went onto a per-request copy
    tproc = processing("forge_tpu_torch")
    plain = tproc.process_images(teng, tproc.Processing(**_request(model)))
    assert not np.array_equal(got.images[0], plain.images[0])


def test_partial_window_from_both_sides(engines, files):
    """A window short of 0–1 sets hook phases: the reference's img2img drops
    them and with them the head (its image is the one a zero head gives);
    the port refuses."""
    jeng, teng = engines
    path, head_path, _, head = files
    from forge_tpu.core.state_dict import load_torch_object as jload_object
    from forge_tpu.extensions.fooocus_inpaint import attach as jattach

    jproc = processing("forge_tpu")
    p = jproc.Processing(**_request())
    jattach(p, {"end_percent": 0.5}, patch_sd=jload_object(path),
            head_weight=jnp.asarray(head.transpose(2, 3, 1, 0)))
    partial = jproc.process_images(jeng, p).images[0]
    p = jproc.Processing(**_request())
    jattach(p, {}, patch_sd=jload_object(path), head_weight=jnp.zeros((3, 3, 5, 32)))
    assert np.array_equal(partial, jproc.process_images(jeng, p).images[0])
    tproc = processing("forge_tpu_torch")
    p = tproc.Processing(**_request())
    _attach(files, end_percent=0.5)("forge_tpu_torch", p)
    with pytest.raises(NotImplementedError, match="hook_phases on img2img"):
        tproc.process_images(teng, p)

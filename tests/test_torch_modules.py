"""Separate VAE and text-encoder files (`additional_modules`) in the port against forge_tpu (CPU).

- a tiny Flux split as users download it (a bare transformer file, a VAE
  file, a text-encoder file in the merged `text_encoders.*` layout) loads
  into the same components as the merged checkpoint, in both packages;
- "vae" replaces a checkpoint's VAE, from a file with or without the
  `first_stage_model.` prefix;
- `ModelManager.load(vae=…)` loads again on a new VAE and keeps the engine
  while the key stays; a manager puts back the resolver it replaced;
- the bare file's UNet tree holds the transformer alone; forge_tpu's holds
  the merged VAE and text encoders too (a reference-side fault);
- a text-encoder file in its upstream key space (`encoder.block.*`) raises
  ValueError naming it; forge_tpu merges it and collects nothing from it.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import make_sd15_checkpoint, make_vae_sd  # noqa: E402
from test_torch_flux import _tiny_flux_checkpoint  # noqa: E402

UNET = "model.diffusion_model."


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _save(tmp_path, sd, name):
    from forge_tpu_torch.core.save import save_safetensors

    path = str(tmp_path / name)
    save_safetensors(sd, path)
    return path


@pytest.fixture(scope="module")
def flux_files(tmp_path_factory):
    """The tiny Flux merged, and split into a bare transformer, a VAE and a text-encoder file."""
    tmp = tmp_path_factory.mktemp("flux_files")
    sd = _tiny_flux_checkpoint()
    bare = {k[len(UNET):]: v for k, v in sd.items() if k.startswith(UNET)}
    vae = {k: v for k, v in sd.items() if k.startswith("first_stage_model.")}
    tes = {k: v for k, v in sd.items() if k.startswith("text_encoders.")}
    return (sd, _save(tmp, bare, "flux1-dev.safetensors"), _save(tmp, vae, "ae.safetensors"),
            _save(tmp, tes, "text_encoders.safetensors"))


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_split_files_load_as_the_merged_checkpoint(flux_files):
    from forge_tpu.core.loader import load_checkpoint_parts as jparts
    from forge_tpu_torch.core.loader import load_checkpoint_parts

    sd, bare, vae, tes = flux_files
    modules = {"vae": vae, "text_encoders": tes}
    merged = load_checkpoint_parts(dict(sd), device="cpu")
    split = load_checkpoint_parts(bare, device="cpu", additional_modules=modules)
    assert split.family == merged.family == "flux"
    _same_tree(split.unet, merged.unet)
    _same_tree(split.vae, merged.vae)
    assert set(split.text_encoders) == {"clip_l", "t5xxl"}
    for name in split.text_encoders:
        _same_tree(split.text_encoders[name], merged.text_encoders[name])
    want = jparts(bare, dtype=jnp.float32, additional_modules=modules)
    assert set(want.text_encoders) == set(split.text_encoders)
    jt5 = _flat(want.text_encoders["t5xxl"])
    for k, v in _flat(split.text_encoders["t5xxl"]).items():
        assert np.array_equal(v.numpy(), np.asarray(jt5[k])), k


def test_bare_file_unet_holds_the_transformer_alone(flux_files):
    """forge_tpu's guess takes the whole merged dict as a bare file's UNet:
    the VAE and both text encoders load a second time inside it."""
    from forge_tpu.core.loader import load_checkpoint_parts as jparts
    from forge_tpu_torch.core.guess import guess
    from forge_tpu_torch.core.loader import load_checkpoint_parts

    sd, bare, vae, tes = flux_files
    modules = {"vae": vae, "text_encoders": tes}
    want = jparts(bare, dtype=jnp.float32, additional_modules=modules)
    assert {"first_stage_model", "text_encoders"} <= set(want.unet)
    got = load_checkpoint_parts(bare, device="cpu", additional_modules=modules)
    assert not {"first_stage_model", "text_encoders"} & set(got.unet)
    assert set(got.unet) == {k[len(UNET):].split(".")[0] for k in sd if k.startswith(UNET)}
    merged_bare = {k[len(UNET):] if k.startswith(UNET) else k: v for k, v in sd.items()}
    g = guess(merged_bare)  # a bare dict with the other components merged in
    assert g.family == "flux" and not any(k.startswith(("first_stage_model.", "text_encoders."))
                                          for k in g.unet)
    assert set(g.text_encoders) == {"clip_l", "t5xxl"} and g.vae


@pytest.mark.parametrize("prefixed", [True, False])
def test_vae_file_replaces_the_checkpoint_vae(tmp_path, prefixed):
    from forge_tpu.core.loader import load_checkpoint_parts as jparts
    from forge_tpu_torch.core.loader import load_checkpoint_parts

    new_vae = make_vae_sd(prefix="first_stage_model." if prefixed else "", seed=9)
    path = _save(tmp_path, new_vae, "vae.safetensors")
    got = load_checkpoint_parts(make_sd15_checkpoint(0), device="cpu",
                                additional_modules={"vae": path})
    want = jparts(make_sd15_checkpoint(0), dtype=jnp.float32, additional_modules={"vae": path})
    flat, jflat = _flat(got.vae), _flat(want.vae)
    assert set(flat) == set(jflat) == {k.removeprefix("first_stage_model.") for k in new_vae}
    for k, v in flat.items():
        expect = new_vae[("first_stage_model." if prefixed else "") + k]
        assert np.array_equal(v.numpy(), expect), k
        j = np.asarray(jflat[k])
        assert np.array_equal(v.numpy(), j.transpose(3, 2, 0, 1) if j.ndim == 4 else j), k


def test_upstream_text_encoder_file_raises_where_forge_tpu_collects_nothing(flux_files, tmp_path):
    from forge_tpu.core.loader import load_checkpoint_parts as jparts
    from forge_tpu_torch.core.loader import load_checkpoint_parts

    sd, bare, vae, _ = flux_files
    prefix = "text_encoders.t5xxl.transformer."
    upstream = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    assert any(k.startswith("encoder.block.") for k in upstream)
    path = _save(tmp_path, upstream, "t5xxl_fp16.safetensors")
    want = jparts(bare, dtype=jnp.float32, additional_modules={"vae": vae, "t5xxl": path})
    assert "t5xxl" not in want.text_encoders  # its engine then fails on the missing T5
    with pytest.raises(ValueError, match="t5xxl_fp16.safetensors"):
        load_checkpoint_parts(bare, device="cpu", additional_modules={"vae": vae, "t5xxl": path})


def test_model_manager_loads_again_on_a_new_vae(tmp_path):
    from forge_tpu_torch.pipeline import processing
    from forge_tpu_torch.runtime.models import ModelManager

    ckpts = tmp_path / "Stable-diffusion"
    ckpts.mkdir()
    _save(ckpts, make_sd15_checkpoint(0), "tiny.safetensors")
    vae_a = _save(tmp_path, make_vae_sd(seed=9), "a.safetensors")
    vae_b = _save(tmp_path, make_vae_sd(prefix="", seed=10), "b.safetensors")
    before = processing.ENGINE_RESOLVER
    with ModelManager(checkpoint_dirs=[str(ckpts)], device="cpu") as mm:
        assert processing.ENGINE_RESOLVER == mm.resolve_aux
        plain = mm.load("tiny")
        assert mm.load("tiny") is plain
        with_a = mm.load("tiny", vae=vae_a)
        assert with_a is not plain and mm.load("tiny", vae=vae_a) is with_a
        key = "decoder.conv_in.weight"
        assert np.array_equal(_flat(with_a.loaded.vae)[key].numpy(),
                              make_vae_sd(seed=9)["first_stage_model." + key])
        with_b = mm.load("tiny", vae=vae_b)
        assert with_b is not with_a
        assert np.array_equal(_flat(with_b.loaded.vae)[key].numpy(), make_vae_sd(seed=10)[
            "first_stage_model." + key])
        assert torch.equal(_flat(with_b.loaded.unet)["out.2.weight"],
                           _flat(plain.loaded.unet)["out.2.weight"])
    assert processing.ENGINE_RESOLVER is before and mm.engine is None


def test_model_manager_restores_the_resolver():
    """Making and closing a manager leaves `processing.ENGINE_RESOLVER` as it
    was, with another resolver in place or none."""
    from forge_tpu_torch.pipeline import processing
    from forge_tpu_torch.runtime.models import ModelManager

    before = processing.ENGINE_RESOLVER
    mm = ModelManager(checkpoint_dirs=[], device="cpu")
    assert processing.ENGINE_RESOLVER == mm.resolve_aux
    mm.close()
    assert processing.ENGINE_RESOLVER is before

    def other(name):
        raise LookupError(name)

    processing.ENGINE_RESOLVER = other
    try:
        outer = ModelManager(checkpoint_dirs=[], device="cpu")
        inner = ModelManager(checkpoint_dirs=[], device="cpu")
        inner.close()
        assert processing.ENGINE_RESOLVER == outer.resolve_aux
        outer.close()
        assert processing.ENGINE_RESOLVER is other
    finally:
        processing.ENGINE_RESOLVER = before

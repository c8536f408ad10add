"""bitsandbytes-prequantized files (Forge's `flux1-dev-bnb-nf4`) in the port against forge_tpu (CPU).

Files are written in the bitsandbytes serialized layout by the port's
`core/synth.py` `bnb_serialize` and `core/save.py` `save_safetensors`, then
read by both packages' `load_state_dict`:
- NF4 (block 64), NF4 with double-quantized absmax, and FP4: the leaves are
  equal (codes exact, scales within 1e-6; FP4 dequantized at load, values
  within 1e-6), and `nn.linear` on the port's leaf agrees with x·Wᵀ on
  forge_tpu's dequantized weight at f32 (1e-5 of the output scale);
- a tiny Flux whose transformer is written as an NF4 file beside its VAE
  and text encoders: txt2img through both packages (PSNR ≥ 40 dB, the Flux
  slice's bar);
- an NF4 weight the kernel cannot take (in not a multiple of 64) raises at
  load rather than being dequantized.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.ops import quant as jquant  # noqa: E402

ATOL_REL = 1e-5


def _weight(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)


def _write(tmp_path, tensors, name="bnb.safetensors"):
    from forge_tpu_torch.core.save import save_safetensors

    path = str(tmp_path / name)
    save_safetensors(tensors, path)
    return path


@pytest.fixture(scope="module")
def bnb_file(tmp_path_factory):
    """One file, three layers: NF4, NF4 double-quantized, FP4 (and a bias)."""
    from forge_tpu_torch.core.synth import bnb_serialize

    weights = {"nf4.weight": _weight((96, 256), 1), "dq.weight": _weight((128, 512), 2),
               "fp4.weight": _weight((32, 192), 3)}
    tensors = {"nf4.bias": np.linspace(-1, 1, 96, dtype=np.float32)}
    tensors.update(bnb_serialize("nf4.weight", torch.from_numpy(weights["nf4.weight"])))
    tensors.update(bnb_serialize("dq.weight", torch.from_numpy(weights["dq.weight"]),
                                 double_quant=True))
    tensors.update(bnb_serialize("fp4.weight", torch.from_numpy(weights["fp4.weight"]),
                                 qtype="fp4"))
    return _write(tmp_path_factory.mktemp("bnb"), tensors), weights


def test_serialized_layout(bnb_file):
    from forge_tpu_torch.core.state_dict import load_safetensors

    raw = load_safetensors(bnb_file[0])
    assert raw["nf4.weight"].shape == (96 * 256 // 2, 1) and raw["nf4.weight"].dtype == np.uint8
    assert raw["nf4.weight.absmax"].dtype == np.float32
    assert raw["dq.weight.absmax"].dtype == np.uint8
    assert raw["dq.weight.nested_quant_map"].shape == (256,)
    assert raw["dq.weight.nested_absmax"].shape == (128 * 512 // 64 // 256,)
    assert "fp4.weight.quant_state.bitsandbytes__fp4" in raw


@pytest.mark.parametrize("key", ["nf4.weight", "dq.weight"])
def test_nf4_leaves_match_forge_tpu(bnb_file, key):
    from forge_tpu.core.state_dict import load_state_dict as jload
    from forge_tpu_torch.core.state_dict import load_state_dict
    from forge_tpu_torch.ops import nn
    from forge_tpu_torch.ops.quant import QuantLeaf, quantize_nf4

    path, weights = bnb_file
    want, got = jload(path)[key], load_state_dict(path)[key]
    assert isinstance(got, QuantLeaf) and got.kind == want["kind"] == "nf4" and got.block == 64
    assert got.shape == tuple(want["shape"]) == weights[key].shape
    assert np.array_equal(got.codes.numpy(), np.asarray(want["codes"]).reshape(-1))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want["scales"]), rtol=0, atol=1e-6)
    ref = quantize_nf4(torch.from_numpy(weights[key]))
    assert torch.equal(got.codes, ref.codes)  # the writer's codes are the port's quantizer's
    if key == "nf4.weight":
        assert torch.equal(got.scales, ref.scales)
    x = np.random.default_rng(4).standard_normal((3, weights[key].shape[1])).astype(np.float32)
    y = nn.linear(torch.from_numpy(x), {"weight": got}).numpy()
    w = np.asarray(jquant.dequantize(want, jnp.float32))
    expect = x @ w.T
    assert np.abs(y - expect).max() <= ATOL_REL * max(np.abs(expect).max(), 1.0)


def test_fp4_dequantizes_at_load_in_both(bnb_file):
    from forge_tpu.core.state_dict import load_state_dict as jload
    from forge_tpu_torch.core.state_dict import load_state_dict

    path, weights = bnb_file
    want, got = jload(path), load_state_dict(path)
    assert isinstance(got["fp4.weight"], np.ndarray) and got["fp4.weight"].dtype == np.float32
    np.testing.assert_allclose(got["fp4.weight"], want["fp4.weight"], rtol=0, atol=1e-6)
    assert np.abs(got["fp4.weight"] - weights["fp4.weight"]).max() < 0.05
    assert not any(".quant_state." in k or k.endswith(".absmax") for k in got)
    assert np.array_equal(got["nf4.bias"], want["nf4.bias"])


def test_nf4_weight_the_kernel_cannot_take_raises(tmp_path):
    from forge_tpu_torch.core.state_dict import load_state_dict
    from forge_tpu_torch.core.synth import bnb_serialize

    path = _write(tmp_path, bnb_serialize("odd.weight", torch.from_numpy(_weight((16, 96), 5)),
                                          blocksize=32))
    got = load_state_dict(path)["odd.weight"]  # block 32: dequantized, as the reference does
    assert isinstance(got, np.ndarray) and got.shape == (16, 96)
    w = _weight((16, 48), 6)  # in = 48: NF4's blocks of 64 cross rows
    path = _write(tmp_path, bnb_serialize("bad.weight", torch.from_numpy(w)), "bad.safetensors")
    with pytest.raises(ValueError, match="no kernel"):
        load_state_dict(path)


def _tiny_flux_files(tmp_path):
    """A transformer-only NF4 file (every 2-D matmul weight of out % 128 == 0,
    the leaves forge_tpu's kernel path takes; the rest as they are), a VAE
    file and a text-encoder file."""
    from test_torch_flux import _tiny_flux_checkpoint

    from forge_tpu_torch.core.synth import bnb_serialize

    sd = _tiny_flux_checkpoint()
    unet, vae, tes, n = {}, {}, {}, 0
    for key, value in sd.items():
        if not key.startswith("model.diffusion_model."):
            (vae if key.startswith("first_stage_model.") else tes)[key] = value
            continue
        key = key[len("model.diffusion_model."):]
        if (value.ndim == 2 and value.shape[0] % 128 == 0 and value.shape[1] % 64 == 0
                and not any(t in key for t in ("norm", "emb", "bias"))):
            unet.update(bnb_serialize(key, torch.from_numpy(value)))
            n += 1
        else:
            unet[key] = value
    return (_write(tmp_path, unet, "flux-nf4.safetensors"), _write(tmp_path, vae, "ae.sft"),
            _write(tmp_path, tes, "text_encoders.safetensors"), n)


def test_tiny_flux_from_a_bnb_file_matches_forge_tpu(tmp_path):
    from test_torch_flux import REQUEST

    from forge_tpu.models.flux import FluxConfig as JCfg
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.models.flux import FluxConfig
    from forge_tpu_torch.ops.quant import QuantLeaf
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    unet_path, vae_path, te_path, n_nf4 = _tiny_flux_files(tmp_path)
    modules = {"vae": vae_path, "text_encoders": te_path}
    jeng = jload(unet_path, dtype=jnp.float32, additional_modules=modules)
    jeng.flux_cfg = JCfg(num_heads=4, axes_dim=(4, 6, 6), guidance_embed=True)
    teng = load_engine(unet_path, device="cpu", additional_modules=modules)
    teng.flux_cfg = FluxConfig(num_heads=4, axes_dim=(4, 6, 6))

    def leaves(tree):
        return [v for v in tree.values() if isinstance(v, QuantLeaf)] + [
            leaf for v in tree.values() if isinstance(v, dict) for leaf in leaves(v)]

    assert n_nf4 == 9 and len(leaves(teng.loaded.unet)) == n_nf4
    assert all(leaf.kind == "nf4" for leaf in leaves(teng.loaded.unet))
    want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
    got = process_images(teng, Processing(**REQUEST)).images[0]
    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    value = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert got.shape == want.shape == (32, 32, 3) and value >= 40.0, value


def test_lora_on_a_bnb_leaf_rides_the_epilogue(bnb_file):
    """A LoRA on a weight a bitsandbytes file holds as NF4 is attached online
    (the leaf's codes shared, the factors in its epilogue), as on any
    `QuantLeaf`, and matches dequantize → merge → matmul."""
    from forge_tpu_torch.core.convert import flatten, nest
    from forge_tpu_torch.core.patches import apply_patches, match_lora
    from forge_tpu_torch.core.state_dict import load_state_dict
    from forge_tpu_torch.ops import nn
    from forge_tpu_torch.ops.quant import dequantize

    path, _ = bnb_file
    leaf = load_state_dict(path)["nf4.weight"]
    r = np.random.default_rng(8)
    up = (r.standard_normal((96, 4)) * 0.1).astype(np.float32)
    down = (r.standard_normal((4, 256)) * 0.1).astype(np.float32)
    sd = {"lora_unet_nf4.lora_up.weight": up, "lora_unet_nf4.lora_down.weight": down,
          "lora_unet_nf4.alpha": np.asarray(4.0, np.float32)}
    params = nest({"nf4.weight": leaf})
    matched, unmatched = match_lora(sd, flatten(params).keys())
    assert not unmatched
    patched = apply_patches(params, [(matched["unet"], 0.8)])["nf4"]["weight"]
    assert patched.codes is leaf.codes and patched.lora_down is not None
    x = torch.from_numpy(r.standard_normal((3, 256)).astype(np.float32))
    want = x @ (dequantize(leaf, torch.float32) + 0.8 * torch.from_numpy(up @ down)).T
    got = nn.linear(x, {"weight": patched})
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()

"""fp8 weight storage and fp8 files in the port against forge_tpu (CPU, f32 compute).

- `unet_quant` "fp8", "fp8_e4m3" and "fp8_e5m2" on the tiny Flux and the
  tiny SD1.5 (the reference's tests/test_flux_pipeline.py case, with the
  size cut lowered in both loaders): the same weights are stored fp8 (the
  reference's rule: ≥ 2 dims, conv kernels too, no "norm", "emb" or "bias"),
  with the same values, everything else in the compute dtype; the images
  agree (PSNR ≥ 40 dB);
- a LoRA merged into an fp8 weight is stored re-rounded to fp8 in both;
- an `F8_E4M3` safetensors file: the port reads fp8 values, forge_tpu the
  raw bytes as the numbers 0–255 (a reference-side fault); a Flux file with
  fp8 weights keeps them fp8 in the port's tree (T5's fp8 embedding table
  too) and gives the image of the same values stored in f32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint  # noqa: E402

FP8 = {"fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn,
       "fp8_e5m2": torch.float8_e5m2}
SD15_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
                    seed=1, steps=3, width=64, height=64, sampler_name="Euler a", cfg_scale=7.0)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _engines(family, kind, monkeypatch):
    from forge_tpu.core import loader as jloader
    from forge_tpu.pipeline.engine import load_engine as jload
    from forge_tpu_torch.core import loader
    from forge_tpu_torch.pipeline.engine import load_engine

    monkeypatch.setattr(jloader, "QUANT_MIN_SIZE", 0)  # the tiny weights are below the real cut
    monkeypatch.setattr(loader, "QUANT_MIN_SIZE", 0)
    if family == "flux":
        from test_torch_flux import _tiny_flux_checkpoint

        from forge_tpu.models.flux import FluxConfig as JCfg
        from forge_tpu_torch.models.flux import FluxConfig

        sd = _tiny_flux_checkpoint()
        jeng = jload(dict(sd), dtype=jnp.float32, unet_quant=kind)
        jeng.flux_cfg = JCfg(num_heads=4, axes_dim=(4, 6, 6), guidance_embed=True)
        teng = load_engine(dict(sd), device="cpu", unet_quant=kind)
        teng.flux_cfg = FluxConfig(num_heads=4, axes_dim=(4, 6, 6))
    else:
        from forge_tpu.models.unet import UNetConfig as JCfg
        from forge_tpu_torch.models.unet import UNetConfig

        sd = make_sd15_checkpoint(0)
        jeng = jload(dict(sd), dtype=jnp.float32, unet_quant=kind)
        jeng.unet_cfg = JCfg(context_dim=CLIP_WIDTH, num_heads=4)
        teng = load_engine(dict(sd), device="cpu", unet_quant=kind)
        teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    return jeng, teng


@pytest.mark.parametrize("family", ["flux", "sd15"])
@pytest.mark.parametrize("kind", sorted(FP8))
def test_fp8_storage_matches_forge_tpu(family, kind, monkeypatch):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = _engines(family, kind, monkeypatch)
    jleaves = {k: v for k, v in _flat(jeng.loaded.unet).items() if hasattr(v, "dtype")}
    tleaves = _flat(teng.loaded.unet)
    jfp8 = {k for k, v in jleaves.items() if v.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2)}
    tfp8 = {k for k, v in tleaves.items() if v.dtype == FP8[kind]}
    assert tfp8 == jfp8 and len(tfp8) > 10
    assert not any(v.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
                   for k, v in tleaves.items() if k not in tfp8)
    assert any(tleaves[k].dim() == 4 for k in tfp8) == (family == "sd15")  # conv kernels too
    for key in tfp8:
        want = np.asarray(jleaves[key].astype(jnp.float32))
        if want.ndim == 4:  # forge_tpu holds conv kernels HWIO
            want = want.transpose(3, 2, 0, 1)
        assert np.array_equal(tleaves[key].float().numpy(), want), key
    fields = (dict(prompt="a red fox, (sharp focus:1.2)", seed=3, steps=2, width=32, height=32,
                   cfg_scale=1.0, sampler_name="Euler", scheduler="simple")
              if family == "flux" else SD15_REQUEST)
    want = jproc.process_images(jeng, jproc.Processing(**fields)).images[0]
    got = process_images(teng, Processing(**fields)).images[0]
    assert got.shape == want.shape and _psnr(got, want) >= 40.0, _psnr(got, want)


def test_lora_on_fp8_weight_is_stored_fp8_like_forge_tpu():
    """The merge runs in f32 and is rounded back to the weight's fp8 dtype,
    as the reference's `new_w.astype(w.dtype)`."""
    from forge_tpu.core.patches import apply_patches as japply, match_lora as jmatch
    from forge_tpu.core.tree import get_path as jget, nest as jnest
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.patches import apply_patches, match_lora

    r = np.random.default_rng(3)
    w32 = (r.standard_normal((16, 24)) * 0.5).astype(np.float32)
    w = torch.from_numpy(w32).to(torch.float8_e4m3fn)
    key = "blk.proj.weight"
    sd = {"lora_unet_blk_proj.lora_up.weight": (r.standard_normal((16, 2)) * 0.3).astype(np.float32),
          "lora_unet_blk_proj.lora_down.weight": (r.standard_normal((2, 24)) * 0.3).astype(
              np.float32),
          "lora_unet_blk_proj.alpha": np.asarray(1.0, np.float32)}
    jparams = jnest({key: jnp.asarray(w.float().numpy()).astype(jnp.float8_e4m3fn)})
    want = jget(japply(jparams, [(jmatch(sd, [key])[0]["unet"], 0.8)]), key)
    got = apply_patches(nest({key: w}), [(match_lora(sd, [key])[0]["unet"], 0.8)])["blk"]["proj"][
        "weight"]
    assert got.dtype == torch.float8_e4m3fn and want.dtype == jnp.float8_e4m3fn
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert not torch.equal(got.float(), w.float())  # the patch moved it


def test_fp8_file_reads_as_values_where_forge_tpu_reads_bytes(tmp_path):
    from forge_tpu.core.state_dict import load_state_dict as jload_sd
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.state_dict import load_state_dict

    vals = torch.tensor([[1.0, -0.5, 0.0625, 448.0], [2.0, -3.0, 0.75, 1.5]])
    path = str(tmp_path / "w.safetensors")
    save_safetensors({"a.weight": vals.to(torch.float8_e4m3fn),
                      "b.weight": vals.to(torch.float8_e5m2)}, path)
    got = load_state_dict(path)
    assert got["a.weight"].dtype == torch.float8_e4m3fn
    assert got["b.weight"].dtype == torch.float8_e5m2
    assert torch.equal(got["a.weight"].float(), vals) and torch.equal(got["b.weight"].float(), vals)
    raw = jload_sd(path)["a.weight"]  # the reference: bytes, never viewed as fp8
    assert raw.dtype == np.uint8
    assert np.array_equal(raw, vals.to(torch.float8_e4m3fn).view(torch.uint8).numpy())
    assert raw[0, 0] == 56  # 1.0 in e4m3 is 0x38: the reference multiplies by 56
    from forge_tpu.ops import nn as jnn

    x = np.ones((1, 4), np.float32)
    y = np.asarray(jnn.linear(jnp.asarray(x), {"weight": jnp.asarray(raw)}))
    assert y[0, 0] == float(raw[0].astype(np.float32).sum())
    pt = str(tmp_path / "w.pt")  # a torch checkpoint's float8 storage: fp8 values too
    torch.save({"a.weight": vals.to(torch.float8_e5m2), "b.bias": vals[0]}, pt)
    got = load_state_dict(pt)
    assert got["a.weight"].dtype == torch.float8_e5m2 and torch.equal(got["a.weight"].float(), vals)
    assert isinstance(got["b.bias"], np.ndarray)


def test_fp8_flux_file_keeps_fp8_and_equals_its_values_in_f32(tmp_path, monkeypatch):
    """The transformer's and T5's weights the rule picks written as F8_E4M3:
    the port keeps them fp8 (T5's embedding table is gathered as bytes and
    upcast) and its image equals the engine's over the same values in f32."""
    from test_torch_flux import REQUEST, _tiny_flux_checkpoint

    from forge_tpu_torch.core import loader
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.models.flux import FluxConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    monkeypatch.setattr(loader, "QUANT_MIN_SIZE", 0)
    sd = _tiny_flux_checkpoint()
    stored, dense, picked = {}, {}, []
    for k, v in sd.items():
        if (k.startswith(("model.diffusion_model.", "text_encoders.t5xxl."))
                and loader._stores_fp8(k, v.shape)):
            stored[k] = torch.from_numpy(v).to(torch.float8_e4m3fn)
            dense[k] = stored[k].float().numpy()
            picked.append(k)
        else:
            stored[k] = dense[k] = v
    assert "text_encoders.t5xxl.transformer.shared.weight" in picked
    path = str(tmp_path / "flux-fp8.safetensors")
    save_safetensors(stored, path)
    images = []
    for src in (path, dense):
        eng = load_engine(src, device="cpu")
        eng.flux_cfg = FluxConfig(num_heads=4, axes_dim=(4, 6, 6))
        images.append(process_images(eng, Processing(**REQUEST)).images[0])
        if src is path:
            fp8 = [k for k, v in _flat(eng.loaded.unet).items() if v.dtype == torch.float8_e4m3fn]
            t5 = eng.loaded.text_encoders["t5xxl"]["shared"]["weight"]
            assert len(fp8) == sum(k.startswith("model.") for k in picked)
            assert t5.dtype == torch.float8_e4m3fn
    assert np.array_equal(images[0], images[1])

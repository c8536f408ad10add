"""The port's SwinIR (forge_tpu_torch/models/swinir.py) against forge_tpu's
(CPU, f32).

The window partition and reverse, the shifted windows' mask and the
numpy-style reflect pad equal forge_tpu's; a tiny SwinIR
(tests/torch_restoration_cases.py) with each upsampler at ×2 and ×4, read
from one `.safetensors` file by both packages' loaders, within 1e-4 of the
output's largest value, with the meta (window, heads, scale) equal, and at
SwinIR-M's published widths the meta of the synthetic file equal too.
Two divergences from the reference, each shown from both sides: its pixel
shuffle reads the upsample conv's channels in another order than torch's
`PixelShuffle` (the port is torch's: the reference computes on a copy with
those channels reordered what the port computes on the file), and SwinIR-L's
`resi_connection="3conv"`, which the reference fails on in the forward and
the port refuses at load with a ValueError naming "3conv". The registry
upscales the real-SR file as forge_tpu's registry does (uint8 within 1).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_restoration_cases import (nchw, nhwc, reference_sd, reference_shuffle_order,  # noqa: E402
                                     reference_tree, rel_err, tiny_sd, write)


def test_window_helpers_match_reference():
    from forge_tpu.models import swinir as ref
    from forge_tpu_torch.models import swinir as port

    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)
    win = port.window_partition(torch.from_numpy(x), 4)
    assert np.array_equal(win.numpy(), np.asarray(ref._window_partition(jnp.asarray(x), 4)))
    assert np.array_equal(port.window_reverse(win, 4, 8, 12).numpy(), x)
    for h, w, ws, shift in ((8, 12, 4, 2), (16, 16, 8, 4)):
        assert np.array_equal(port.shift_mask(h, w, ws, shift), ref._shift_mask(h, w, ws, shift))


@pytest.mark.parametrize("h,w,ph,pw", [(20, 28, 44, 36), (3, 5, 10, 1), (8, 8, 0, 7), (1, 4, 3, 2)])
def test_reflect_pad_is_numpys(h, w, ph, pw):
    """jnp.pad's "reflect" (the reference's padding to the window) past the
    image's own size, where F.pad refuses."""
    from forge_tpu_torch.models.swinir import reflect_pad

    x = np.random.default_rng(1).standard_normal((1, 2, h, w)).astype(np.float32)
    want = np.pad(x, ((0, 0), (0, 0), (0, ph), (0, pw)), mode="reflect")
    assert np.array_equal(reflect_pad(torch.from_numpy(x), ph, pw).numpy(), want)


def test_pixel_shuffle_order_both_sides():
    """forge_tpu's shuffle ≠ torch's on the same channels; on the channels
    reordered by `reference_shuffle_order` it equals the port's (torch's)."""
    from forge_tpu.models.swinir import _pixel_shuffle

    for r in (2, 3):
        x = np.random.default_rng(r).standard_normal((1, 3 * r * r, 4, 5)).astype(np.float32)
        port = nhwc(torch.nn.functional.pixel_shuffle(torch.from_numpy(x), r))
        ref = np.asarray(_pixel_shuffle(jnp.asarray(x.transpose(0, 2, 3, 1)), r))
        assert not np.allclose(port, ref)
        # the channels as the reference must read them: a 1×1 identity conv's rows reordered
        perm = reference_shuffle_order({"c.weight": np.arange(3 * r * r)}, ["c"], r)["c.weight"]
        ref = np.asarray(_pixel_shuffle(jnp.asarray(x[:, perm].transpose(0, 2, 3, 1)), r))
        assert np.array_equal(port, ref)


@pytest.mark.parametrize("upsampler,scale", [("nearest+conv", 2), ("nearest+conv", 4),
                                             ("pixelshuffle", 2), ("pixelshuffle", 4)])
def test_swinir_matches_reference(tmp_path, upsampler, scale):
    from forge_tpu.models import swinir as ref
    from forge_tpu_torch.core.convert import tree_to
    from forge_tpu_torch.core.state_dict import load_state_dict
    from forge_tpu_torch.models import swinir as port

    sd = tiny_sd("swinir", seed=scale, upsampler=upsampler, scale=scale)
    path = write(sd, str(tmp_path / "swinir.safetensors"))
    jparams = ref.load_swinir(write(reference_sd(sd), str(tmp_path / "ref.safetensors")))
    tparams = tree_to(port.load_swinir(load_state_dict(path)), "cpu", torch.float32)
    meta = port.infer_swinir_meta(tparams)
    assert meta == ref.infer_swinir_meta(jparams) == {"window_size": 4, "heads": 2, "scale": scale}
    x = np.random.default_rng(2).uniform(0, 1, (1, 10, 14, 3)).astype(np.float32)
    want = np.asarray(ref.swinir_apply(jparams, jnp.asarray(x), **meta))
    got = nhwc(port.swinir_apply(tparams, nchw(x), **meta))
    assert got.shape == want.shape == (1, 10 * scale, 14 * scale, 3)
    assert rel_err(got, want) < 1e-4


def test_swinir_m_published_meta():
    """003_realSR SwinIR-M ×4's widths: both packages read window 8, 6 heads, ×4."""
    from forge_tpu.models.swinir import infer_swinir_meta as jmeta
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.synth import synth_swinir_sd
    from forge_tpu_torch.models.swinir import infer_swinir_meta

    sd = synth_swinir_sd(fill="zeros")
    meta = infer_swinir_meta(nest({k: torch.from_numpy(v) for k, v in sd.items()}))
    assert meta == jmeta(reference_tree(sd)) == {"window_size": 8, "heads": 6, "scale": 4}
    assert sd["layers.5.conv.weight"].shape == (180, 180, 3, 3)
    assert sd["layers.0.residual_group.blocks.1.attn_mask"].shape == (64, 64, 64)


def test_3conv_refused_both_sides(tmp_path):
    """SwinIR-L's 3conv groups: the reference's forward reads `conv.weight`
    and fails; the port's loader raises a ValueError naming 3conv."""
    from forge_tpu.models import swinir as ref
    from forge_tpu_torch.models import swinir as port

    sd = tiny_sd("swinir", resi_connection="3conv", upsampler="nearest+conv", scale=2)
    path = write(sd, str(tmp_path / "swinir_l.safetensors"))
    jparams = ref.load_swinir(path)
    x = jnp.zeros((1, 8, 8, 3), jnp.float32)
    with pytest.raises(KeyError):
        ref.swinir_apply(jparams, x, window_size=4, heads=2, scale=2)
    with pytest.raises(ValueError, match="3conv"):
        port.load_swinir(sd)


def test_registry_upscales_swinir_as_reference(tmp_path):
    """A real-SR file in models/SwinIR through both registries: ×4 in 8²
    tiles (the SWIN_tile options), then ×2 (the model's ×4 and Lanczos ½);
    uint8 within 1 of forge_tpu's (the last step truncates)."""
    from forge_tpu.pipeline.upscalers import UpscalerRegistry as JRegistry
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry
    from forge_tpu_torch.runtime.options import opts

    write(tiny_sd("swinir", seed=5, upsampler="nearest+conv", scale=4),
          str(tmp_path / "SwinIR" / "swinir_tiny.safetensors"))
    dirs = {"SwinIR": str(tmp_path / "SwinIR")}
    reg, jreg = UpscalerRegistry(model_dirs=dirs, device="cpu"), JRegistry(model_dirs=dirs)
    img = np.random.default_rng(6).integers(0, 256, (20, 12, 3), dtype=np.uint8)
    tiles = {"SWIN_tile": 8, "SWIN_tile_overlap": 2}
    with opts.override(tiles), jopts.override(tiles):
        for scale in (4.0, 2.0):
            want = jreg.get("swinir_tiny").upscale(img, scale)
            got = reg.get("swinir_tiny").upscale(img, scale)
            assert got.shape == want.shape == (int(20 * scale), int(12 * scale), 3)
            diff = np.abs(got.astype(np.int16) - want)
            assert diff.max() <= 1 and diff.mean() < 0.05, (diff.max(), diff.mean())
            assert got.std() > 5

"""Port's CLIP, UNet and VAE decoder against forge_tpu and the golden fixtures (CPU, f32).

Each model runs on the tests/fixtures.py tiny state dicts twice: once with
the weights forge_tpu computed with, converted back by `params_from_jax`,
and once from the flat checkpoint dict as the port's loader sees it. Both
must agree with forge_tpu to 1e-4 of the output's scale (f32 on both sides;
only summation order differs). The golden fixtures (reference torch nets,
NCHW) are held to PSNR ≥ 40 dB, the bar tests/test_golden_parity.py uses.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from fixtures import CTX, make_clip_sd, make_unet_sd, make_vae_sd  # noqa: E402

from forge_tpu.core.state_dict import transform_for_jax  # noqa: E402
from forge_tpu.core.tree import nest as jax_nest  # noqa: E402
from forge_tpu_torch.core.convert import nest, params_from_jax  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SOURCES = ["params_from_jax", "flat_dict"]


def _psnr(ours, ref):
    mse = float(np.mean((ours - ref) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(float(np.max(np.abs(ref))) ** 2 / mse)


def _jax_tree(sd):
    return jax_nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})


def _torch_tree(sd, jax_tree, source):
    if source == "params_from_jax":
        return nest(params_from_jax(jax_tree))
    return nest({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})


def _assert_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(np.abs(want).max(), 1.0), err


@pytest.fixture(scope="module")
def unet_golden():
    return np.load(os.path.join(GOLDEN, "unet_sd15_tiny.npz"))


@pytest.mark.parametrize("source", SOURCES)
def test_unet(unet_golden, source):
    from forge_tpu.models.unet import UNetConfig as JCfg, unet_apply as junet
    from forge_tpu_torch.models.unet import UNetConfig, unet_apply

    g = unet_golden
    sd = make_unet_sd(prefix="", seed=1)
    jtree = _jax_tree(sd)
    want = np.asarray(junet(jtree, jnp.asarray(g["x"].transpose(0, 2, 3, 1)),
                            jnp.asarray(g["t"]), jnp.asarray(g["ctx"]),
                            cfg=JCfg(context_dim=CTX, num_heads=4))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = unet_apply(_torch_tree(sd, jtree, source), torch.from_numpy(g["x"]),
                         torch.from_numpy(g["t"]), torch.from_numpy(g["ctx"]),
                         cfg=UNetConfig(context_dim=CTX, num_heads=4)).numpy()
    _assert_close(got, want)
    assert _psnr(got, g["ref"]) >= 40.0


@pytest.mark.parametrize("source", SOURCES)
def test_vae_decode(source):
    from forge_tpu.models.vae import vae_decode as jdecode
    from forge_tpu_torch.models.vae import vae_decode

    g = np.load(os.path.join(GOLDEN, "vae_sd15_tiny.npz"))
    sd = make_vae_sd(prefix="", seed=2)
    jtree = _jax_tree(sd)
    want = np.asarray(jdecode(jtree, jnp.asarray(g["z"].transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = vae_decode(_torch_tree(sd, jtree, source), torch.from_numpy(g["z"])).numpy()
    _assert_close(got, want.transpose(0, 3, 1, 2))
    assert _psnr(got, g["dec"]) >= 40.0


@pytest.mark.parametrize("source", SOURCES)
def test_clip(source):
    from forge_tpu.models.clip import ClipConfig as JCfg, clip_text_apply as jclip
    from forge_tpu_torch.models.clip import ClipConfig, clip_text_apply

    g = np.load(os.path.join(GOLDEN, "clip_sd15_tiny.npz"))
    sd = make_clip_sd(prefix="", seed=3)
    jtree = jax_nest({k: jnp.asarray(v) for k, v in sd.items()})
    jfinal, jhid, jpooled = jclip(jtree, jnp.asarray(g["toks"].astype(np.int32)),
                                  cfg=JCfg(num_heads=4, act="quick_gelu"))
    with torch.no_grad():
        final, hiddens, pooled = clip_text_apply(
            _torch_tree(sd, jtree, source), torch.from_numpy(g["toks"]),
            cfg=ClipConfig(num_heads=4))
    _assert_close(final.numpy(), np.asarray(jfinal))
    _assert_close(hiddens[-2].numpy(), np.asarray(jhid[-2]))
    _assert_close(pooled.numpy(), np.asarray(jpooled))
    assert _psnr(final.numpy(), g["ref"]) >= 40.0
    assert _psnr(hiddens[-2].numpy(), g["hidden_m2"]) >= 40.0  # clip-skip tap
    assert np.abs(pooled.numpy() - g["pooled"]).max() < 1e-4

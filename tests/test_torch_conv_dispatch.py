"""Which body of the fused GroupNorm+SiLU+conv3x3 kernel a call takes, and
the wrapper's argument checks that hold on any device (nothing here needs a
card)."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from forge_tpu_torch.ops.fused_gn_conv import (BODY_CODES, conv_body,  # noqa: E402
                                               gn_silu_conv3x3, gn_silu_conv3x3_plain)
from test_torch_flash_dispatch import sdxl_1024_calls  # noqa: E402

# (C, O) of every fused conv on the two main paths: the SD1.5 UNet's resblocks
# (input, middle and output blocks, the skip concats included) and both VAE
# decoders' resnets (SD1.5's and Flux's have the same widths)
UNET = [(320, 320), (320, 640), (640, 640), (640, 1280), (1280, 1280), (2560, 1280),
        (1920, 1280), (1920, 640), (1280, 640), (960, 640), (960, 320), (640, 320)]
VAE = [(512, 512), (512, 256), (256, 256), (256, 128), (128, 128)]


@pytest.mark.parametrize("c,o", UNET + VAE)
def test_every_main_path_conv_takes_the_tensor_core_body_in_bf16(c, o):
    assert conv_body(c, o, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("c,o", UNET + VAE)
def test_f32_stays_on_simt(c, o):
    """TF32 tensor cores would break the f32 1e-4 bound."""
    assert conv_body(c, o, torch.float32) == "simt"


@pytest.mark.parametrize("c,o,dtype,body", [
    (36, 40, torch.bfloat16, "simt"),    # the ragged test shape: TMA needs C % 8 == 0
    (4, 320, torch.bfloat16, "simt"),    # a latent's 4 channels
    (100, 64, torch.bfloat16, "simt"),
    (8, 8, torch.bfloat16, "wgmma"),     # the smallest C the body takes
    (72, 40, torch.bfloat16, "wgmma"),   # O takes no part: its tail is masked
    (64, 3, torch.bfloat16, "wgmma"),
    (320, 320, torch.float16, "simt"),
])
def test_conv_body_edges(c, o, dtype, body):
    assert conv_body(c, o, dtype) == body


def test_bodies_and_their_counters():
    assert BODY_CODES == {"simt": 0, "wgmma": 1}
    assert set(gn_silu_conv3x3.launches_by_body) == set(BODY_CODES)


def _inputs(dtype, c=64, o=32, seed=0):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((1, c, 5, 6), dtype=np.float32)).to(dtype)
    a = torch.from_numpy(1.0 + 0.1 * r.standard_normal((1, c), dtype=np.float32))
    s = torch.from_numpy(0.1 * r.standard_normal((1, c), dtype=np.float32))
    w = torch.from_numpy(0.05 * r.standard_normal((o, c, 3, 3), dtype=np.float32)).to(dtype)
    bias = torch.from_numpy(0.1 * r.standard_normal(o, dtype=np.float32))
    return x, a, s, w, bias


@pytest.mark.parametrize("body", [None, "simt", "wgmma"])
def test_cpu_call_runs_the_plain_version_and_counts_nothing(body):
    x, a, s, w, bias = _inputs(torch.bfloat16)
    total, by_body = gn_silu_conv3x3.launches, dict(gn_silu_conv3x3.launches_by_body)
    got = gn_silu_conv3x3(x, a, s, w, bias, body=body)
    assert torch.equal(got, gn_silu_conv3x3_plain(x, a, s, w, bias))
    assert gn_silu_conv3x3.launches == total and gn_silu_conv3x3.launches_by_body == by_body


def test_wgmma_body_is_refused_for_f32():
    with pytest.raises(TypeError, match="bfloat16"):
        gn_silu_conv3x3(*_inputs(torch.float32), body="wgmma")


@pytest.mark.parametrize("body", ["tensor", "SIMT", "", "cudnn"])
def test_unknown_body_is_refused(body):
    with pytest.raises(ValueError, match="body"):
        gn_silu_conv3x3(*_inputs(torch.bfloat16), body=body)


def test_channels_last_weight_gives_the_same_plain_result():
    """The loader stores the fused convs' weights channels_last on the card;
    the plain version reads either layout alike."""
    x, a, s, w, bias = _inputs(torch.float32)
    want = gn_silu_conv3x3_plain(x, a, s, w, bias)
    got = gn_silu_conv3x3_plain(x, a, s, w.contiguous(memory_format=torch.channels_last), bias)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_every_sdxl_resblock_and_vae_conv_takes_the_tensor_core_body():
    """34 a forward (17 ResBlocks × 2) at the twelve (C, O, latent size) of
    SDXL at 1024², C 320 on 128² latents among them, and the VAE decoder's
    28 (14 resnets × 2); all on the tensor-core body in bf16."""
    unet, vae = sdxl_1024_calls()["conv"]
    assert len(unet) == 34 and len(vae) == 28
    assert all(body == "wgmma" for _, _, body in unet + vae)
    assert {(x, o) for x, o, _ in unet} == {
        ((2, 320, 128, 128), 320), ((2, 960, 128, 128), 320), ((2, 640, 128, 128), 320),
        ((2, 320, 64, 64), 640), ((2, 640, 64, 64), 640), ((2, 1920, 64, 64), 640),
        ((2, 1280, 64, 64), 640), ((2, 960, 64, 64), 640), ((2, 640, 32, 32), 1280),
        ((2, 1280, 32, 32), 1280), ((2, 2560, 32, 32), 1280), ((2, 1920, 32, 32), 1280)}
    assert {x[1] for x, _, _ in vae} == {512, 256, 128}

"""forge_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where there is no CUDA device. The
file imports neither jax nor forge_tpu, so it also runs where they are not
installed (tests/conftest.py imports jax, hence `--noconftest`):

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Bounds, relative to max |plain| (no floor of 1: attention outputs of
unit-normal inputs lie far below 1): f32 1e-4 (both sides f32 with TF32 off;
only summation order differs), bf16 2e-2 (a bf16 ulp of max |plain| is 2^-8
to 2^-7 of it; the two round at different points).
"""

import pytest

torch = pytest.importorskip("torch")

from forge_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_plain,  # noqa: E402
                                                 flash_body)
from forge_tpu_torch.ops.fused_gn_conv import (conv_body, gn_silu_conv3x3,  # noqa: E402
                                               gn_silu_conv3x3_plain)

pytestmark = pytest.mark.gpu
BOUNDS = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,lk", [
    ((2, 8, 4096, 40), 4096),   # UNet level-0 self-attention
    ((2, 8, 1024, 80), 1024),   # UNet level-1 self-attention
    ((1, 2, 300, 160), 200),    # level-2 head dim, ragged
    ((1, 1, 4096, 512), 4096),  # VAE single head
    ((1, 2, 1000, 40), 700),    # ragged tails on both sides
    ((3, 1, 17, 8), 5),         # shorter than one tile
])
def test_flash_attention(gen, shape, lk, dtype):
    dt = getattr(torch, dtype)
    b, h, lq, d = shape
    q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dt)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dt
    assert _rel(got, flash_attention_plain(q, k, v)) <= BOUNDS[dtype]
    assert torch.equal(got, flash_attention(q, k, v))  # no atomics: bit-identical reruns


def _qkv(gen, b, h, lq, lk, d, dt=torch.bfloat16):
    return tuple(torch.randn((b, h, n, d), generator=gen, device="cuda").to(dt)
                 for n in (lq, lk, lk))


@pytest.mark.parametrize("shape,lk", [
    ((1, 1, 128, 128), 128),     # one query tile, one K tile
    ((2, 3, 64, 8), 64),         # the smallest head dim, half a query tile
    ((2, 8, 1024, 40), 1024),    # SD1.5 level 0 (d padded to 48 for q·kᵀ, 64 for p·v)
    ((2, 8, 1024, 80), 1024),    # SD1.5 level 1
    ((1, 24, 512, 128), 512),    # Flux joint attention width
    ((1, 2, 300, 160), 200),     # SD1.5 level 2: three boxes, 64-key tiles
    ((1, 1, 1024, 512), 1024),   # VAE single head: output split over two blocks
    ((1, 2, 1000, 128), 700),    # ragged Lq and Lk
    ((1, 2, 1000, 40), 700),
    ((2, 2, 200, 128), 5),       # Lk below one K tile
    ((1, 2, 130, 512), 17),
    ((1, 4, 4608, 128), 4608),   # the K ring wraps 18 times (Flux's L)
    ((2, 10, 4096, 64), 4096),   # SDXL level 1 at 1024²: head dim 64, 10 heads
    ((2, 20, 1024, 64), 1024),   # SDXL level 2 and the middle block: 20 heads
    ((1, 2, 1000, 64), 700),     # ragged Lq and Lk at head dim 64
    ((4, 10, 4096, 64), 4096),   # config 5 serving: CFG batch 4
    ((4, 20, 1024, 64), 1024),
    ((2, 10, 2304, 64), 2304),   # a MultiDiffusion 96² tile's level 1 (48² tokens)
    ((2, 20, 576, 64), 576),     # its level 2: 4.5 query tiles, the Lq tail on the main path
    ((2, 1, 16384, 512), 16384),  # the VAE decoding a batch of 2 at 1024²
])
def test_flash_attention_wgmma_body(gen, shape, lk):
    b, h, lq, d = shape
    q, k, v = _qkv(gen, b, h, lq, lk, d)
    assert flash_body(d, torch.bfloat16) == "wgmma"
    before = dict(flash_attention.launches_by_body)
    got = flash_attention(q, k, v)
    assert flash_attention.launches_by_body == {n: c + (n == "wgmma") for n, c in before.items()}
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _rel(got, flash_attention_plain(q, k, v)) <= BOUNDS["bfloat16"]
    assert torch.equal(got, flash_attention(q, k, v))  # no atomics: bit-identical reruns


def test_flash_attention_vae_at_2048(gen):
    """The VAE mid-block at 2048²: one head of 512 over 65536 tokens. Plain
    attention would hold 65536² f32 logits (16 GiB), so the first and last
    1024 query rows are held against all of K and V: rows are independent."""
    q, k, v = _qkv(gen, 1, 1, 65536, 65536, 512)
    rows = torch.cat([torch.arange(1024), torch.arange(65536 - 1024, 65536)]).cuda()
    before = flash_attention.launches_by_body["wgmma"]
    got = flash_attention(q, k, v)
    assert flash_attention.launches_by_body["wgmma"] == before + 1
    assert _rel(got[:, :, rows], flash_attention_plain(q[:, :, rows], k, v)) <= BOUNDS["bfloat16"]


def test_flash_attention_small_true_scores(gen):
    """Rows whose every true score is far below 0: K's zero-filled tail rows
    (score 0) must not take the softmax's mass."""
    q, k, v = _qkv(gen, 1, 2, 256, 70, 128)
    k = (k.float().abs() + 1.0).bfloat16()
    q = -(q.float().abs() + 1.0).bfloat16()
    got = flash_attention(q, k, v)
    assert _rel(got, flash_attention_plain(q, k, v)) <= BOUNDS["bfloat16"]


def test_flash_attention_body_override(gen):
    q, k, v = _qkv(gen, 1, 2, 600, 600, 128)
    before = dict(flash_attention.launches_by_body)
    simt = flash_attention(q, k, v, body="simt")
    tc = flash_attention(q, k, v, body="wgmma")
    assert flash_attention.launches_by_body == {n: c + 1 for n, c in before.items()}
    want = flash_attention_plain(q, k, v)
    assert _rel(simt, want) <= BOUNDS["bfloat16"] and _rel(tc, want) <= BOUNDS["bfloat16"]
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), body="wgmma")
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q[..., :36], k[..., :36], v[..., :36], body="wgmma")


def test_flash_attention_f32_and_odd_dims_stay_on_simt(gen):
    for dt, d in ((torch.float32, 128), (torch.bfloat16, 36)):
        q, k, v = _qkv(gen, 1, 2, 300, 200, d, dt)
        before = flash_attention.launches_by_body["simt"]
        got = flash_attention(q, k, v)
        assert flash_attention.launches_by_body["simt"] == before + 1
        assert _rel(got, flash_attention_plain(q, k, v)) <= BOUNDS[str(dt)[6:]]


def test_flash_attention_non_contiguous(gen):
    x = torch.randn((2, 600, 8 * 40), generator=gen, device="cuda").bfloat16()
    q = x.reshape(2, 600, 8, 40).transpose(1, 2)
    got = flash_attention(q, q, q)
    assert _rel(got, flash_attention_plain(q, q, q)) <= BOUNDS["bfloat16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,o", [
    ((2, 320, 64, 64), 320),     # UNet level-0 resblock
    ((2, 960, 32, 32), 640),     # UNet output block after a skip concat
    ((2, 2560, 8, 8), 1280),     # UNet level-3 output block
    ((1, 512, 128, 128), 512),   # VAE decoder level 2
    ((1, 36, 13, 21), 40),       # ragged H, W, C and O
])
def test_gn_silu_conv3x3(gen, shape, o, dtype):
    dt = getattr(torch, dtype)
    b, c, h, w_ = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    a = 1.0 + 0.1 * torch.randn((b, c), generator=gen, device="cuda")
    s = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
    w = (torch.randn((o, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5).to(dt)
    bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
    before, body = gn_silu_conv3x3.launches, conv_body(c, o, dt)
    before_body = gn_silu_conv3x3.launches_by_body[body]
    got = gn_silu_conv3x3(x, a, s, w, bias)
    assert gn_silu_conv3x3.launches == before + 1
    assert gn_silu_conv3x3.launches_by_body[body] == before_body + 1
    assert got.shape == (b, o, h, w_) and got.dtype == dt
    assert _rel(got, gn_silu_conv3x3_plain(x, a, s, w, bias)) <= BOUNDS[dtype]
    assert torch.equal(got, gn_silu_conv3x3(x, a, s, w, bias))


def test_gn_silu_conv3x3_pad_is_zero(gen):
    """Constant x with a large shift: border outputs see only in-image taps."""
    c, o = 64, 32
    x = torch.zeros((1, c, 6, 6), device="cuda")
    a = torch.ones((1, c), device="cuda")
    s = torch.full((1, c), 4.0, device="cuda")
    w = torch.full((o, c, 3, 3), 0.01, device="cuda")
    got = gn_silu_conv3x3(x, a, s, w, None)
    inner = c * 0.01 * 4.0 / (1.0 + torch.exp(torch.tensor(-4.0))).item()
    assert abs(got[0, 0, 0, 0].item() - 4 * inner) < 1e-4
    assert abs(got[0, 0, 3, 3].item() - 9 * inner) < 1e-4


def _conv_inputs(gen, b, c, h, w_, o, dt=torch.bfloat16):
    x = torch.randn((b, c, h, w_), generator=gen, device="cuda").to(dt)
    a = 1.0 + 0.1 * torch.randn((b, c), generator=gen, device="cuda")
    s = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
    w = (torch.randn((o, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5).to(dt)
    bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
    return x, a, s, w, bias


def _check_wgmma_conv(gen, b, c, h, w_, o):
    x, a, s, w, bias = _conv_inputs(gen, b, c, h, w_, o)
    assert conv_body(c, o, torch.bfloat16) == "wgmma"
    before = dict(gn_silu_conv3x3.launches_by_body)
    got = gn_silu_conv3x3(x, a, s, w.contiguous(memory_format=torch.channels_last), bias)
    assert gn_silu_conv3x3.launches_by_body == {n: k + (n == "wgmma") for n, k in before.items()}
    assert got.shape == (b, o, h, w_) and got.dtype == torch.bfloat16
    assert _rel(got, gn_silu_conv3x3_plain(x, a, s, w, bias)) <= BOUNDS["bfloat16"]
    assert torch.equal(got, gn_silu_conv3x3(x, a, s, w, bias))  # OIHW too; bit-identical reruns


@pytest.mark.parametrize("c", [64, 128, 320, 960, 2560])
@pytest.mark.parametrize("o", [64, 128, 320, 1280])
def test_gn_silu_conv3x3_wgmma_body(gen, c, o):
    """Every channel-block width (BN 64, 128, 160, 256) and chunk count."""
    _check_wgmma_conv(gen, 2, c, 12, 20, o)


@pytest.mark.parametrize("shape,o", [
    ((2, 128, 13, 100), 64),   # ragged pixel tiles in both directions
    ((1, 64, 8, 8), 64),       # half of one 128-pixel tile
    ((1, 64, 3, 1024), 128),   # a W = 1024 strip: 32 tiles along a row
    ((1, 64, 5, 1), 24),       # W = 1: the largest halo, O past one 8-column group
    ((1, 72, 9, 7), 40),       # C not a multiple of 64: a zero-filled chunk tail
    ((3, 256, 32, 32), 256),   # several waves of blocks
    ((2, 2560, 8, 8), 1280),   # UNet level 3: both images in one tile, the channel walk split
    ((3, 64, 4, 4), 40),       # three whole images in one tile
    ((2, 1280, 16, 16), 320),  # UNet level 2 widths: a split channel walk
    ((2, 320, 128, 128), 320),  # SDXL level 0 at 1024²: C 320 on 128² latents
    ((2, 1920, 64, 64), 640),   # SDXL level-1 output block after a skip concat
    ((2, 2560, 32, 32), 1280),  # SDXL level-2 output block after a skip concat
    ((2, 320, 96, 96), 320),    # config 5: a MultiDiffusion 96² tile, levels 0, 1 and 2
    ((2, 1920, 48, 48), 640),
    ((2, 2560, 24, 24), 1280),
    ((4, 960, 128, 128), 320),  # config 5 serving: CFG batch 4
    ((4, 2560, 32, 32), 1280),
    ((1, 128, 2048, 2048), 128),  # the VAE at 2048²
    ((1, 256, 2048, 2048), 128),  # 2^30 elements in: byte offsets past int32
])
def test_gn_silu_conv3x3_wgmma_ragged(gen, shape, o):
    _check_wgmma_conv(gen, *shape, o)


def test_gn_silu_conv3x3_wgmma_per_image_affine(gen):
    """Batch 2 with very different a and s per image: each image's halo uses its own."""
    x, a, s, w, bias = _conv_inputs(gen, 2, 128, 16, 16, 128)
    a[1] *= -3.0
    s[1] += 2.0
    got = gn_silu_conv3x3(x, a, s, w, bias)
    want = gn_silu_conv3x3_plain(x, a, s, w, bias)
    assert _rel(got[0], want[0]) <= BOUNDS["bfloat16"]
    assert _rel(got[1], want[1]) <= BOUNDS["bfloat16"]


def test_gn_silu_conv3x3_body_override(gen):
    x, a, s, w, bias = _conv_inputs(gen, 1, 128, 20, 24, 64)
    before = dict(gn_silu_conv3x3.launches_by_body)
    simt = gn_silu_conv3x3(x, a, s, w, bias, body="simt")
    tc = gn_silu_conv3x3(x, a, s, w, bias, body="wgmma")
    assert gn_silu_conv3x3.launches_by_body == {n: k + 1 for n, k in before.items()}
    want = gn_silu_conv3x3_plain(x, a, s, w, bias)
    assert _rel(simt, want) <= BOUNDS["bfloat16"] and _rel(tc, want) <= BOUNDS["bfloat16"]
    with pytest.raises(TypeError, match="bfloat16"):
        gn_silu_conv3x3(x.float(), a, s, w.float(), bias, body="wgmma")
    with pytest.raises(ValueError, match="multiple of 8"):
        gn_silu_conv3x3(x[:, :36], a[:, :36], s[:, :36], w[:, :36], bias, body="wgmma")


def test_gn_silu_conv3x3_f32_and_odd_channels_stay_on_simt(gen):
    for dt, c in ((torch.float32, 64), (torch.bfloat16, 36)):
        x, a, s, w, bias = _conv_inputs(gen, 1, c, 13, 21, 40, dt)
        before = gn_silu_conv3x3.launches_by_body["simt"]
        got = gn_silu_conv3x3(x, a, s, w, bias)
        assert gn_silu_conv3x3.launches_by_body["simt"] == before + 1
        assert _rel(got, gn_silu_conv3x3_plain(x, a, s, w, bias)) <= BOUNDS[str(dt)[6:]]


def test_gn_silu_conv3x3_pad_is_zero_bf16(gen):
    """The tensor-core body's halo: constant x with a large shift, so border
    outputs see only in-image taps (a pad of silu(s) ≈ 3.93 would add 5 taps'
    worth at a corner)."""
    c, o = 64, 64
    assert conv_body(c, o, torch.bfloat16) == "wgmma"
    x = torch.zeros((1, c, 6, 6), device="cuda", dtype=torch.bfloat16)
    a = torch.ones((1, c), device="cuda")
    s = torch.full((1, c), 4.0, device="cuda")
    w = torch.full((o, c, 3, 3), 0.01, device="cuda", dtype=torch.bfloat16)
    before = gn_silu_conv3x3.launches_by_body["wgmma"]
    got = gn_silu_conv3x3(x, a, s, w, None).float()
    assert gn_silu_conv3x3.launches_by_body["wgmma"] == before + 1
    act = torch.tensor(4.0 / (1.0 + torch.exp(torch.tensor(-4.0)).item())).bfloat16().item()
    inner = c * torch.tensor(0.01).bfloat16().item() * act
    for (i, j), taps in (((0, 0), 4), ((0, 3), 6), ((3, 3), 9), ((5, 5), 4)):
        # bf16 output: within half an ulp of the exact sum
        assert abs(got[0, 0, i, j].item() - taps * inner) <= taps * inner * 2 ** -8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,block", [("q8_0", 32), ("nf4", 64), ("q4_0", 32), ("gq4", 32),
                                        ("gq8", 32), ("gq4", 16), ("gq8", 16)])
@pytest.mark.parametrize("m,n,k", [
    (300, 256, 512),    # ragged M
    (4, 64, 3072),      # N = 64: Flux final_layer, the reference's KeyError leaf
    (130, 3072, 64),    # K = 64: Flux img_in
    (1, 1000, 256),     # M = 1 (adaLN modulation), ragged N
    (77, 200, 96),      # K that is a multiple of the block only
])
def test_dequant_matmul(gen, kind, block, m, n, k, dtype):
    from forge_tpu_torch.ops import quant
    from forge_tpu_torch.ops.dequant_matmul import dequant_matmul, dequant_matmul_plain

    if k % block:
        pytest.skip(f"K = {k} is not a multiple of the {kind} block {block}")
    dt = getattr(torch, dtype)
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.05
    leaf = (getattr(quant, f"quantize_{kind}")(w, block=block) if kind in ("gq4", "gq8")
            else quant.quantize(w, kind))
    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    before = dequant_matmul.launches
    got = dequant_matmul(x, leaf)
    assert dequant_matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == dt
    assert _rel(got, dequant_matmul_plain(x, leaf)) <= BOUNDS[dtype]
    assert torch.equal(got, dequant_matmul(x, leaf))  # no atomics: bit-identical reruns


KINDS = [("q8_0", 32), ("nf4", 64), ("q4_0", 32), ("gq4", 32), ("gq8", 32), ("gq4", 16),
         ("gq8", 16)]


def _leaf(gen, kind, block, n, k):
    from forge_tpu_torch.ops import quant

    w = torch.randn((n, k), generator=gen, device="cuda") * 0.05
    return (getattr(quant, f"quantize_{kind}")(w, block=block) if kind in ("gq4", "gq8")
            else quant.quantize(w, kind))


@pytest.mark.parametrize("kind,block", KINDS)
@pytest.mark.parametrize("m,n,k,body", [
    (1, 18432, 512, "wgmma"),   # M = 1 (adaLN modulation): one token of a 128-token tile
    (63, 256, 512, "wgmma"),
    (64, 256, 512, "wgmma"),
    (65, 256, 512, "wgmma"),
    (129, 256, 512, "wgmma"),   # a masked second 128-token tile
    (256, 200, 512, "wgmma"),   # N not a multiple of the 128-column tile
    (300, 1000, 256, "wgmma"),  # ragged M and N
    (128, 256, 96, "wgmma"),    # K not a multiple of 64: a zero-filled last K step
    (192, 384, 3072, "wgmma"),  # K = 3072: the ring of stages wraps 48 times
    (1000, 17000, 128, "wgmma"),  # 256-token tiles, with M and N tails
])
def test_dequant_matmul_bf16_bodies(gen, kind, block, m, n, k, body):
    from forge_tpu_torch.ops.dequant_matmul import (dequant_body, dequant_matmul,
                                                    dequant_matmul_plain)

    if k % block:
        pytest.skip(f"K = {k} is not a multiple of the {kind} block {block}")
    assert dequant_body(m, torch.bfloat16) == body
    leaf = _leaf(gen, kind, block, n, k)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    before = dict(dequant_matmul.launches_by_body)
    got = dequant_matmul(x, leaf)
    assert dequant_matmul.launches_by_body == {b: c + (b == body) for b, c in before.items()}
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel(got, dequant_matmul_plain(x, leaf)) <= BOUNDS["bfloat16"]
    assert torch.equal(got, dequant_matmul(x, leaf))  # no atomics: bit-identical reruns


def test_dequant_matmul_zero_rows_launch_nothing(gen):
    from forge_tpu_torch.ops.dequant_matmul import dequant_matmul

    leaf = _leaf(gen, "nf4", 64, 384, 512)
    before = dict(dequant_matmul.launches_by_body)
    got = dequant_matmul(torch.empty((0, 512), device="cuda", dtype=torch.bfloat16), leaf)
    assert got.shape == (0, 384) and dequant_matmul.launches_by_body == before


def test_dequant_matmul_body_override(gen):
    from forge_tpu_torch.ops.dequant_matmul import dequant_matmul, dequant_matmul_plain

    leaf = _leaf(gen, "nf4", 64, 384, 512)
    x = torch.randn((300, 512), generator=gen, device="cuda").bfloat16()
    before = dequant_matmul.launches_by_body["simt"]
    simt = dequant_matmul(x, leaf, body="simt")
    assert dequant_matmul.launches_by_body["simt"] == before + 1
    assert _rel(simt, dequant_matmul_plain(x, leaf)) <= BOUNDS["bfloat16"]
    with pytest.raises(TypeError, match="bfloat16"):
        dequant_matmul(x.float(), leaf, body="wgmma")


def test_dequant_matmul_refuses_an_unsupported_leaf(gen):
    from forge_tpu_torch.ops import quant
    from forge_tpu_torch.ops.dequant_matmul import dequant_matmul

    leaf = quant.quantize(torch.randn((64, 96), generator=gen, device="cuda"), "q8_0")
    with pytest.raises(ValueError, match="columns"):
        dequant_matmul(torch.randn((2, 128), device="cuda"), leaf)
    with pytest.raises(TypeError, match="dtype"):
        dequant_matmul(torch.randn((2, 96), device="cuda").half(), leaf)

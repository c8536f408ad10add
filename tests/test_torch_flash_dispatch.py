"""Which body of the flash-attention kernel a call takes, and the wrapper's
argument checks that hold on any device (nothing here needs a card)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from forge_tpu_torch.ops.flash_attention import (BODY_CODES, flash_attention,  # noqa: E402
                                                 flash_attention_plain, flash_body)


@pytest.mark.parametrize("d,dtype,body", [
    (40, torch.bfloat16, "wgmma"),    # SD1.5 level 0
    (80, torch.bfloat16, "wgmma"),    # SD1.5 level 1
    (128, torch.bfloat16, "wgmma"),   # Flux joint attention
    (512, torch.bfloat16, "wgmma"),   # both VAEs' mid-block
    (8, torch.bfloat16, "wgmma"),
    (160, torch.bfloat16, "wgmma"),   # SD1.5 level 2
    (36, torch.bfloat16, "simt"),     # TMA needs 16-byte rows: d % 8 == 0
    (100, torch.bfloat16, "simt"),
    (40, torch.float32, "simt"),      # f32 never takes TF32 tensor cores
    (128, torch.float32, "simt"),
    (512, torch.float32, "simt"),
    (128, torch.float16, "simt"),
])
def test_flash_body(d, dtype, body):
    assert flash_body(d, dtype) == body


def test_bodies_and_their_counters():
    assert set(BODY_CODES) == {"simt", "wgmma"}
    assert set(flash_attention.launches_by_body) == set(BODY_CODES)


def _qkv(dtype, d=40, lq=70, lk=50, seed=0):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal((1, 2, n, d), dtype=np.float32)).to(dtype)
                 for n in (lq, lk, lk))


@pytest.mark.parametrize("body", [None, "simt", "wgmma"])
def test_cpu_call_runs_the_plain_version_and_counts_nothing(body):
    q, k, v = _qkv(torch.bfloat16)
    total, by_body = flash_attention.launches, dict(flash_attention.launches_by_body)
    got = flash_attention(q, k, v, body=body)
    assert torch.equal(got, flash_attention_plain(q, k, v))
    assert flash_attention.launches == total and flash_attention.launches_by_body == by_body


def test_wgmma_body_is_refused_for_f32():
    q, k, v = _qkv(torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, k, v, body="wgmma")


@pytest.mark.parametrize("body", ["tensor", "SIMT", "", "cuda"])
def test_unknown_body_is_refused(body):
    q, k, v = _qkv(torch.bfloat16)
    with pytest.raises(ValueError, match="body"):
        flash_attention(q, k, v, body=body)


@functools.lru_cache(maxsize=None)
def sdxl_1024_calls():
    """Every flash and fused-conv call of one full-width SDXL UNet forward at
    1024² (cond and uncond batched) and of one VAE decode, traced on the meta
    device: shapes flow through the port's own code, no weight or activation
    is made. Returns {kernel: (unet calls, vae calls)}, a flash call as
    (q shape, Lk, body) and a conv call as (x shape, O, body); the conv
    dispatch tests read the same trace."""
    from forge_tpu_torch.core import guess
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_checkpoint
    from forge_tpu_torch.models import unet as unet_mod
    from forge_tpu_torch.models import vae as vae_mod
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.ops import fused_gn_conv

    g = guess.guess(synth_sdxl_checkpoint(fill=DeviceFill("cpu")))

    def meta(shape):
        return torch.empty(shape, device="meta", dtype=torch.bfloat16)

    def tree(sd):
        return nest({k: meta(v.shape) for k, v in sd.items()})

    calls = {"flash": [], "conv": []}

    def flash(q, k, v, scale=None, body=None):
        calls["flash"].append((tuple(q.shape), k.shape[2], flash_body(q.shape[-1], q.dtype)))
        return torch.empty_like(q)

    def conv(x, a, s, w, bias, body=None):
        body = fused_gn_conv.conv_body(x.shape[1], w.shape[0], x.dtype)
        calls["conv"].append((tuple(x.shape), w.shape[0], body))
        return meta((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_mod, "flash_attention", flash)
        mp.setattr(fused_gn_conv, "gn_silu_conv3x3", conv)
        unet_mod.unet_apply(tree(g.unet), meta((2, 4, 128, 128)), torch.empty(2, device="meta"),
                            meta((2, 77, 2048)), y=meta((2, 2816)),
                            cfg=unet_mod.UNetConfig.for_family("sdxl"))
        in_unet = {name: len(c) for name, c in calls.items()}
        vae_mod.vae_decode(tree(g.vae), meta((1, 4, 128, 128)))
    return {name: (c[:in_unet[name]], c[in_unet[name]:]) for name, c in calls.items()}


def test_every_sdxl_self_attention_takes_the_tensor_core_body():
    """70 self-attentions a forward at L ≥ 512, head dim 64 (10 heads at 4096
    tokens, 20 at 1024), and the VAE mid-block's one head of 512 over 16384
    tokens; cross-attention (Lk = 77) stays plain, as in the reference."""
    unet, vae = sdxl_1024_calls()["flash"]
    shapes = {}
    for q, lk, body in unet:
        assert body == "wgmma" and q[2] >= 512 and lk == q[2]
        shapes[q] = shapes.get(q, 0) + 1
    assert shapes == {(2, 10, 4096, 64): 10, (2, 20, 1024, 64): 60}
    assert vae == [((1, 1, 16384, 512), 16384, "wgmma")]

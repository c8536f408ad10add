"""Which body of the flash-attention kernel a call takes, and the wrapper's
argument checks that hold on any device (nothing here needs a card)."""

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

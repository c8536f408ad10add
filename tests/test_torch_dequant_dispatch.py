"""Which body of the dequant-matmul kernel a call takes, and the wrapper's
argument checks that hold on any device (nothing here needs a card)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from forge_tpu_torch.ops import quant  # noqa: E402
from forge_tpu_torch.ops.dequant_matmul import (BODY_CODES, WGMMA_MIN_M, dequant_body,  # noqa: E402
                                                dequant_matmul, dequant_matmul_plain)


@pytest.mark.parametrize("m,dtype,body", [
    (1, torch.bfloat16, "wgmma"),     # adaLN modulation: a 128-token tile, mostly masked
    (63, torch.bfloat16, "wgmma"),
    (64, torch.bfloat16, "wgmma"),
    (512, torch.bfloat16, "wgmma"),   # Flux text tokens
    (4608, torch.bfloat16, "wgmma"),  # Flux joint tokens
    (1, torch.float32, "simt"),
    (64, torch.float32, "simt"),
    (4608, torch.float32, "simt"),    # f32 never takes TF32 tensor cores
])
def test_dequant_body(m, dtype, body):
    assert dequant_body(m, dtype) == body


def test_every_bf16_call_takes_the_tensor_core_body():
    assert WGMMA_MIN_M == 1
    assert set(BODY_CODES) == {"simt", "wgmma"}
    assert set(dequant_matmul.launches_by_body) == set(BODY_CODES)


@pytest.mark.parametrize("body", [None, "simt", "wgmma"])
def test_cpu_call_runs_the_plain_version_and_counts_nothing(body):
    rng = np.random.default_rng(0)
    leaf = quant.quantize(torch.from_numpy(rng.standard_normal((40, 64), dtype=np.float32)), "nf4")
    x = torch.from_numpy(rng.standard_normal((70, 64), dtype=np.float32))
    total, by_body = dequant_matmul.launches, dict(dequant_matmul.launches_by_body)
    got = dequant_matmul(x, leaf, body=body)
    assert torch.equal(got, dequant_matmul_plain(x, leaf))
    assert dequant_matmul.launches == total and dequant_matmul.launches_by_body == by_body


@pytest.mark.parametrize("body", ["tensor", "SIMT", ""])
def test_unknown_body_is_refused(body):
    leaf = quant.quantize(torch.zeros((8, 32)), "q8_0")
    with pytest.raises(ValueError, match="body"):
        dequant_matmul(torch.zeros((2, 32)), leaf, body=body)

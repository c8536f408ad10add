"""The port's quantizers, dequant-matmul and GGUF reader against forge_tpu (CPU).

- quantizers: torch codes, scales and mins equal the numpy ones bit for bit;
- dequantize: equal to forge_tpu's at f32 (the same f32 products);
- dequant-matmul: the port's plain version against the TPU kernel bodies run
  by `linear_quantized(..., interpret=True)`, relative error ≤ 1e-5 of the
  output scale (both f32; the kernel sums tile by tile);
- the reference's `KeyError: 'codes'` on a [64, 3072] prepared leaf is not
  inherited: the port's leaf keeps the flat layout and runs;
- GGUF: a file written here reads back the same through both packages.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.ops import quant as jquant  # noqa: E402
from forge_tpu_torch.core.convert import quant_leaf  # noqa: E402
from forge_tpu_torch.ops import quant  # noqa: E402
from forge_tpu_torch.ops.dequant_matmul import (  # noqa: E402
    _check_leaf, dequant_matmul, dequant_matmul_plain, linear_quantized)

KINDS = ["q8_0", "nf4", "q4_0", "gq4", "gq8"]
ATOL_REL = 1e-5


def _weight(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(64, 128), (96, 160), (3, 64)])
def test_quantizer_codes_equal_numpy(kind, shape):
    w = _weight(shape, hash((kind, shape)) % 2**31)
    w[0, :32] = 0.0  # an all-zero block
    want = jquant.quantize(w, kind)
    got = quant.quantize(torch.from_numpy(w), kind)
    assert got.kind == kind and got.shape == tuple(shape)
    for name in ("codes", "scales", "mins"):
        if name not in want:
            assert getattr(got, name) is None
            continue
        a, b = _np(getattr(got, name)), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name


@pytest.mark.parametrize("kind", ["q8_0", "nf4", "q4_0"])
def test_quantizer_pads_partial_block(kind):
    w = _weight((5, 7), 11)  # 35 values: a partial last block
    want = jquant.quantize(w, kind)
    got = quant.quantize(torch.from_numpy(w), kind)
    assert np.array_equal(_np(got.codes).view(np.uint8), np.asarray(want["codes"]).view(np.uint8))
    assert np.array_equal(_np(got.scales), np.asarray(want["scales"]))
    deq = quant.dequantize(got, torch.float32).numpy()
    assert np.array_equal(deq, np.asarray(jquant.dequantize(want, jnp.float32)))


@pytest.mark.parametrize("kind", KINDS)
def test_dequantize_equals_forge_tpu(kind):
    w = _weight((48, 256), 3)
    q = jquant.quantize(w, kind)
    want = np.asarray(jquant.dequantize(q, jnp.float32))
    got = quant.dequantize(quant_leaf(q), torch.float32).numpy()
    assert np.array_equal(got, want)
    bf = quant.dequantize(quant_leaf(q), torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and np.array_equal(bf.float().numpy(),
                                                         np.asarray(jnp.asarray(want, jnp.bfloat16),
                                                                    np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("out_dim", [256, 640])
def test_plain_dequant_matmul_vs_tpu_kernel_interpret(kind, out_dim):
    from forge_tpu.ops.dequant_matmul import linear_quantized as jlinear, prepare_for_kernel

    rng = np.random.default_rng(hash((kind, out_dim)) % 2**31)
    w = (rng.standard_normal((out_dim, 512)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    q = jquant.quantize(w, kind)
    want = np.asarray(jlinear(jnp.asarray(x), prepare_for_kernel(q), interpret=True))
    got = dequant_matmul(torch.from_numpy(x), quant_leaf(q)).numpy()
    assert got.shape == want.shape == (4, out_dim)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= ATOL_REL, err


def test_final_layer_leaf_runs_where_the_reference_raised():
    """Flux `final_layer.linear` is [64, 3072]: out % 128 != 0 sends the
    reference to its dequantize fallback, which reads the flat `codes` that
    `leaf_to_device` dropped from a prepared leaf (BENCH_r05 KeyError)."""
    from forge_tpu.ops.dequant_matmul import linear_quantized as jlinear, prepare_for_kernel

    w = _weight((64, 3072), 5, scale=0.02)
    x = np.random.default_rng(6).standard_normal((2, 3072)).astype(np.float32)
    q = jquant.quantize(w, "nf4")
    with pytest.raises(KeyError, match="codes"):
        jlinear(jnp.asarray(x), jquant.leaf_to_device(prepare_for_kernel(q)))
    leaf = quant.quantize(torch.from_numpy(w), "nf4")
    got = linear_quantized(torch.from_numpy(x), leaf).numpy()
    want = x @ np.asarray(jquant.dequantize(q, jnp.float32)).T
    assert got.shape == (2, 64)
    assert np.abs(got - want).max() <= ATOL_REL * max(np.abs(want).max(), 1.0)


def test_linear_with_bias_and_online_lora_matches_forge_tpu():
    from forge_tpu.ops import nn as jnn
    from forge_tpu_torch.ops import nn as tnn

    rng = np.random.default_rng(7)
    q = jquant.quantize(_weight((96, 128), 8), "q4_0")
    q["lora_down"] = rng.standard_normal((4, 128)).astype(np.float32) * 0.1
    q["lora_up"] = rng.standard_normal((96, 4)).astype(np.float32) * 0.1
    bias = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    want = np.asarray(jnn.linear(jnp.asarray(x), {"weight": q, "bias": jnp.asarray(bias)}))
    leaf = quant_leaf(q)
    leaf.lora_down = torch.from_numpy(q["lora_down"])
    leaf.lora_up = torch.from_numpy(q["lora_up"])
    got = tnn.linear(torch.from_numpy(x), {"weight": leaf, "bias": torch.from_numpy(bias)}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_leaf_checks_refuse_what_the_kernel_cannot_take():
    leaf = quant.quantize(torch.from_numpy(_weight((32, 96), 9)), "q4_0")
    _check_leaf(leaf, 96, torch.device("cpu"))
    with pytest.raises(ValueError, match="columns"):
        _check_leaf(leaf, 64, torch.device("cpu"))
    bad = quant.QuantLeaf("q4_0", (32, 96), leaf.codes, leaf.scales.float())
    with pytest.raises(ValueError, match="scales"):
        _check_leaf(bad, 96, torch.device("cpu"))
    odd = quant.quantize(torch.from_numpy(_weight((4, 48), 9)), "q8_0")  # 48 % 32 != 0
    with pytest.raises(ValueError, match="block"):
        _check_leaf(odd, 48, torch.device("cpu"))


def test_prepared_tpu_leaf_is_refused_by_convert():
    from forge_tpu.ops.dequant_matmul import prepare_for_kernel

    q = jquant.quantize(_weight((128, 512), 10), "nf4")
    moved = quant_leaf(jquant.leaf_to_device(q))  # flat layout: converts
    assert torch.equal(moved.codes, torch.from_numpy(np.asarray(q["codes"])))
    with pytest.raises(ValueError, match="flat layout"):
        quant_leaf(jquant.leaf_to_device(prepare_for_kernel(q)))


# -- GGUF ------------------------------------------------------------------


def _write_str(f, s):
    b = s.encode()
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _gguf_payload(arr, ttype):
    if ttype == 0:
        return arr.astype(np.float32).tobytes()
    if ttype == 8:  # Q8_0: f16 scale + 32 int8
        q = jquant.quantize_q8_0(arr)
        codes = q["codes"].reshape(-1, 32)
        return b"".join(q["scales"][i].tobytes() + codes[i].tobytes()
                        for i in range(len(q["scales"])))
    if ttype == 2:  # Q4_0: f16 scale + 16 bytes (lo = j, hi = j + 16)
        q = jquant.quantize_q4_0(arr)
        codes = q["codes"].reshape(-1, 16)
        return b"".join(q["scales"][i].tobytes() + codes[i].tobytes()
                        for i in range(len(q["scales"])))
    if ttype == 3:  # Q4_1: f16 d, f16 m, 16 bytes
        g = arr.reshape(-1, 32)
        lo, hi = g.min(1), g.max(1)
        d = np.where(hi > lo, (hi - lo) / 15.0, 1.0).astype(np.float16)
        c = np.clip(np.round((g - lo[:, None]) / d.astype(np.float32)[:, None]), 0, 15).astype(np.uint8)
        packed = c[:, :16] | (c[:, 16:] << 4)
        return b"".join(d[i].tobytes() + lo[i].astype(np.float16).tobytes() + packed[i].tobytes()
                        for i in range(len(g)))
    raise ValueError(ttype)


def _make_gguf(path, tensors):
    align, offset, blobs, infos = 32, 0, [], []
    for name, arr, ttype in tensors:
        raw = _gguf_payload(arr, ttype)
        infos.append((name, arr.shape, ttype, offset))
        pad = (-len(raw)) % align
        blobs.append(raw + b"\0" * pad)
        offset += len(raw) + pad
    with open(path, "wb") as f:
        f.write(b"GGUF")
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<QQ", len(infos), 1))
        _write_str(f, "general.alignment")
        f.write(struct.pack("<I", 4))
        f.write(struct.pack("<I", align))
        for name, shape, ttype, off in infos:
            _write_str(f, name)
            dims = tuple(reversed(shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", ttype, off))
        f.write(b"\0" * ((-f.tell()) % align))
        for blob in blobs:
            f.write(blob)


def test_gguf_roundtrip_matches_forge_tpu(tmp_path):
    from forge_tpu.core.gguf import load_gguf as jload
    from forge_tpu_torch.core.state_dict import load_state_dict

    tensors = [("plain.weight", _weight((8, 64), 0), 0), ("q8.weight", _weight((16, 64), 1), 8),
               ("q4.weight", _weight((16, 64), 2), 2), ("q41.weight", _weight((16, 64), 3), 3)]
    path = str(tmp_path / "tiny.gguf")
    _make_gguf(path, tensors)
    want = jload(path)
    got = load_state_dict(path)
    assert "__metadata__" not in got and set(got) == set(want) - {"__metadata__"}
    assert np.array_equal(got["plain.weight"], tensors[0][1])
    x = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32)
    for name, kind in (("q8.weight", "q8_0"), ("q4.weight", "q4_0"), ("q41.weight", "gq4")):
        leaf = quant_leaf(got[name])
        assert leaf.kind == kind and leaf.shape == (16, 64)
        deq = np.asarray(jquant.dequantize(want[name], jnp.float32))
        assert np.array_equal(quant.dequantize(leaf, torch.float32).numpy(), deq)
        y = linear_quantized(torch.from_numpy(x), leaf).numpy()
        np.testing.assert_allclose(y, x @ deq.T, atol=1e-5, rtol=1e-5)
        orig = dict((n, a) for n, a, _ in tensors)[name]
        assert np.sqrt(np.mean((deq - orig) ** 2)) / orig.std() < 0.15


def test_gguf_checkpoint_loads_as_quant_leaves(tmp_path):
    from forge_tpu_torch.core.loader import to_device_tree
    from forge_tpu_torch.core.state_dict import load_state_dict

    path = str(tmp_path / "unet.gguf")
    _make_gguf(path, [("img_in.weight", _weight((32, 64), 5), 8),
                      ("img_in.bias", _weight((32,), 6), 0)])
    tree = to_device_tree(load_state_dict(path), torch.float32, "cpu")
    assert isinstance(tree["img_in"]["weight"], quant.QuantLeaf)
    assert tree["img_in"]["bias"].dtype == torch.float32
    assert dequant_matmul_plain(torch.ones(1, 64), tree["img_in"]["weight"]).shape == (1, 32)

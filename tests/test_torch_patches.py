"""The port's LoRA / LyCORIS patches against forge_tpu (CPU, f32).

Mirrors tests/test_patches.py on the port: key matching against the tiny
SDXL's UNet and both text towers (te1 → CLIP-L, te2 → CLIP-G through
`convert_open_clip`'s names), the merge of every patch kind on linear and
conv weights against forge_tpu's `apply_patches` (1e-5 of the weight's
scale), strength 0, copy on write, the fused convs' channels_last layout
kept through a merge, and online LoRA on a quantized leaf against the
offline merge.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from forge_tpu.core.patches import apply_patches as japply, match_lora as jmatch  # noqa: E402
from forge_tpu.core.tree import flatten as jflatten, get_path as jget, nest as jnest  # noqa: E402
from forge_tpu_torch.core.convert import flatten, nest  # noqa: E402
from forge_tpu_torch.core.patches import apply_patches, match_lora  # noqa: E402

LIN = "input_blocks.3.1.transformer_blocks.0.attn1.to_q"  # [64, 64]
CONV = "input_blocks.1.0.in_layers.2"                     # [32, 32, 3, 3]


def _get(tree, key):
    for part in key.split("."):
        tree = tree[part]
    return tree


def _sdxl_lora(r, rank=2):
    """Keys on the tiny SDXL: UNet attention, a LoCon conv, both text towers
    (te1 and te2), a bare dotted key, and one that matches nothing."""
    sd = {}

    def lora(base, o, i, kh=None):
        shape_down = (rank, i) if kh is None else (rank, i, kh, kh)
        shape_up = (o, rank) if kh is None else (o, rank, 1, 1)
        sd[base + ".lora_up.weight"] = r.standard_normal(shape_up).astype(np.float32)
        sd[base + ".lora_down.weight"] = r.standard_normal(shape_down).astype(np.float32)
        sd[base + ".alpha"] = np.asarray(rank / 2, np.float32)

    lora("lora_unet_" + LIN.replace(".", "_"), 64, 64)
    lora("lora_unet_output_blocks_0_1_transformer_blocks_0_attn2_to_k", 64, 128)
    lora("lora_unet_" + CONV.replace(".", "_"), 32, 32, kh=3)
    lora("lora_te1_text_model_encoder_layers_0_self_attn_q_proj", 64, 64)
    lora("lora_te2_text_model_encoder_layers_1_mlp_fc1", 256, 64)
    lora("lora_te_text_model_encoder_layers_1_self_attn_out_proj", 64, 64)
    sd["diffusion_model.input_blocks.3.1.proj_in.diff"] = r.standard_normal((64, 64)).astype(
        np.float32)
    lora("lora_unet_no_such_block_to_q", 8, 8)
    return sd


@pytest.fixture(scope="module")
def engines():
    from test_torch_sdxl import _jax_engine, _port_engine, _tiny_sdxl_checkpoint

    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


def test_match_lora_agrees_key_for_key(engines):
    jeng, teng = engines
    lora = _sdxl_lora(np.random.default_rng(0))
    jte = {n: jflatten(e.params).keys() for n, e in jeng.text_engines.items()}
    tte = {n: flatten(e.params).keys() for n, e in teng.text_engines.items()}
    want, want_un = jmatch(lora, jflatten(jeng.loaded.unet).keys(), te_keys_by_name=jte)
    got, got_un = match_lora(lora, flatten(teng.loaded.unet).keys(), te_keys_by_name=tte)
    assert sorted(got_un) == sorted(want_un) == ["lora_unet_no_such_block_to_q"]
    assert set(got) == set(want) == {"unet", "te:clip_l", "te:clip_g"}
    for group in want:
        assert sorted(got[group]) == sorted(want[group]), group
        for key, patch in want[group].items():
            assert got[group][key].kind == patch.kind and got[group][key].alpha == patch.alpha
    assert set(got["unet"]) == {LIN + ".weight", CONV + ".weight", "input_blocks.3.1.proj_in.weight",
                                "output_blocks.0.1.transformer_blocks.0.attn2.to_k.weight"}
    assert set(got["te:clip_g"]) == {"text_model.encoder.layers.1.mlp.fc1.weight"}
    assert set(got["te:clip_l"]) == {"text_model.encoder.layers.0.self_attn.q_proj.weight",
                                     "text_model.encoder.layers.1.self_attn.out_proj.weight"}


def _kind_tensors(kind, r, o, i, kh):
    """Patch tensors of `kind` for a weight [o, i] (kh None) or [o, i, kh, kh]."""
    flat_in = i if kh is None else i * kh * kh
    rank = 2
    if kind in ("lora", "dora"):
        t = {"lora_up.weight": r.standard_normal((o, rank) if kh is None else (o, rank, 1, 1)),
             "lora_down.weight": r.standard_normal((rank, i) if kh is None else (rank, i, kh, kh)),
             "alpha": np.asarray(1.0)}
        if kind == "dora":
            t["dora_scale"] = r.uniform(0.5, 1.5, size=(o, 1))
    elif kind == "loha":
        t = {"hada_w1_a": r.standard_normal((o, rank)), "hada_w1_b": r.standard_normal((rank, flat_in)),
             "hada_w2_a": r.standard_normal((o, rank)), "hada_w2_b": r.standard_normal((rank, flat_in)),
             "alpha": np.asarray(3.0)}
    elif kind == "lokr":
        t = {"lokr_w1": r.standard_normal((2, 4)),
             "lokr_w2_a": r.standard_normal((o // 2, rank)),
             "lokr_w2_b": r.standard_normal((rank, flat_in // 4)), "alpha": np.asarray(1.0)}
    elif kind == "glora":
        t = {"a1.weight": r.standard_normal((flat_in, rank)), "a2.weight": r.standard_normal((rank, flat_in)),
             "b1.weight": r.standard_normal((o, rank)), "b2.weight": r.standard_normal((rank, flat_in)),
             "alpha": np.asarray(rank)}
    else:  # diff
        t = {"diff": r.standard_normal((o, i) if kh is None else (o, i, kh, kh))}
    return {k: (0.1 * np.asarray(v)).astype(np.float32) if k != "alpha" else
            np.asarray(v, np.float32) for k, v in t.items()}


KINDS = ["lora", "dora", "loha", "lokr", "glora", "diff"]


@pytest.mark.parametrize("layer", ["linear", "conv"])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_patches_matches(kind, layer):
    """Two sets on one weight (strengths 0.8 and −0.3), the second a plain
    LoRA on top: forge_tpu merges HWIO conv kernels, the port OIHW ones."""
    r = np.random.default_rng(KINDS.index(kind) + (10 if layer == "conv" else 0))
    o, i, kh = (16, 24, None) if layer == "linear" else (16, 8, 3)
    shape = (o, i) if kh is None else (o, i, kh, kh)
    w = r.standard_normal(shape).astype(np.float32)
    key = "blk.proj.weight"
    sd1 = {"lora_unet_blk_proj." + k: v for k, v in _kind_tensors(kind, r, o, i, kh).items()}
    sd2 = {"lora_unet_blk_proj." + k: v for k, v in _kind_tensors("lora", r, o, i, kh).items()}
    jw = w if kh is None else w.transpose(2, 3, 1, 0)
    jparams = jnest({key: jnp.asarray(jw)})
    tparams = nest({key: torch.from_numpy(w)})
    jsets = [(jmatch(sd, [key])[0]["unet"], s) for sd, s in ((sd1, 0.8), (sd2, -0.3))]
    tsets = [(match_lora(sd, [key])[0]["unet"], s) for sd, s in ((sd1, 0.8), (sd2, -0.3))]
    want = np.asarray(jget(japply(jparams, jsets), key))
    if kh is not None:
        want = want.transpose(3, 2, 0, 1)
    got = _get(apply_patches(tparams, tsets), key).numpy()
    assert np.abs(want - w).max() > 1e-3  # the patch took part
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_strength_zero_and_copy_on_write():
    r = np.random.default_rng(1)
    w = torch.from_numpy(r.standard_normal((8, 8)).astype(np.float32))
    w0, other = w.clone(), torch.zeros(3)
    params = nest({"blk.to_q.weight": w, "blk.norm.bias": other})
    sd = {"lora_unet_blk_to_q." + k: v for k, v in _kind_tensors("lora", r, 8, 8, None).items()}
    matched, _ = match_lora(sd, flatten(params).keys())
    same = apply_patches(params, [(matched["unet"], 0.0)])
    assert _get(same, "blk.to_q.weight") is w and _get(same, "blk.norm.bias") is other
    out = apply_patches(params, [(matched["unet"], 1.0)])
    assert _get(out, "blk.norm.bias") is other  # untouched leaves are shared
    assert _get(params, "blk.to_q.weight") is w and out["blk"] is not params["blk"]
    assert not torch.equal(_get(out, "blk.to_q.weight"), w)
    assert torch.equal(w, w0)  # the engine's weight is as it was


def test_conv_merge_keeps_channels_last():
    """The loader stores the fused convs' weights channels_last on the card
    (the tensor-core body reads [O,3,3,C]); a LoCon merge must keep that
    layout, or every later call would copy the weight."""
    r = np.random.default_rng(2)
    w = torch.from_numpy(r.standard_normal((16, 8, 3, 3)).astype(np.float32)).to(torch.bfloat16)
    w = w.contiguous(memory_format=torch.channels_last)
    assert not w.is_contiguous()
    params = nest({CONV + ".weight": w})
    sd = {"lora_unet_" + CONV.replace(".", "_") + "." + k: v
          for k, v in _kind_tensors("lora", r, 16, 8, 3).items()}
    matched, _ = match_lora(sd, flatten(params).keys())
    merged = _get(apply_patches(params, [(matched["unet"], 1.0)]), CONV + ".weight")
    assert merged.dtype == torch.bfloat16 and merged.shape == w.shape
    assert merged.is_contiguous(memory_format=torch.channels_last) and not merged.is_contiguous()
    up = sd[next(k for k in sd if k.endswith("lora_up.weight"))].reshape(16, -1)
    down = sd[next(k for k in sd if k.endswith("lora_down.weight"))].reshape(2, -1)
    want = w.float() + torch.from_numpy((up @ down * 0.5).reshape(16, 8, 3, 3))
    assert (merged.float() - want).abs().max() <= 2 ** -7 * want.abs().max()


def test_online_lora_on_quantized_leaf_matches_offline():
    """A quantized leaf keeps its codes; the LoRA rides the matmul's epilogue
    in bf16 and matches dequantize → merge → matmul within 2e-2."""
    from forge_tpu_torch.ops import quant
    from forge_tpu_torch.ops.dequant_matmul import linear_quantized

    r = np.random.default_rng(4)
    w = torch.from_numpy((r.standard_normal((128, 512)) * 0.2).astype(np.float32))
    q = quant.quantize(w, "nf4")
    params = nest({"blk.to_q.weight": q})
    up = (r.standard_normal((128, 4)) * 0.1).astype(np.float32)
    down = (r.standard_normal((4, 512)) * 0.1).astype(np.float32)
    dora = {"lora_up.weight": up, "lora_down.weight": down, "alpha": np.asarray(4.0, np.float32),
            "dora_scale": r.uniform(0.5, 1.5, size=(128, 1)).astype(np.float32)}
    sd = {"lora_unet_blk_to_q.lora_up.weight": up, "lora_unet_blk_to_q.lora_down.weight": down,
          "lora_unet_blk_to_q.alpha": np.asarray(4.0, np.float32)}
    matched, unmatched = match_lora(sd, flatten(params).keys())
    assert not unmatched
    leaf = _get(apply_patches(params, [(matched["unet"], 0.8)]), "blk.to_q.weight")
    assert leaf.lora_down is not None and leaf.lora_up is not None and leaf.lora_dense is None
    assert leaf.codes is q.codes and q.lora_down is None  # codes shared, engine leaf as it was
    x = torch.from_numpy(r.standard_normal((3, 512)).astype(np.float32))
    merged = quant.dequantize(q, torch.float32) + 0.8 * torch.from_numpy(up @ down)
    want = x @ merged.T
    got = linear_quantized(x, leaf)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()

    # a DoRA patch becomes a dense delta, against the offline merge of forge_tpu's math
    matched, _ = match_lora({"lora_unet_blk_to_q." + k: v for k, v in dora.items()},
                            flatten(params).keys())
    dleaf = _get(apply_patches(params, [(matched["unet"], 0.8)]), "blk.to_q.weight")
    assert dleaf.lora_dense is not None and dleaf.lora_down is None
    wd = quant.dequantize(q, torch.float32)
    m = wd + 0.8 * torch.from_numpy(up @ down)
    m = m * (torch.from_numpy(dora["dora_scale"]).reshape(-1) / m.square().sum(1).add(1e-8).sqrt())[:, None]
    want = x @ m.T
    assert (linear_quantized(x, dleaf) - want).abs().max() <= 2e-2 * want.abs().max()

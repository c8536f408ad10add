"""The port's CodeFormer (forge_tpu_torch/models/codeformer.py) and GFPGAN
(postprocessing/gfpgan.py) against forge_tpu's (CPU, f32), and the
restorer the `face_restoration_model` option picks.

Tiny networks in the released files' key spaces
(tests/torch_restoration_cases.py). CodeFormer at w 0 and 0.5 on a 64²
input (a 16² latent, fuse blocks at 32 and 64): the codes the transformer
picks equal forge_tpu's and the output is within 1e-4 of its largest
value. GFPGAN within 1e-4 on forge_tpu's tree of the same file. A fault of
the reference shown from both sides: its `GFPGAN.load` transposes the 4-d
`constant_input` like a conv kernel, so its forward on a loaded file fails
to broadcast; the port's loads the file and runs. The whole-image restore
of each restorer at face size 512 (a 96×64 image: crop, resize to 512²,
restore, resize back, feather) is within one level of forge_tpu's (its
uint8 cast truncates values within 1e-5 of an integer either way). The
option dispatch gives GFPGAN or CodeFormer in both packages.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_restoration_cases import (nchw, nhwc, port_tree, reference_gfpgan_tree,  # noqa: E402
                                     reference_tree, rel_err, tiny_sd, write)

SMALL_CODEFORMER = dict(nf=8, ch_mult=(1, 2, 2), emb_dim=8, codebook=32, dim_embd=16, n_layers=2,
                        img_size=64, connect=(32, 64))


def reference_codes(params, x):
    """forge_tpu's CodeFormer up to the codebook lookup → the codes [B, L]."""
    from forge_tpu.models import codeformer as ref
    from forge_tpu.ops import nn

    lq = ref._walk_blocks(params["encoder"]["blocks"], x, upsample=False, taps={})
    b, hh, ww, c = lq.shape
    query = jnp.transpose(nn.linear(lq.reshape(b, hh * ww, c), params["feat_emb"]), (1, 0, 2))
    for i in range(len(params["ft_layers"])):
        query = ref._transformer_layer(params["ft_layers"][str(i)], query,
                                       params["position_emb"][:, None, :])
    logits = nn.linear(nn.layer_norm(query, params["idx_pred_layer"]["0"]),
                       params["idx_pred_layer"]["1"])
    return np.asarray(jnp.argmax(logits, axis=-1)).T


@pytest.mark.parametrize("w", [0.0, 0.5])
def test_codeformer_matches_reference(w):
    from forge_tpu.models.codeformer import codeformer_apply as japply
    from forge_tpu_torch.models.codeformer import codeformer_apply, load_codeformer

    sd = tiny_sd("codeformer", seed=1, **SMALL_CODEFORMER)
    jparams, tparams = reference_tree(sd), port_tree(load_codeformer(sd))
    x = np.random.default_rng(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    codes = []
    got = nhwc(codeformer_apply(tparams, nchw(x), w=w, codes_out=codes))
    want = np.asarray(japply(jparams, jnp.asarray(x), w=w))
    assert np.array_equal(codes[0].numpy(), reference_codes(jparams, jnp.asarray(x)))
    assert len(np.unique(codes[0].numpy())) > 4
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert rel_err(got, want) < 1e-4


def test_codeformer_published_layout():
    """codeformer-v0.1.0's tree: 9 layers 512 wide, 1024 codes of 256, fuse
    blocks at 32–256, a 16² latent; the port's loader reads every key."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.synth import synth_codeformer_sd
    from forge_tpu_torch.models.codeformer import load_codeformer

    sd = synth_codeformer_sd(fill="zeros")
    tree = load_codeformer(dict(sd, **{"quantize.ema_count": np.zeros(1024, np.float32)}))
    assert len(flatten(tree)) == len(sd)
    assert sorted(tree["fuse_convs_dict"], key=int) == ["32", "64", "128", "256"]
    assert len(tree["ft_layers"]) == 9 and tree["position_emb"].shape == (256, 512)
    assert tree["quantize"]["embedding"]["weight"].shape == (1024, 256)


def test_gfpgan_matches_reference_and_load_fault(tmp_path):
    from forge_tpu.postprocessing import gfpgan as ref
    from forge_tpu_torch.postprocessing import gfpgan as port

    sd = tiny_sd("gfpgan", seed=3, out_size=32)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ref.gfpgan_apply(reference_gfpgan_tree(sd), jnp.asarray(x)))
    write(sd, str(tmp_path / "GFPGAN" / "GFPGANv1.4.safetensors"))
    g = port.GFPGAN(model_dir=str(tmp_path / "GFPGAN"), device="cpu")
    assert g.available
    got = nhwc(port.gfpgan_apply(g.load(), nchw(x)))
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert rel_err(got, want) < 1e-4 and got.std() > 0.1
    jg = ref.GFPGAN(model_dir=str(tmp_path / "GFPGAN"))
    jg.load()
    with pytest.raises(ValueError, match="broadcast"):
        ref.gfpgan_apply(jg.params, jnp.asarray(x))


@pytest.fixture(scope="module")
def restorers(tmp_path_factory):
    """(the port's CodeFormer and GFPGAN restorers over tiny files at face
    size 512, forge_tpu's over the same weights)."""
    from forge_tpu.postprocessing.faces import FaceRestorer as JFaceRestorer
    import jax

    from forge_tpu.postprocessing.gfpgan import GFPGAN as JGFPGAN
    from forge_tpu.postprocessing.gfpgan import gfpgan_apply as jgfpgan_apply
    from forge_tpu_torch.postprocessing.faces import FaceRestorer
    from forge_tpu_torch.postprocessing.gfpgan import GFPGAN

    d = tmp_path_factory.mktemp("models")
    cf, gf = tiny_sd("codeformer", seed=5), tiny_sd("gfpgan", seed=6)
    write(cf, str(d / "Codeformer" / "codeformer-v0.1.0.safetensors"))
    write(gf, str(d / "GFPGAN" / "GFPGANv1.4.safetensors"))
    jgf = JGFPGAN(model_dir=str(d / "GFPGAN"))
    jgf.params = reference_gfpgan_tree(gf)  # its load transposes constant_input
    jgf._jit = jax.jit(lambda t: jgfpgan_apply(jgf.params, t))
    return {"CodeFormer": (FaceRestorer(model_dir=str(d / "Codeformer"), device="cpu"),
                           JFaceRestorer(params=reference_tree(cf))),
            "GFPGAN": (GFPGAN(model_dir=str(d / "GFPGAN"), device="cpu"), jgf)}


@pytest.mark.parametrize("name,w", [("CodeFormer", 0.5), ("CodeFormer", 0.0), ("GFPGAN", 0.5)])
def test_restore_matches_reference(restorers, name, w):
    port, ref = restorers[name]
    img = np.random.default_rng(7).integers(0, 256, (96, 64, 3), dtype=np.uint8)
    want, got = ref.restore(img, w), port.restore(img, w)
    assert got.shape == want.shape == img.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())
    assert np.abs(got.astype(np.int16) - img).mean() > 5  # the face was restored


def test_option_dispatch_matches_reference(monkeypatch):
    from forge_tpu.postprocessing import faces as jfaces
    from forge_tpu.postprocessing import gfpgan as jgfpgan
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.postprocessing import faces
    from forge_tpu_torch.postprocessing import gfpgan
    from forge_tpu_torch.runtime.options import opts

    for mod in (faces, jfaces):
        monkeypatch.setattr(mod, "_restorer", None)
    for mod in (gfpgan, jgfpgan):
        monkeypatch.setattr(mod, "_MODEL", None)
    assert opts.get("face_restoration_model") == jopts.get("face_restoration_model") == "CodeFormer"
    for model, port_cls, ref_cls in (("GFPGAN", gfpgan.GFPGAN, jgfpgan.GFPGAN),
                                     ("gfpgan", gfpgan.GFPGAN, jgfpgan.GFPGAN),
                                     ("CodeFormer", faces.FaceRestorer, jfaces.FaceRestorer)):
        with opts.override({"face_restoration_model": model}), \
                jopts.override({"face_restoration_model": model}):
            assert type(faces.get_face_restorer("cpu")) is port_cls
            assert type(jfaces.get_face_restorer()) is ref_cls
    assert faces.get_face_restorer() is faces.get_face_restorer()
    assert faces.get_face_restorer().name == "CodeFormer"
    assert not faces.FaceRestorer(model_dir="no/such/dir").available

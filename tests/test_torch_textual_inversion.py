"""The port's textual inversion against forge_tpu (CPU, f32).

Files in the four formats (webui `string_to_param` .pt, SDXL dual
{clip_l, clip_g}, `emb_params`, a single tensor) are written under
tmp_path and read by both packages' `EmbeddingDatabase.load_dir`; `find`
agrees at every offset of a prompt, for both slots, the longest trigger
first. forge_tpu's torch reader keeps no nested dict, so a webui `.pt`
registers nothing there (a fault on its side, shown from both sides).

The splice: a prompt with a trigger word encoded by the tiny SD1.5's
CLIP-L and the tiny SDXL's CLIP-L and CLIP-G (tests/test_sdxl.py's layout)
through both packages: the spliced input embeddings bit-equal, the hidden
states the conditioning takes within 1e-5 of the largest value (f32), the
pooled output within 1e-4, the bound tests/test_torch_sdxl.py holds the
towers to (without an embedding they already differ by up to 2.5e-5 there:
summation order). forge_tpu's
splice writes into `np.asarray` of a float32 JAX array, a read-only view,
and raises on f32 weights (shown); it is held here with that one line
made a copy (`writable_reference_splice`). An embedding whose width is not
the tower's raises ValueError in the port, naming it and both widths;
forge_tpu truncates a wider one silently and fails in numpy on a narrower
one, as on SDXL's CLIP-G for an embedding with no `clip_g` vectors (its
`find` falls back to the CLIP-L ones). `create_embedding` writes the same
file from both packages.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402

PROMPT = ["a photo of forgeemb in the snow, forgeemb again"]


def writable_reference_splice(monkeypatch, record=None):
    """forge_tpu's `ClassicTextEngine._encode` with its one faulty line made
    a copy (`np.array` for `np.asarray`): the rest as it is, unjitted. The
    spliced input embeddings go to `record` where one is given."""
    from forge_tpu.text import engine as jte

    original = jte.ClassicTextEngine._encode

    def encode(self, flat_tokens, flat_mults, fixes, shape):
        if not fixes:
            return original(self, flat_tokens, flat_mults, fixes, shape)
        b, n, seq = shape
        table = self.params["text_model"]["embeddings"]["token_embedding"]["weight"]
        ie = np.array(jnp.take(table, flat_tokens, axis=0), dtype=np.float32).reshape(b, n, seq, -1)
        for (bb, ci, off, vec) in fixes:
            k = min(vec.shape[0], seq - off)
            ie[bb, ci, off:off + k] = vec[:k, :ie.shape[-1]]
        if record is not None:
            record.append(ie.reshape(b * n, seq, -1))
        return self._encode_core(self.params, flat_tokens, flat_mults,
                                 jnp.asarray(ie.reshape(b * n, seq, -1)))

    monkeypatch.setattr(jte.ClassicTextEngine, "_encode", encode)


def _write_formats(d, width=CLIP_WIDTH):
    from forge_tpu_torch.core.save import save_safetensors

    rng = np.random.default_rng(3)

    def vec(n, w=width):
        return rng.standard_normal((n, w)).astype(np.float32)

    save_safetensors({"clip_l": vec(2), "clip_g": vec(3, 96)},
                     os.path.join(d, "dualemb.safetensors"))
    save_safetensors({"clip_g": vec(2, 96)}, os.path.join(d, "gonly.safetensors"))
    save_safetensors({"emb_params": vec(3)}, os.path.join(d, "paramemb.safetensors"))
    save_safetensors({"anything": vec(1)[0]}, os.path.join(d, "single.safetensors"))
    torch.save({"string_to_param": {"*": torch.from_numpy(vec(4))}, "string_to_token": {"*": 265},
                "name": "webui", "step": 100}, os.path.join(d, "webui.pt"))
    torch.save({"emb": torch.from_numpy(vec(2))}, os.path.join(d, "ptsingle.pt"))
    with open(os.path.join(d, "broken.safetensors"), "wb") as f:
        f.write(b"not a safetensors file")
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("ignored")


def test_load_dir_and_find_match_forge_tpu(tmp_path):
    from forge_tpu.text.textual_inversion import EmbeddingDatabase as JDb
    from forge_tpu.text.tokenizer import default_tokenizer as jtok
    from forge_tpu_torch.text.textual_inversion import EmbeddingDatabase as TDb
    from forge_tpu_torch.text.tokenizer import default_tokenizer as ttok

    _write_formats(str(tmp_path))
    jdb, tdb = JDb(jtok()), TDb(ttok())
    jdb.load_dir(str(tmp_path))
    tdb.load_dir(str(tmp_path))
    common = {"dualemb", "gonly", "paramemb", "single", "ptsingle"}
    assert set(jdb.embeddings) == common  # forge_tpu drops the webui .pt
    assert set(tdb.embeddings) == common | {"webui"}
    assert tdb.embeddings["webui"].vectors.shape == (4, CLIP_WIDTH)
    for name in common:
        je, te = jdb.embeddings[name], tdb.embeddings[name]
        assert np.array_equal(je.vectors, te.vectors), name
        assert (je.vectors_g is None) == (te.vectors_g is None)
        if te.vectors_g is not None:
            assert np.array_equal(je.vectors_g, te.vectors_g)
    assert tdb.embeddings["single"].vectors.shape == (1, CLIP_WIDTH)
    assert tdb.version == 6 and jdb.version == 5

    for db in (jdb, tdb):  # the longest trigger first
        db.register("snow", np.ones((1, 8), np.float32))
        db.register("snow owl", np.full((2, 8), 2.0, np.float32))
    text = "webui dualemb on a snow owl, gonly paramemb single ptsingle snow"
    tokens = list(ttok().ids(text))
    assert tokens == list(jtok().ids(text))
    for off in range(len(tokens)):
        for which in ("l", "g"):
            want, got = jdb.find(tokens, off, which), tdb.find(tokens, off, which)
            if got is not None and tdb.match(tokens, off)[0].name == "webui":
                assert want is None and got[1] == len(ttok().ids("webui"))
                continue
            assert (want is None) == (got is None), (off, which)
            if got is not None:
                assert got[1] == want[1] and np.array_equal(got[0], want[0]), (off, which)
    owl = tokens.index(list(ttok().ids("snow"))[0])
    assert tdb.find(tokens, owl)[1] == 2 and tdb.find(tokens, owl)[0].shape == (2, 8)


def _sd15_engines():
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=4)
    return make_tiny_engine(0), teng


@pytest.fixture(scope="module")
def sd15():
    return _sd15_engines()


@pytest.fixture(scope="module")
def sdxl():
    from test_torch_sdxl import _jax_engine, _port_engine, _tiny_sdxl_checkpoint

    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_reference_splice_fails_on_f32_weights(sd15):
    """forge_tpu writes the vectors into a read-only view and raises."""
    jeng, _ = sd15
    jeng.embedding_db.register("forgeemb", np.ones((2, CLIP_WIDTH), np.float32))
    try:
        with pytest.raises(ValueError, match="read-only"):
            jeng.text_engines["clip_l"](PROMPT)
    finally:
        jeng.embedding_db.embeddings.clear()
        jeng.embedding_db.by_first_id.clear()


@pytest.mark.parametrize("tower", ["sd15 clip_l", "sdxl clip_l", "sdxl clip_g"])
def test_splice_matches_forge_tpu(sd15, sdxl, tower, monkeypatch):
    from forge_tpu_torch.text import engine as tte

    jembeds, tembeds = [], []
    writable_reference_splice(monkeypatch, jembeds)
    real_apply = tte.clip_text_apply

    def apply(*args, input_embeds=None, **kwargs):
        tembeds.append(input_embeds)
        return real_apply(*args, input_embeds=input_embeds, **kwargs)

    monkeypatch.setattr(tte, "clip_text_apply", apply)
    family, name = tower.split()
    jeng, teng = sd15 if family == "sd15" else sdxl
    rng = np.random.default_rng(11)  # vectors at the token table's scale
    vec_l = (rng.standard_normal((2, CLIP_WIDTH)) * 0.02).astype(np.float32)
    vec_g = (rng.standard_normal((3, CLIP_WIDTH)) * 0.02).astype(np.float32)
    for db in (jeng.embedding_db, teng.embedding_db):
        db.embeddings.clear()
        db.by_first_id.clear()
        db.register("forgeemb", vec_l, vec_g if family == "sdxl" else None)
    jz, jpooled = jeng.text_engines[name](PROMPT)
    tz, tpooled = teng.text_engines[name](PROMPT)
    assert len(jembeds) == len(tembeds) == 1
    assert np.array_equal(tembeds[0].numpy(), jembeds[0])
    _close(tz.numpy(), jz)
    _close(tpooled.numpy(), jpooled, 1e-4)
    assert teng.text_engines[name].tokenize_batch(PROMPT)[0][0][0].fixes[0][1].shape[0] == (
        3 if name == "clip_g" else 2)
    plain, _ = teng.text_engines[name](["a photo of forgeemb in the snow, forgeemb again"
                                        .replace("forgeemb", "x")])
    assert not torch.equal(plain, tz)
    if family == "sdxl":  # the whole conditioning: context and y
        jc = jeng.get_learned_conditioning(PROMPT, 64, 64)
        tc = teng.get_learned_conditioning(PROMPT, 64, 64)
        _close(tc["context"].numpy(), jc["context"])
        _close(tc["y"].numpy(), jc["y"], 1e-4)  # the pooled output's part


def test_width_mismatch_raises_in_the_port(sd15, sdxl, monkeypatch):
    """A narrower vector: forge_tpu fails in numpy, the port names it; a
    wider one: forge_tpu truncates it, the port names it; SDXL's CLIP-G
    with no `clip_g` vectors: both fall back to the CLIP-L ones, of another
    width at full size (768 against 1280), here 32 against 64."""
    writable_reference_splice(monkeypatch)
    jeng, teng = sd15
    rng = np.random.default_rng(5)
    narrow = rng.standard_normal((2, CLIP_WIDTH // 2)).astype(np.float32)
    wide = rng.standard_normal((2, CLIP_WIDTH + 32)).astype(np.float32)
    for vec in (narrow, wide):
        for db in (jeng.embedding_db, teng.embedding_db):
            db.embeddings.clear()
            db.by_first_id.clear()
            db.register("forgeemb", vec)
        with pytest.raises(ValueError, match=rf"'forgeemb' has {vec.shape[1]}-wide vectors for "
                                             rf"slot 'l'; this text encoder is {CLIP_WIDTH} wide"):
            teng.text_engines["clip_l"](PROMPT)
        if vec is narrow:
            with pytest.raises(ValueError, match="could not broadcast"):
                jeng.text_engines["clip_l"](PROMPT)
        else:  # the reference keeps the first 64 columns
            got = np.asarray(jeng.text_engines["clip_l"](PROMPT)[0])
            for db in (jeng.embedding_db, teng.embedding_db):
                db.embeddings.clear()
                db.by_first_id.clear()
                db.register("forgeemb", vec[:, :CLIP_WIDTH])
            _close(teng.text_engines["clip_l"](PROMPT)[0].numpy(), got)

    jx, tx = sdxl
    for db in (jx.embedding_db, tx.embedding_db):
        db.embeddings.clear()
        db.by_first_id.clear()
        db.register("forgeemb", narrow)  # no clip_g vectors
    assert tx.embedding_db.find(list(tx.text_engines["clip_g"].tokenizer.ids("forgeemb")), 0,
                                "g")[0] is tx.embedding_db.embeddings["forgeemb"].vectors
    with pytest.raises(ValueError, match=r"'forgeemb' has 32-wide vectors for slot 'g'"):
        tx.text_engines["clip_g"](PROMPT)
    with pytest.raises(ValueError, match="could not broadcast"):
        jx.text_engines["clip_g"](PROMPT)


def test_create_embedding_matches_forge_tpu(sd15, tmp_path):
    from forge_tpu.text.textual_inversion import create_embedding as jcreate
    from forge_tpu_torch.core.state_dict import load_safetensors
    from forge_tpu_torch.text.textual_inversion import create_embedding as tcreate

    jeng, teng = sd15
    for n, init in ((1, "*"), (3, "a red cat"), (5, "cat"), (2, "")):
        jpath = jcreate(jeng, "my emb", num_vectors=n, init_text=init, overwrite=True,
                        out_dir=str(tmp_path / "j"))
        tpath = tcreate(teng, "my emb", num_vectors=n, init_text=init, overwrite=True,
                        out_dir=str(tmp_path / "t"))
        assert os.path.basename(tpath) == os.path.basename(jpath) == "my emb.safetensors"
        with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
            assert fj.read() == ft.read()
        vec = load_safetensors(tpath)["emb_params"]
        assert vec.shape == (n, CLIP_WIDTH) and (init == "") == (not vec.any())
    with pytest.raises(FileExistsError):
        tcreate(teng, "my emb", out_dir=str(tmp_path / "t"))
    with pytest.raises(ValueError, match="no legal characters"):
        tcreate(teng, "???", out_dir=str(tmp_path / "t"))
    teng.embedding_db.load_dir(str(tmp_path / "t"))
    assert "my emb" in teng.embedding_db.embeddings

"""The port's BLIP captioner (forge_tpu_torch/models/blip.py) against
forge_tpu's on the CPU, f32, on a tiny network in the released key space
(tests/torch_interrogate_cases.py: ViT width 48 at 384², 577 tokens, two
blocks; BERT width 48, two layers; BERT's 30522 + 2 vocabulary).

`vit_encode` and `bert_decode_logits` (the causal and pad mask, the
cross-attention) agree within 1e-4 of the largest reference value; the
greedy ids of `blip_caption_ids` are equal, with [SEP] pulled early by the
prediction bias so that the PAD after it is held too; `WordPiece` encodes
and decodes as forge_tpu's on a seeded 30,522-line `vocab.txt`; the
captioner reads its checkpoint and vocabulary from a models directory and
gives forge_tpu's caption string (its 384² input through Pillow's BICUBIC,
`pipeline/images.py` `bicubic_resize`).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_interrogate_cases import (image, nchw, port_tree, reference_tree, rel_err,  # noqa: E402
                                     tiny_sd, write)

TOL = 1e-4
BOS, SEP = 30522, 102


@pytest.fixture(scope="module")
def blip():
    sd = tiny_sd("blip")
    return sd, reference_tree(sd), port_tree(sd)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    from forge_tpu_torch.core.synth_annotators import synth_wordpieces

    d = tmp_path_factory.mktemp("blip")
    path = d / "vocab.txt"
    path.write_text("\n".join(synth_wordpieces()) + "\n")
    return str(path)


def _pixels(seed):
    return np.random.default_rng(seed).standard_normal((1, 384, 384, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_vit_encode_matches_reference(blip, seed):
    from forge_tpu.models.blip import vit_encode as ref
    from forge_tpu_torch.models.blip import vit_encode

    _, rp, pp = blip
    x = _pixels(seed)
    want = np.asarray(ref(rp["visual_encoder"], jnp.asarray(x)))
    got = vit_encode(pp["visual_encoder"], nchw(x)).numpy()
    assert got.shape == want.shape == (1, 577, 48)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("tokens", [[[BOS, 104, 105, 106, 2000, 0, 0, 0]],
                                    [[BOS, 104, 105, 0, 0, 0, 0, 0], [BOS, 7, 9, 11, 13, 15, SEP, 0]]])
def test_bert_decode_logits_matches_reference(blip, tokens):
    from forge_tpu.models.blip import bert_decode_logits as ref
    from forge_tpu_torch.models.blip import bert_decode_logits

    _, rp, pp = blip
    toks = np.asarray(tokens, np.int32)
    visual = np.random.default_rng(3).standard_normal((len(tokens), 577, 48)).astype(np.float32)
    want = np.asarray(ref(rp["text_decoder"], jnp.asarray(toks), jnp.asarray(visual)))
    got = bert_decode_logits(pp["text_decoder"], torch.from_numpy(toks.astype(np.int64)),
                             torch.from_numpy(visual)).numpy()
    assert got.shape == want.shape == (len(tokens), 8, 30524)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("sep_bias", [0.0, 1.2])
def test_greedy_ids_match_reference(blip, sep_bias):
    """The same ids as the reference's scan; with [SEP] favoured it comes
    early and PAD follows it on both sides."""
    from forge_tpu.models.blip import blip_caption_ids as ref
    from forge_tpu_torch.models.blip import blip_caption_ids

    sd, _, _ = blip
    sd = dict(sd)
    bias = np.zeros(30524, np.float32)
    bias[SEP] = sep_bias * np.abs(sd["text_decoder.cls.predictions.decoder.weight"]).sum(1).max()
    sd["text_decoder.cls.predictions.bias"] = bias
    x = _pixels(4)
    prompt = np.asarray([BOS, 104, 105, 106], np.int32)
    want = ref(reference_tree(sd), jnp.asarray(x), prompt, max_length=14)
    got = blip_caption_ids(port_tree(sd), nchw(x), prompt, max_length=14)
    assert got.dtype == np.int32 and got.shape == (1, 14)
    assert np.array_equal(got, want)
    if sep_bias:
        at = int(np.flatnonzero(got[0] == SEP)[0])
        assert at < 13 and (got[0, at + 1:] == 0).all()


@pytest.mark.parametrize("text", ["a picture of", "A Picture of xyzzy", "",
                                  "a picture of a picture"])
def test_wordpiece_matches_reference(vocab, text):
    from forge_tpu.models.blip import WordPiece as Ref
    from forge_tpu_torch.models.blip import WordPiece

    ref, wp = Ref(vocab), WordPiece(vocab)
    ids = wp.encode(text)
    assert ids == ref.encode(text)
    rng = np.random.default_rng(len(text))
    sample = list(rng.integers(0, 30524, 40)) + [SEP, 0, 5000]
    assert wp.decode(ids + sample) == ref.decode(ids + sample)
    if text == "a picture of":
        assert ids == [104, 105, 106]


def test_captioner_matches_reference(blip, vocab, tmp_path):
    """Both captioners read models/BLIP (the checkpoint and vocab.txt) and
    caption a seeded image the same."""
    import shutil

    from forge_tpu.models.blip import BlipCaptioner as Ref
    from forge_tpu_torch.models.blip import BlipCaptioner

    sd, _, _ = blip
    path = write(str(tmp_path), "blip", sd)
    d = str(tmp_path / "BLIP")
    shutil.copy(vocab, d)
    img = image(7, 80, 112)
    want = Ref(model_dir=d).caption(img, max_length=12)
    cap = BlipCaptioner(model_dir=d, device="cpu")
    assert cap.available and path.endswith(".safetensors")
    got = cap.caption(img, max_length=12)
    assert got == want and len(got.split()) >= 3
    assert BlipCaptioner(model_dir=str(tmp_path / "none"), device="cpu").available is False
    with pytest.raises(RuntimeError, match="no BLIP checkpoint"):
        BlipCaptioner(model_dir=str(tmp_path / "none"), device="cpu").caption(img)

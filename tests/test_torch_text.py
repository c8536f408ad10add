"""The port's pure-Python CLIP tokenizer and text engine against forge_tpu's.

forge_tpu's ClipTokenizer wraps transformers' CLIPTokenizer; the port's must
give the same ids with neither transformers nor `regex`. The text engine's
cond is compared in f32 on the tiny CLIP fixture (1e-5 of the output scale).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from fixtures import make_clip_sd  # noqa: E402

PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "blurry",
    "",
    "(masterpiece:1.2), best quality, [ugly], ((detailed eyes))",
    "a cat, a dog, a bird, a fish",
    "1girl, solo, 3 dogs, 2024 photo, 16:9, 4k, 8K UHD",
    "snake_case_words and under_score_s",
    "the dog's bone, it's a cat's toy, they're we've I'm you'll he'd",
    "Café crème brûlée à la mode, naïve façade, Zürich, São Paulo",
    "ÀÉÎÕÜ uppercase accents and ß",
    "emoji 😀 and symbols ™ © ® → ★",
    "東京タワー and 北京 with 한국어",
    "multiple   spaces\tand\nnewlines",
    "punctuation!!! what?? yes... no;;; (a) [b] {c} <d>",
    "mixed123numbers456 and v2.5 or 3.14159",
    "'quoted' \"double\" `back`",
    "hyphen-ated co-op re-enter",
    "URL https://example.com/path?x=1&y=2",
    "a\\(escaped\\) paren \\[bracket\\]",
    "CamelCaseWords and ALLCAPS",
    "a very long prompt " + ", ".join(f"detail number {i} in a scene" for i in range(14)),
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
]


@pytest.fixture(scope="module")
def tokenizers():
    from forge_tpu.text.tokenizer import ClipTokenizer as HFTok
    from forge_tpu_torch.text.tokenizer import ClipTokenizer

    return HFTok(), ClipTokenizer()


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_ids_match_hf(tokenizers, prompt):
    hf, ours = tokenizers
    assert ours.ids(prompt) == hf.ids(prompt)


def test_special_ids_match_hf(tokenizers):
    hf, ours = tokenizers
    assert (ours.bos, ours.eos, ours.comma) == (hf.bos, hf.eos, hf.comma)


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_text_engine_cond_matches(clip_skip):
    """Emphasis, a prompt longer than 75 tokens (two chunks), and a shorter
    uncond padded to the same chunk count. The fixture's final LayerNorm gets
    a nonzero bias: with bias 0 the embeddings' mean is ~1e-9 rounding noise,
    and the "Original" emphasis mode divides by it."""
    from forge_tpu.core.tree import nest as jax_nest
    from forge_tpu.text.engine import ClassicTextEngine as JEngine, TextEncoderOptions as JOpts
    from forge_tpu.text.tokenizer import ClipTokenizer as HFTok
    from forge_tpu_torch.core.convert import nest
    from forge_tpu_torch.text.engine import ClassicTextEngine, TextEncoderOptions
    from forge_tpu_torch.text.tokenizer import ClipTokenizer

    sd = make_clip_sd(prefix="", seed=3)
    bias = np.random.default_rng(0).standard_normal(64).astype(np.float32) * 0.5 + 0.5
    sd["text_model.final_layer_norm.bias"] = bias
    prompts = [PROMPTS[3], PROMPTS[20]]
    jeng = JEngine(jax_nest({k: jnp.asarray(v) for k, v in sd.items()}), HFTok(),
                   JOpts(clip_skip=clip_skip))
    teng = ClassicTextEngine(nest({k: torch.from_numpy(v) for k, v in sd.items()}),
                             ClipTokenizer(), TextEncoderOptions(clip_skip=clip_skip))
    _, n = teng.tokenize_batch(prompts)
    assert n == 2
    for batch in (prompts, ["blurry", ""]):
        want, want_pooled = jeng(batch, max_chunks=n)
        got, pooled = teng(batch, max_chunks=n)
        want = np.asarray(want)
        assert got.shape == want.shape == (2, 77 * n, 64)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=1e-5)

"""The port's prompt surface end to end against forge_tpu, and its launch counts on SDXL.

The tiny SD1.5 checkpoint (tests/fixtures.py `make_sd15_checkpoint(0)`)
goes through forge_tpu's `make_tiny_engine` and the port's `load_engine`,
then `process_images` at 64², 5 steps, CFG 7, seed 1 (f32 on the CPU):
(1) "[cat:dog:0.5]" prompt editing with an AND part, a textual-inversion
embedding, a style and `cfg_rescale` 0.5; (2) two regional prompts, an
area and a mask; (3) NGMS without prompt editing. Each image reaches PSNR
≥ 40 dB against forge_tpu's (the bar of tests/test_golden_parity.py), the
port's repeats byte for byte and the infotexts are string-equal. forge_tpu
runs with its textual-inversion splice made writable
(tests/test_torch_textual_inversion.py): on f32 weights it raises.
tests/test_torch_prompts_mixed.py holds the combinations forge_tpu mixes and
the prompts phase's launch counts.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402
from test_torch_textual_inversion import writable_reference_splice  # noqa: E402

REQUEST = dict(negative_prompt="blurry", seed=1, subseed=7, steps=5, width=64, height=64,
               cfg_scale=7.0, sampler_name="DPM++ 2M", scheduler="karras")
STYLE = ("moody", "{prompt}, dramatic lighting", "lowres")
MASK = (np.add.outer(np.arange(64), np.arange(64)) % 9 / 8.0).astype(np.float32)
CASES = {  # name: (request fields, options set in both packages)
    "editing + AND + TI + style + rescale": (dict(
        prompt="a photo of a [cat:dog:0.5] wearing forgeemb AND a red hat :0.8",
        styles=[STYLE[0]], cfg_rescale=0.5), {}),
    "regional": (dict(prompt="a landscape", regional_prompts=[
        dict(prompt="a red sky", area=(0.0, 0.0, 0.5, 1.0), feather=2),
        dict(prompt="a blue sea", mask=MASK, weight=0.7, mask_strength=0.8)]), {}),
    "NGMS": (dict(prompt="a cat on a mat"), {"s_min_uncond": 3.0}),
}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def engines():
    """(forge_tpu's tiny engine, the port's), each with the embedding and
    the style; forge_tpu's splice writable; params.txt off on both."""
    from forge_tpu.runtime import styles as jstyles
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.runtime import styles as tstyles
    from forge_tpu_torch.runtime.options import opts

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    jeng = make_tiny_engine(0)
    vec = (np.random.default_rng(5).standard_normal((2, CLIP_WIDTH)) * 0.02).astype(np.float32)
    for eng in (jeng, teng):
        eng.embedding_db.register("forgeemb", vec)
    with pytest.MonkeyPatch.context() as mp:
        writable_reference_splice(mp)
        for mod in (jstyles, tstyles):
            db = mod.StyleDatabase([])
            db.styles[STYLE[0]] = mod.PromptStyle(*STYLE)
            mp.setattr(mod, "prompt_styles", db)
        with opts.override({"save_write_params_txt": False}):
            yield jeng, teng


def _port(teng, fields, options):
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from forge_tpu_torch.runtime.options import opts

    with opts.override(dict(options)):
        return process_images(teng, Processing(**REQUEST, **fields))


@pytest.mark.parametrize("case", list(CASES))
def test_prompt_slice_matches_forge_tpu(engines, case):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts

    jeng, teng = engines
    fields, options = CASES[case]
    with jopts.override(dict(options)):
        want = jproc.process_images(jeng, jproc.Processing(**REQUEST, **fields))
    got = _port(teng, fields, options)
    assert got.images[0].shape == want.images[0].shape == (64, 64, 3)
    value = _psnr(got.images[0], want.images[0])
    print(f"{case}: PSNR {value:.2f} dB")
    assert value >= 40.0, value
    assert got.infotexts == want.infotexts
    assert got.params.items() <= want.params.items()
    again = _port(teng, fields, options)
    assert np.array_equal(got.images[0], again.images[0]) and again.infotexts == got.infotexts
    if case == "NGMS":
        assert "NGMS: 3.0" in got.infotexts[0]
        assert not np.array_equal(got.images[0], _port(teng, fields, {}).images[0])
    if case.startswith("editing"):
        assert "dramatic lighting" in got.infotexts[0] and "lowres" in got.infotexts[0]

"""Engines and request runners shared by the hook-phase, Kohya, Fooocus,
T2I-Adapter, Control-LoRA and ControlNet-inpaint tests
(tests/test_torch_hook_phases*.py, test_torch_fooocus.py,
test_torch_t2i_adapter.py, test_torch_control_units*.py): the tiny SD1.5
of tests/fixtures.py and the tiny SDXL of tests/test_torch_sdxl.py in both
packages, each request run through both `process_images` and held at the
slice bar of tests/test_torch_block_patches_slice.py.
"""

import importlib

import numpy as np

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine
from test_torch_sdxl import REQUEST, _jax_engine, _port_engine, _psnr, _tiny_sdxl_checkpoint

SLICE_BAR = 80.0  # dB at f32, tests/test_torch_block_patches_slice.py's bar
PACKAGES = ("forge_tpu", "forge_tpu_torch")
SDXL_REQUEST = dict(REQUEST)  # 64², DPM++ 2M Karras, 3 steps, CFG 7
SD15_REQUEST = dict(prompt="a photograph of an astronaut riding a horse",
                    negative_prompt="blurry", seed=1, steps=3, width=64, height=64,
                    sampler_name="Euler a", cfg_scale=7.0)


def sdxl_engines():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


def sd15_engines():
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    eng = load_engine(make_sd15_checkpoint(0), device="cpu")
    eng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    return make_tiny_engine(0), eng


def processing(package: str):
    return importlib.import_module(f"{package}.pipeline.processing")


def init_and_mask(size=64, seed=3):
    """A seeded init image [size, size, 3] uint8 and its mask, the centre
    half masked (1 = repaint)."""
    rng = np.random.default_rng(seed)
    init = rng.uniform(0, 255, size=(size, size, 3)).astype(np.uint8)
    mask = np.zeros((size, size), np.float32)
    mask[size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    return init, mask


def run_both(engines, fields, attach=None):
    """The request `fields` with `attach(package, p)` applied in each package
    → (the port's Processed, the reference's Processed, the port's p)."""
    out = []
    for package, engine in zip(PACKAGES, engines):
        proc = processing(package)
        p = proc.Processing(**fields)
        if attach is not None:
            attach(package, p)
        out.append((proc.process_images(engine, p), p))
    (want, _), (got, tp) = out
    return got, want, tp


def assert_slice(got, want, bar=SLICE_BAR, infotexts=True):
    """Each image at the bar against the reference's, and the infotexts equal."""
    assert len(got.images) == len(want.images)
    values = []
    for g, w in zip(got.images, want.images):
        assert g.shape == w.shape and g.dtype == np.uint8
        values.append(_psnr(g, w))
        assert values[-1] >= bar, values
    if infotexts:
        assert [t.split("Version:")[0] for t in got.infotexts] == [
            t.split("Version:")[0] for t in want.infotexts]
    return values

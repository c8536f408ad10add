"""The tiny txt2img slice with each extension on the CFG hook layer against
forge_tpu (CPU, f32): dynamic thresholding, the latent modifier, PAG and SAG
on the tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M Karras, 3 steps),
each through both packages' `process_images`: PSNR ≥ 80 dB, the bar of
tests/test_torch_ipadapter.py, with the reference's infotext; a hires pass
with dynamic thresholding; and from both sides, SAG on a request whose
middle-block grid is not square. The modules are held one by one in
tests/test_torch_cfg_hooks.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sdxl import (REQUEST, _jax_engine, _port_engine, _psnr,  # noqa: E402
                             _tiny_sdxl_checkpoint)

SLICE_BAR = 80.0  # dB, the txt2img slices' bar (tests/test_torch_ipadapter.py's)


@pytest.fixture(scope="module")
def engines():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


# -- the tiny txt2img slice with each extension ---------------------------------------------


def _attach_dynthresh(side, p, engine):
    side.dynamic_thresholding.attach(p, {"mimic_scale": 4.0, "threshold_percentile": 0.97})


def _attach_latent_modifier(side, p, engine):
    side.latent_modifier.attach(p, {"tonemap_multiplier": 1.2, "sharpness_multiplier": 600.0,
                                    "combat_cfg_drift": 0.5})


def _attach_pag(side, p, engine):
    cond = engine.get_learned_conditioning([p.prompt], p.width, p.height)
    p.post_cfg_hooks = [side.pag.build_pag_post_cfg(engine, cond, 3.0)]


def _attach_sag(side, p, engine):
    cond = engine.get_learned_conditioning([p.prompt], p.width, p.height)
    p.unet_hooks, post = side.sag.build_sag(engine, cond, 0.75, 2.0)
    p.post_cfg_hooks = [post]


SLICES = {"dynamic thresholding": (_attach_dynthresh, dict(cfg_scale=15.0)),
          "latent modifier": (_attach_latent_modifier, {}),
          "PAG": (_attach_pag, {}),
          "SAG": (_attach_sag, {})}


class _Side:
    def __init__(self, package):
        import importlib

        for name in ("dynamic_thresholding", "latent_modifier", "pag", "sag"):
            setattr(self, name, importlib.import_module(f"{package}.extensions.{name}"))
        self.proc = importlib.import_module(f"{package}.pipeline.processing")


def _slice(side, engine, name, **fields):
    attach, extra = SLICES[name]
    p = side.proc.Processing(**dict(REQUEST, **extra, **fields))
    attach(side, p, engine)
    return side.proc.process_images(engine, p)


@pytest.fixture(scope="module")
def plain_image(engines):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    return process_images(engines[1], Processing(**REQUEST)).images[0]


@pytest.mark.parametrize("name", list(SLICES))
def test_txt2img_with_extension_matches_forge_tpu(engines, plain_image, name):
    jeng, teng = engines
    want = _slice(_Side("forge_tpu"), jeng, name)
    got = _slice(_Side("forge_tpu_torch"), teng, name)
    g, w = got.images[0], want.images[0]
    assert g.shape == w.shape == (64, 64, 3) and g.dtype == np.uint8
    value = _psnr(g, w)
    print(f"txt2img + {name}: PSNR {value:.2f} dB")
    assert value >= SLICE_BAR, value
    assert _psnr(g, plain_image) < 60  # the extension moved the image
    assert got.infotexts[0].split("Version:")[0] == want.infotexts[0].split("Version:")[0]


def test_hires_pass_takes_dynthresh_as_the_reference(engines):
    """The hires fix (Latent ×1.5, 3 hires steps at 0.7) with dynamic
    thresholding: both passes build the combine against their own σ."""
    jeng, teng = engines
    hires = dict(enable_hr=True, hr_scale=1.5, hr_upscaler="Latent", hr_denoising_strength=0.7)
    want = _slice(_Side("forge_tpu"), jeng, "dynamic thresholding", **hires).images[0]
    got = _slice(_Side("forge_tpu_torch"), teng, "dynamic thresholding", **hires).images[0]
    assert got.shape == want.shape == (96, 96, 3)
    assert _psnr(got, want) >= SLICE_BAR, _psnr(got, want)


def test_sag_refuses_a_grid_that_is_not_square(engines):
    """64×96 gives the tiny UNet's middle block 4 × 6 = 24 tokens: the
    reference's reshape to 4 × 4 fails; the port raises ValueError naming
    SAG and the size."""
    jeng, teng = engines
    fields = dict(width=96)
    with pytest.raises(TypeError, match="reshape"):
        _slice(_Side("forge_tpu"), jeng, "SAG", **fields)
    with pytest.raises(ValueError, match="SAG needs a square .* 96x64 request gives 24 tokens"):
        _slice(_Side("forge_tpu_torch"), teng, "SAG", **fields)

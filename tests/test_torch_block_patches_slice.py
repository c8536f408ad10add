"""The tiny txt2img slice with each extension on the UNet's hooks against
forge_tpu (CPU, f32): FreeU, the hypernetwork, StyleAlign at strength 1.0
and 0.5 (batch 2) and ControlLLLite on the tiny SDXL of
tests/test_torch_sdxl.py (64², DPM++ 2M Karras, 3 steps, CFG 7), each
through both packages' `process_images`: PSNR ≥ 80 dB, the bar of
tests/test_torch_ipadapter.py, with the reference's infotexts. The modules
and the block slots are held one by one in tests/test_torch_block_patches.py,
whose weights these slices share.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_block_patches import (FREEU_SDXL, _hint, _hn_file_dict,  # noqa: E402
                                      _lllite_sd)
from test_torch_sdxl import (REQUEST, _jax_engine, _port_engine, _psnr,  # noqa: E402
                             _tiny_sdxl_checkpoint)

SLICE_BAR = 80.0  # dB, tests/test_torch_ipadapter.py's bar for a tiny slice with hooks


@pytest.fixture(scope="module")
def engines():
    sd = _tiny_sdxl_checkpoint()
    return _jax_engine(sd), _port_engine(sd)


# -- the tiny txt2img slice with each extension ---------------------------------------------


def _slice_fields(name, package, engine):
    """The request's fields and the attach call for an extension, in either package."""
    import importlib

    ext = f"{package}.extensions."
    proc = importlib.import_module(f"{package}.pipeline.processing")
    fields = dict(REQUEST)
    if name.startswith("StyleAlign"):
        fields["batch_size"] = 2
    p = proc.Processing(**fields)
    if name == "FreeU":
        p.unet_hooks = importlib.import_module(ext + "freeu").build_freeu_hooks(
            model_channels=32, **FREEU_SDXL)
    elif name == "hypernetwork":
        mod = importlib.import_module(ext + "hypernetworks")
        mod.attach(p, mod.load_hypernetwork(_hn_file_dict("new", "relu"), name="tiny-hn"), 1.0)
    elif name.startswith("StyleAlign"):
        strength = float(name.split()[-1])
        importlib.import_module(ext + "stylealign").attach(
            p, {"shared_attention": True, "strength": strength})
    else:  # ControlLLLite
        sd = _lllite_sd()
        if package == "forge_tpu":
            from forge_tpu.core.state_dict import transform_for_jax

            sd = transform_for_jax(sd)
        importlib.import_module(ext + "controllllite").attach(
            p, {"model": "tiny-lllite", "weight": 1.5}, sd=sd, cond_image=_hint())
    return proc, p


SLICES = ["FreeU", "hypernetwork", "StyleAlign 1.0", "StyleAlign 0.5", "ControlLLLite"]


@pytest.mark.parametrize("name", SLICES)
def test_txt2img_with_extension_matches_forge_tpu(engines, name):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    jeng, teng = engines
    jproc, jp = _slice_fields(name, "forge_tpu", jeng)
    want = jproc.process_images(jeng, jp)
    tproc, tp = _slice_fields(name, "forge_tpu_torch", teng)
    got = tproc.process_images(teng, tp)
    assert len(got.images) == len(want.images) == tp.batch_size
    plain = process_images(teng, Processing(**dict(REQUEST, batch_size=tp.batch_size))).images
    for g, w, p in zip(got.images, want.images, plain):
        assert g.shape == w.shape == (64, 64, 3) and g.dtype == np.uint8
        value = _psnr(g, w)
        print(f"txt2img + {name}: PSNR {value:.2f} dB")
        assert value >= SLICE_BAR, value
        # the extension moved the image (StyleAlign least: the tiny UNet's 4² self-attentions)
        assert _psnr(g, p) < (75 if name.startswith("StyleAlign") else 60)
    assert [t.split("Version:")[0] for t in got.infotexts] == [
        t.split("Version:")[0] for t in want.infotexts]

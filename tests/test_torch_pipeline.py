"""The port's txt2img slice end to end against forge_tpu, and its import hygiene.

The same tiny checkpoint (tests/fixtures.py `make_sd15_checkpoint(0)`) goes
through forge_tpu's `make_tiny_engine` and the port's `load_engine` with the
same UNet config override, then `process_images` at 64×64, 3 steps, Euler a,
CFG 7, seed 1: the uint8 images must reach PSNR ≥ 40 dB against each other,
the bar tests/test_golden_parity.py sets (both run f32 on the CPU).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
               seed=1, steps=3, width=64, height=64, sampler_name="Euler a", cfg_scale=7.0)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_txt2img_matches_forge_tpu():
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    want = jproc.process_images(make_tiny_engine(0), jproc.Processing(**REQUEST)).images[0]

    eng = load_engine(make_sd15_checkpoint(0), device="cpu")
    eng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    assert eng.compute_dtype == torch.float32
    res = process_images(eng, Processing(**REQUEST))
    got = res.images[0]
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    assert res.seeds == [1]
    assert _psnr(got, want) >= 40.0, _psnr(got, want)
    again = process_images(eng, Processing(**REQUEST)).images[0]
    assert np.array_equal(got, again)


def test_load_engine_without_a_device_does_not_fall_back_to_the_cpu():
    """No device named and no CUDA device: a clear error, not a quiet CPU
    engine; device="cpu" still loads."""
    from forge_tpu_torch.pipeline.engine import default_device, load_engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: load_engine() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_engine(make_sd15_checkpoint(0))
    eng = load_engine(make_sd15_checkpoint(0), device="cpu")
    assert eng.device.type == "cpu" and eng.compute_dtype == torch.float32


def test_processing_refuses_unported_fields():
    from forge_tpu_torch.pipeline.processing import Processing

    with pytest.raises(NotImplementedError, match="tiling"):
        Processing(prompt="x", tiling=True)
    p = Processing()
    with pytest.raises(NotImplementedError, match="image_cfg_scale"):
        p.image_cfg_scale = 1.5
    for name, value in (("cond_transform", lambda c: c), ("reference_state", object()),
                        ("scripts", object()), ("soft_inpainting", object()),
                        ("do_not_save_grid", True), ("restore_faces", True)):
        assert getattr(Processing(prompt="x", **{name: value}), name) is value  # ported fields


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import forge_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(forge_tpu_torch.__path__, "
        "'forge_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 75, mods\n"
        "bad = [m for m in sys.modules if m in ('jax', 'forge_tpu', 'PIL', 'cv2', 'safetensors',"
        " 'transformers', 'psutil') or m.startswith(('jax.', 'forge_tpu.', 'PIL.', 'cv2.',"
        " 'safetensors.', 'transformers.', 'psutil.'))]\n"
        "assert {'forge_tpu_torch.api.server', 'forge_tpu_torch.webui',"
        " 'forge_tpu_torch.runtime.memory', 'forge_tpu_torch.runtime.state',"
        " 'forge_tpu_torch.runtime.queue', 'forge_tpu_torch.runtime.models',"
        " 'forge_tpu_torch.pipeline.preview', 'forge_tpu_torch.pipeline.taesd'} <= set(mods)\n"
        "assert 'forge_tpu_torch.pipeline.upscalers' in mods, mods\n"
        "assert {'forge_tpu_torch.runtime.options', 'forge_tpu_torch.sampling.brownian'} <= set(mods)\n"
        "assert {'forge_tpu_torch.text.textual_inversion', 'forge_tpu_torch.runtime.styles',"
        " 'forge_tpu_torch.pipeline.infotext', 'forge_tpu_torch.core.device',"
        " 'forge_tpu_torch.models.mmdit', 'forge_tpu_torch.models.chroma'} <= set(mods)\n"
        "assert {'forge_tpu_torch.extensions.' + m for m in ('freeu', 'pag', 'sag',"
        " 'dynamic_thresholding', 'latent_modifier', 'hypernetworks', 'stylealign',"
        " 'controllllite', 'soft_inpainting', 'xyz_grid')} <= set(mods)\n"
        "assert {'forge_tpu_torch.runtime.scripts',"
        " 'forge_tpu_torch.pipeline.selectable_scripts'} <= set(mods)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

"""The X/Y/Z grid (forge_tpu_torch/extensions/xyz_grid.py) against
forge_tpu's (CPU, f32).

`run_xyz_grid` on the tiny SDXL of tests/test_torch_sdxl.py (64², DPM++ 2M
Karras, 3 steps): `cfg_scale` [5, 7] × a prompt S/R of two values, and with
a Z axis of `steps`. Outside the label strips the grids meet the slice bar
(80 dB); the port's grid is its own cells with forge_tpu's `_draw_label`
(Pillow) drawn on them, byte for byte, and `_draw_label` equals Pillow's on
400 seeded labels (printable ASCII, non-ASCII, images narrower than the
strip). The reference's `Axis.apply` faults from both sides: `bool("False")`
is True, `int(7.5)` is 7 and a prompt S/R whose text is not in the prompt
changes nothing there; the port raises ValueError for each, and casts sound
values as the reference does.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sdxl import _psnr  # noqa: E402
from torch_controls_cases import PACKAGES, SDXL_REQUEST, SLICE_BAR, processing, sdxl_engines  # noqa: E402


def xyz(package):
    return importlib.import_module(f"{package}.extensions.xyz_grid")


@pytest.fixture(scope="module")
def engines():
    return sdxl_engines()


def _axes(package, z=False):
    mod = xyz(package)
    x = mod.Axis("cfg_scale", [5, 7])
    y = mod.Axis("prompt_sr", ["astronaut", "cat"], search="astronaut")
    return x, y, (mod.Axis("steps", [2, 3]) if z else None)


def _strips(shape, rows, cols, cell=64):
    """The label strips of a rows × cols grid of cell² images: rows 0–14 of
    each cell (the width the longest label takes, whole cells here)."""
    mask = np.zeros(shape[:2], bool)
    for r in range(rows):
        mask[r * cell:r * cell + 15] = True
    return mask


@pytest.mark.parametrize("z", [False, True])
def test_grid_matches_forge_tpu(engines, z):
    grids = {}
    for package, engine in zip(PACKAGES, engines):
        base = processing(package).Processing(**SDXL_REQUEST)
        grids[package] = xyz(package).run_xyz_grid(engine, base, *_axes(package, z))
    want, got = grids["forge_tpu"], grids["forge_tpu_torch"]
    assert len(got) == len(want) == (2 if z else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (128, 128, 3) and g.dtype == np.uint8
        outside = ~_strips(g.shape, 2, 2)
        assert _psnr(g[outside], w[outside]) >= SLICE_BAR
    # the port's legends: its own cells, labelled by forge_tpu's Pillow drawing
    from forge_tpu.extensions.xyz_grid import _draw_label as pillow_label

    x, y, zax = _axes("forge_tpu_torch", z)
    proc = processing("forge_tpu_torch")
    for zi, zv in enumerate(zax.values if z else [None]):
        cells = xyz("forge_tpu_torch").run_xyz_grid(
            engines[1], proc.Processing(**SDXL_REQUEST), x, y,
            xyz("forge_tpu_torch").Axis("steps", [zv]) if z else None, draw_legends=False)[0]
        rows = []
        for r, yv in enumerate(y.values):
            row = [pillow_label(cells[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64],
                                f"{x.label(xv)} | {y.label(yv)}")
                   for c, xv in enumerate(x.values)]
            rows.append(np.concatenate(row, axis=1))
        labelled = np.concatenate(rows, axis=0)
        if z:
            labelled = pillow_label(labelled, zax.label(zv))
        assert np.array_equal(got[zi], labelled)


def test_draw_label_equals_pillow():
    from forge_tpu.extensions.xyz_grid import _draw_label as pillow_label
    from forge_tpu_torch.extensions.xyz_grid import _draw_label

    rng = np.random.default_rng(0)
    chars = [chr(c) for c in range(32, 127)] + ["é", "一", "\t"]
    pick = random.Random(0)
    for _ in range(400):
        text = "".join(pick.choice(chars) for _ in range(pick.randint(0, 40)))
        img = rng.integers(0, 256, (int(rng.integers(4, 40)), int(rng.integers(4, 400)), 3),
                           dtype=np.uint8)
        assert np.array_equal(_draw_label(img, text), pillow_label(img, text)), text


def _p(package, **fields):
    return processing(package).Processing(**{**SDXL_REQUEST, **fields})


@pytest.mark.parametrize("field,value,reference", [
    ("enable_hr", "False", True),  # bool("False")
    ("steps", 7.5, 7),  # int(7.5)
    ("prompt_sr", "dog", SDXL_REQUEST["prompt"]),  # "astronaut" absent: nothing replaced
])
def test_axis_faults_from_both_sides(field, value, reference):
    search = "spaceman" if field == "prompt_sr" else None
    jp = _p("forge_tpu")
    xyz("forge_tpu").Axis(field, [value], search=search).apply(jp, value)
    assert getattr(jp, "prompt" if field == "prompt_sr" else field) == reference
    with pytest.raises(ValueError):
        xyz("forge_tpu_torch").Axis(field, [value], search=search).apply(
            _p("forge_tpu_torch"), value)


@pytest.mark.parametrize("field,value", [
    ("enable_hr", True), ("enable_hr", 0), ("steps", "12"), ("steps", 12.0), ("cfg_scale", "5.5"),
    ("cfg_scale", 4), ("sampler_name", "Euler a"), ("seed", 3), ("prompt_sr", "dog"),
    ("hr_checkpoint_name", "x"),
])
def test_axis_casts_sound_values_as_forge_tpu(field, value):
    search = "astronaut" if field == "prompt_sr" else None
    out = []
    for package in PACKAGES:
        p = _p(package)
        axis = xyz(package).Axis(field, [value], search=search)
        axis.apply(p, value)
        name = "prompt" if field == "prompt_sr" else field
        out.append((getattr(p, name), type(getattr(p, name)), axis.label(value)))
    assert out[0] == out[1]

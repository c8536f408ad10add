"""X/Y/Z grid (port of forge_tpu/extensions/xyz_grid.py): sweep generation
parameters and assemble a labeled grid.

Pick axes (any Processing field or prompt S/R), generate every combination
with `process_images`, compose one grid image a Z value with axis legends.

The legends without Pillow: `_draw_label` fills the reference's black strip
(columns 0 … min(8·len + 8, W) and rows 0 … 14, both ends included) and
draws the text at (4, 2) in white from the glyphs of Pillow's default font
that the repo carries (label_font.npz, written by tools/make_label_font.py:
Aileron Regular at 10 px, printable ASCII and the glyph Pillow draws for
any other character), overlapping glyphs joined as a screen and the text
blended onto the image as Pillow's ImageDraw blends it. Pillow lays these
glyphs out at whole-pixel advances with no kerning, so the port's labels
are Pillow's where Pillow renders with FreeType's default font (the tests
hold them against Pillow); every pixel outside the strip is the image's.

`Axis.apply` casts a value with the field's current type, as the
reference's does, and refuses the values whose cast is wrong there with a
ValueError: a string for a bool field (`bool("False")` is True), a float
with a fraction for an int field (`int(7.5)` is 7), and a prompt S/R whose
search text is not in the prompt (the reference then renders every cell
from the same prompt).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

_FONT_PATH = os.path.join(os.path.dirname(__file__), "label_font.npz")
_FONT: Dict[int, Any] = {}


@dataclasses.dataclass
class Axis:
    field: str               # Processing field name, or "prompt_sr"
    values: Sequence[Any]
    search: Optional[str] = None  # for prompt S/R: substring replaced by value

    def apply(self, p, value):
        if self.field == "prompt_sr":
            search = self.search or str(self.values[0])
            if search not in p.prompt:
                raise ValueError(f"prompt S/R: {search!r} is not in the prompt {p.prompt!r}")
            p.prompt = p.prompt.replace(search, str(value))
            return
        current = getattr(p, self.field)
        if current is None:
            setattr(p, self.field, value)
            return
        kind = type(current)
        if kind is bool and isinstance(value, str):
            raise ValueError(f"X/Y/Z axis {self.field}: the string {value!r} for a bool field "
                             "(bool() of any non-empty string is True)")
        if kind is int and not isinstance(value, (bool, str)) and float(value) != int(value):
            raise ValueError(f"X/Y/Z axis {self.field}: {value!r} for an int field would be "
                             f"truncated to {int(value)}")
        setattr(p, self.field, kind(value))

    def label(self, value) -> str:
        name = self.search or self.field
        return f"{name}: {value}"


def _font() -> Dict[int, Any]:
    """code point → (bitmap [h, w] uint8, (dx, dy) from the pen, advance)."""
    if not _FONT:
        data = np.load(_FONT_PATH)
        start = 0
        for code, (h, w), off, adv in zip(data["codes"], data["shapes"], data["offsets"],
                                          data["advances"]):
            _FONT[int(code)] = (data["pixels"][start:start + h * w].reshape(h, w),
                                (int(off[0]), int(off[1])), int(adv))
            start += h * w
    return _FONT


def _draw_label(img: np.ndarray, text: str) -> np.ndarray:
    """The label strip and its text over a copy of img [H, W, 3] uint8."""
    out = np.array(img, np.uint8, copy=True)
    h, w = out.shape[:2]
    out[0:15, 0:min(8 * len(text) + 8, w - 1) + 1] = 0
    font = _font()
    cover = np.zeros((h, w), np.int32)
    pen = 0
    for ch in text:
        bitmap, (dx, dy), advance = font.get(ord(ch), font[-1])
        y0, x0 = 2 + dy, 4 + pen + dx
        gh, gw = bitmap.shape
        ys, xs = slice(max(y0, 0), min(y0 + gh, h)), slice(max(x0, 0), min(x0 + gw, w))
        if ys.start < ys.stop and xs.start < xs.stop:
            g = bitmap[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0].astype(np.int32)
            c = cover[ys, xs]
            cover[ys, xs] = 255 - ((255 - c) * (255 - g) + 127) // 255
        pen += advance
    a = cover[..., None]
    blend = out.astype(np.int32) * (255 - a) + 255 * a + 128
    return (((blend >> 8) + blend) >> 8).astype(np.uint8)


def run_xyz_grid(
    engine,
    base,  # Processing template
    x_axis: Axis,
    y_axis: Optional[Axis] = None,
    z_axis: Optional[Axis] = None,
    process_fn: Optional[Callable] = None,
    draw_legends: bool = True,
) -> List[np.ndarray]:
    """→ one grid image per Z value (reference draws the same)."""
    from ..pipeline.processing import process_images

    process_fn = process_fn or process_images
    ys = y_axis.values if y_axis else [None]
    zs = z_axis.values if z_axis else [None]

    grids = []
    for zv in zs:
        rows = []
        for yv in ys:
            row = []
            for xv in x_axis.values:
                p = copy.copy(base)
                p.all_seeds = p.all_subseeds = None
                x_axis.apply(p, xv)
                if y_axis and yv is not None:
                    y_axis.apply(p, yv)
                if z_axis and zv is not None:
                    z_axis.apply(p, zv)
                img = process_fn(engine, p).images[0]
                if draw_legends:
                    label = x_axis.label(xv)
                    if y_axis and yv is not None:
                        label += f" | {y_axis.label(yv)}"
                    img = _draw_label(img, label)
                row.append(img)
            rows.append(np.concatenate(row, axis=1))
        grid = np.concatenate(rows, axis=0)
        if draw_legends and z_axis and zv is not None:
            grid = _draw_label(grid, z_axis.label(zv))
        grids.append(grid)
    return grids

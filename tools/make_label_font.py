"""Write forge_tpu_torch/extensions/label_font.npz: the glyphs of Pillow's
default font (`ImageFont.load_default()`, Aileron Regular at 10 px where
Pillow has FreeType) as the X/Y/Z grid's labels draw them, for the port,
which draws its labels without Pillow (forge_tpu_torch/extensions/xyz_grid.py).

For each printable ASCII character and for the glyph Pillow draws for any
other character (code −1): its 8-bit coverage bitmap from `getmask2`, the
bitmap's offset from the pen position, and its advance. The font has no
kerning between these characters (checked here).

    python tools/make_label_font.py
"""

import os

import numpy as np
from PIL import ImageFont

OUT = os.path.join(os.path.dirname(__file__), "..", "forge_tpu_torch", "extensions",
                   "label_font.npz")


def main():
    font = ImageFont.load_default()
    chars = [chr(c) for c in range(32, 127)]
    codes, shapes, offsets, advances, pixels = [], [], [], [], []
    for code, ch in [(ord(c), c) for c in chars] + [(-1, "\x7f")]:
        mask, offset = font.getmask2(ch, "L")
        w, h = mask.size
        codes.append(code)
        shapes.append((h, w))
        offsets.append(offset)
        advances.append(font.getlength(ch))
        pixels.append(np.array(mask, np.uint8).reshape(h, w).ravel() if w * h else
                      np.zeros(0, np.uint8))
    for a in chars:
        for b in chars:
            assert font.getlength(a + b) == font.getlength(a) + font.getlength(b), (a, b)
    assert all(float(a).is_integer() for a in advances)
    np.savez_compressed(OUT, codes=np.array(codes, np.int32), shapes=np.array(shapes, np.int32),
                        offsets=np.array(offsets, np.int32),
                        advances=np.array(advances, np.int32), pixels=np.concatenate(pixels),
                        name=np.array(" ".join(font.getname())), size=np.array(font.size))
    print(f"{OUT}: {len(codes)} glyphs of {' '.join(font.getname())} {font.size} px, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()

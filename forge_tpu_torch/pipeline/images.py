"""Image resizing for img2img (port of forge_tpu/pipeline/images.py
`resize_init_image`), CLIP-vision preprocessing, regional prompt masks and
the simple upscalers, the grid of the selectable scripts (`image_grid`),
img2img's colour correction, the PNG codec the API reads and writes
images with, and the saving of images (`save_image`, as PNG through that
codec, with the reference's filename patterns, `log.csv` and events).

The reference resizes with PIL's LANCZOS (init images, the "Lanczos"
upscaler), BICUBIC (the CLIP-vision input), BILINEAR (regional prompts'
masks) and NEAREST (the "Nearest" upscaler); the card's machine has no
Pillow, so `lanczos_resize`, `bicubic_resize`, `bilinear_resize` and
`nearest_resize` compute what Pillow's `Image.resize` does for 8-bit images,
in numpy. Lanczos, bicubic and bilinear: per axis, the filter's taps at
half-pixel centres (Lanczos a = 3, support 3; cubic a = −0.5, support 2;
the triangle, support 1; the support widened by the scale when shrinking),
normalised, then rounded to 22-bit fixed point; the horizontal pass first,
its result rounded and clipped to uint8, then the vertical pass the same
way. Nearest: Pillow's affine scale, the source coordinate of output i
being (i + 0.5)·n_in/n_out accumulated in double by repeated addition and
truncated.

PNG without Pillow: `encode_png` writes 8-bit gray, RGB or RGBA (every row
filter None, zlib from the standard library) with the infotext as a tEXt
chunk "parameters" (iTXt where it is not Latin-1, as Pillow writes it);
`decode_png` reads non-interlaced gray (1, 2, 4 and 8 bits), gray+alpha,
RGB, RGBA and palette images (1-8 bits, tRNS alpha) under all five row
filters, with their tEXt, zTXt and iTXt text. Any other image (JPEG, WebP,
GIF, 16-bit or interlaced PNG) raises `UnsupportedImage` with its format's
name: nothing is guessed. As Pillow does against decompression bombs, an
image past `MAX_IMAGE_PIXELS` (or 16384 a side) raises `ImageTooLarge`
before its data is inflated, the data is inflated no further than the
image's rows, and a compressed text no further than 1 MiB. Rows filtered
Average or Paeth are undone a pixel anti-diagonal at a time. The bytes are
not Pillow's; the pixels and the text are.

Colour correction without OpenCV: the reference converts uint8 RGB to LAB
and back with `cv2.cvtColor`, whose 8-bit paths are integer arithmetic over
tables. `rgb_to_lab` and `lab_to_rgb` compute those tables and that
arithmetic in numpy and give cv2's bytes for every one of the 2^24 inputs
(tests/test_torch_scripts_images.py holds both against cv2).

Face restoration resizes its crops with `cv2.resize(..., INTER_LINEAR)` in
the reference; `cv2_linear_resize` computes OpenCV's fixed-point result for
uint8 and its float result for float32 (tests/test_torch_faces.py holds it
against cv2).
"""

from __future__ import annotations

import datetime
import math
import os
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_PRECISION_BITS = 22  # Pillow's Resample.c: 32 − 8 − 2


def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        out = np.ones_like(v)
        nz = v != 0.0
        pv = v[nz] * np.pi
        out[nz] = np.sin(pv) / pv
        return out

    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0),  # (filter, support)
            "bilinear": (_triangle, 1.0)}


def _coefficients(n_in: int, n_out: int, kind: str):
    """→ (first input index [n_out], fixed-point taps [n_out, k]) for one axis."""
    filt, base_support = _FILTERS[kind]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C casts truncate
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    taps = np.arange(ksize)
    w = filt((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, n_out: int, axis: int, kind: str) -> np.ndarray:
    """One 8-bit pass of Pillow's resampler along `axis` of a uint8 array.
    The sums are exact integers: in int32 where 255 times a row's absolute
    taps (which bounds every partial sum) fits, as for every Lanczos, bicubic
    and bilinear row in practice, else int64; one buffer is reused a tap."""
    n_in = img.shape[axis]
    xmin, k = _coefficients(n_in, n_out, kind)
    half = 1 << (_PRECISION_BITS - 1)
    dtype = np.int32 if 255 * int(np.abs(k).sum(axis=1).max()) + half < 2**31 else np.int64
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(dtype)
    acc = np.full((n_out,) + src.shape[1:], half, dtype)
    buf = np.empty_like(acc)
    taps = k.astype(dtype).reshape(k.shape + (1,) * (src.ndim - 1))
    for t in range(k.shape[1]):
        # a zero tap past the edge reads any pixel
        np.take(src, np.minimum(xmin + t, n_in - 1), axis=0, out=buf)
        buf *= taps[:, t]
        acc += buf
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize(img: np.ndarray, w: int, h: int, kind: str) -> np.ndarray:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    if arr.shape[1] != w:
        arr = _resample_axis(arr, w, 1, kind)
    if arr.shape[0] != h:
        arr = _resample_axis(arr, h, 0, kind)
    return arr


def lanczos_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] → [h,w(,C)], as Pillow's LANCZOS resize."""
    return _resize(img, w, h, "lanczos")


def bilinear_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] → [h,w(,C)], as Pillow's BILINEAR resize."""
    return _resize(img, w, h, "bilinear")


def bicubic_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] → [h,w(,C)], as Pillow's BICUBIC resize."""
    return _resize(img, w, h, "bicubic")


def _nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's ImagingScaleAffine: xo = a·0.5, then xo += a per output, a = n_in/n_out."""
    a = float(np.float32(n_in)) / n_out
    steps = np.full(n_out, a, np.float64)
    steps[0] = a * 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), n_in - 1)  # cumsum adds in order


def nearest_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] → [h,w(,C)], as Pillow's NEAREST resize."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr[_nearest_indices(arr.shape[0], h)][:, _nearest_indices(arr.shape[1], w)]


def resize_init_image(img: np.ndarray, w: int, h: int, mode: int = 0) -> np.ndarray:
    """Reference images.resize_image semantics for img2img init images:
    mode 0 'Just resize', 1 'Crop and resize' (scale to cover, centre crop),
    2 'Resize and fill' (scale to fit, the gaps filled by replicating the
    border rows and columns); any other mode resizes as 0. The reference's
    upscaler-assisted enlargement waits for the upscalers."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    if mode == 1:  # crop and resize: cover, centre crop
        k = max(w / iw, h / ih)
        rw, rh = int(round(iw * k)), int(round(ih * k))
        r = lanczos_resize(img, rw, rh)
        top, left = (rh - h) // 2, (rw - w) // 2
        return r[top:top + h, left:left + w]
    if mode == 2:  # resize and fill: fit, replicate the border into the gaps
        k = min(w / iw, h / ih)
        rw, rh = max(int(round(iw * k)), 1), max(int(round(ih * k)), 1)
        r = lanczos_resize(img, rw, rh)
        top, left = (h - rh) // 2, (w - rw) // 2
        return np.pad(r, ((top, h - rh - top), (left, w - rw - left), (0, 0)), mode="edge")
    return lanczos_resize(img, w, h)


def image_grid(images: List[np.ndarray], rows: Optional[int] = None,
               margin: int = 0) -> np.ndarray:
    """Cells composited row-major; `margin` px of white between cells
    (reference images.py image_grid + the grid-margins UI option)."""
    n = len(images)
    if rows is None:
        rows = int(math.sqrt(n)) or 1
    cols = math.ceil(n / rows)
    h, w, c = images[0].shape
    m = max(int(margin), 0)
    grid = np.full((rows * h + (rows - 1) * m, cols * w + (cols - 1) * m, c), 255, np.uint8)
    for i, img in enumerate(images):
        r, cc = divmod(i, cols)
        y, x = r * (h + m), cc * (w + m)
        grid[y:y + h, x:x + w] = img
    return grid


# -- colour correction -------------------------------------------------------
# OpenCV's 8-bit RGB↔LAB (D65): RGB → LAB through the sRGB gamma table (×8,
# 256 entries), XYZ coefficients scaled by 2^12 over the white point and a
# cube-root table of 3072 entries scaled by 2^15; LAB → RGB through L → (y,
# f(y)) and f → x, z tables at 2^14, the inverse coefficients at 2^12 and an
# inverse gamma table of 4096 entries

_LAB_SHIFT, _LAB_SHIFT2, _LAB_BASE = 12, 15, 1 << 14
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_XYZ_TO_SRGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])
_MIN_AB = -8145  # the least f(x) or f(z) index OpenCV's table holds
# OpenCV's float cube root rounds these two entries of the cube-root table
# to the neighbouring integer of the correctly rounded value
_CBRT_TABLE_FIXES = {49: 9454, 628: 22126}
_LAB_TABLES: Dict[str, np.ndarray] = {}


def _trunc_div(a: np.ndarray, b: int) -> np.ndarray:
    """C's integer division (toward zero) on int64 arrays."""
    q = np.abs(a) // abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _lab_tables() -> Dict[str, np.ndarray]:
    if _LAB_TABLES:
        return _LAB_TABLES
    f32, base = np.float32, _LAB_BASE
    x = np.arange(256, dtype=np.float64) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    t = _LAB_TABLES
    t["gamma"] = np.rint(255.0 * 8 * gamma).astype(np.int64)
    xs = np.arange(256 * 3 // 2 * 8, dtype=np.float64) / (255.0 * 8)
    cbrt = np.where(xs < 216 / 24389, xs * (841 / 108) + 16 / 116, np.cbrt(xs))
    t["cbrt"] = np.rint((1 << _LAB_SHIFT2) * cbrt).astype(np.int64)
    for i, v in _CBRT_TABLE_FIXES.items():
        t["cbrt"][i] = v
    t["to_xyz"] = np.rint((1 << _LAB_SHIFT) * _SRGB_TO_XYZ / _D65[:, None]).astype(np.int64)
    i = np.arange(256)
    fy = (i * 100 * base).astype(f32) / f32(255 * 116) + f32(16 * base) / f32(116)
    low = i <= 20  # L ≤ 8
    t["y"] = np.where(low, np.rint((i * base * 20 * 9).astype(f32) / f32(17 * 29 ** 3)),
                      np.rint(fy * fy * fy / f32(base * base))).astype(np.int64)
    t["fy"] = np.where(low, np.rint(f32(base) * (f32(16) / f32(116)
                                                 + (i * 5).astype(f32) / f32(3 * 17 * 29))),
                       np.rint(fy)).astype(np.int64)
    v = np.arange(_MIN_AB, base * 9 // 4 + _MIN_AB, dtype=np.int64)
    t["xz"] = np.where(v <= 3390, _trunc_div(v * 108, 841) - base * 16 // 116 * 108 // 841,
                       _trunc_div(_trunc_div(v * v, base) * v, base))
    t["to_rgb"] = np.rint((1 << _LAB_SHIFT) * _XYZ_TO_SRGB * _D65[None, :]).astype(np.int64)
    xs = (np.arange(4096).astype(f32) * (f32(1) / f32(4096))).astype(np.float64)
    inv = np.where(xs <= 0.0031308, xs * 12.92, 1.055 * xs ** (1 / 2.4) - 0.055)
    t["inv_gamma"] = np.rint(255.0 * inv).astype(np.int64)
    return t


def _descale(v: np.ndarray, shift: int) -> np.ndarray:
    return (v + (1 << (shift - 1))) >> shift


def rgb_to_lab(image: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] → uint8 LAB, as `cv2.cvtColor(image, cv2.COLOR_RGB2LAB)`."""
    t = _lab_tables()
    rgb = t["gamma"][np.asarray(image, np.uint8).astype(np.int64)]
    f = t["cbrt"][_descale(rgb @ t["to_xyz"].T, _LAB_SHIFT)]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    lab = np.stack([_descale(296 * fy - 1336934, _LAB_SHIFT2),
                    _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2),
                    _descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def lab_to_rgb(image: np.ndarray) -> np.ndarray:
    """uint8 LAB [..., 3] → uint8 RGB, as `cv2.cvtColor(image, cv2.COLOR_LAB2RGB)`."""
    t, base = _lab_tables(), _LAB_BASE
    lab = np.asarray(image, np.uint8).astype(np.int64)
    light, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y, fy = t["y"][light], t["fy"][light]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * base // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * base // 200 + 1
    xyz = np.stack([t["xz"][fy + adiv - _MIN_AB], y, t["xz"][fy - bdiv - _MIN_AB]], -1)
    rgb = np.clip(_descale(xyz @ t["to_rgb"].T, _LAB_SHIFT + 2), 0, 4095)
    return t["inv_gamma"][rgb].astype(np.uint8)


def _match_histogram_channel(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """CDF histogram matching of one channel (the skimage match_histograms
    algorithm the reference relies on, done directly in numpy)."""
    s_values, bin_idx, s_counts = np.unique(src.ravel(), return_inverse=True,
                                            return_counts=True)
    t_values, t_counts = np.unique(tgt.ravel(), return_counts=True)
    s_quantiles = np.cumsum(s_counts) / src.size
    t_quantiles = np.cumsum(t_counts) / tgt.size
    mapped = np.interp(s_quantiles, t_quantiles, t_values)
    return mapped[bin_idx].reshape(src.shape)


def setup_color_correction(image: np.ndarray) -> np.ndarray:
    """Snapshot the init image's LAB histogram target (reference
    processing.py:745 setup_color_correction)."""
    return rgb_to_lab(np.asarray(image, np.uint8))


def apply_color_correction(correction: np.ndarray, image: np.ndarray) -> np.ndarray:
    """Histogram-match a generated image to the init image in LAB space
    (reference processing.py:751 apply_color_correction)."""
    lab = rgb_to_lab(np.asarray(image, np.uint8))
    matched = np.stack([_match_histogram_channel(lab[..., c], correction[..., c])
                        for c in range(3)], axis=-1).astype(np.uint8)
    return lab_to_rgb(matched)


# -- OpenCV's INTER_LINEAR ---------------------------------------------------

_CV_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE: 11-bit fixed-point weights


def _cv_linear_taps(n_in: int, n_out: int, single: bool):
    """Source index and fraction of each output along one axis: the centre
    (i + 0.5)·n_in/n_out − 0.5, its floor and the remainder, in float32
    (`single`) or float64."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    if single:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(f.dtype)).astype(np.float32)


def _cv_fixed(v: np.ndarray) -> np.ndarray:
    return np.rint(v * np.float32(_CV_COEF_SCALE)).astype(np.int64)


def cv2_linear_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 or float32 [H,W] or [H,W,C] → [h,w(,C)], as `cv2.resize(img,
    (w, h), interpolation=cv2.INTER_LINEAR)` gives it.

    The same size is a copy. uint8 halved on both axes is OpenCV's fast
    area path, (a + b + c + d + 2) >> 2. Otherwise: per output pixel the two
    taps at the centre above (clamped at the edges), the horizontal pass
    first. uint8 rounds the weights to 11 bits, sums the row products
    exactly and combines two rows as OpenCV's vector code does:
    ((r0 >> 4)·β0 >> 16) + ((r1 >> 4)·β1 >> 16), + 2, >> 2. float32 keeps
    float weights (computed in float64, as OpenCV's optimized path does for
    images of two rows or more)."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.float32):
        raise ValueError(f"cv2_linear_resize takes uint8 or float32, not {a.dtype}")
    src_h, src_w = a.shape[:2]
    if (src_w, src_h) == (w, h):
        return a.copy()
    u8 = a.dtype == np.uint8
    if u8 and (src_w, src_h) == (2 * w, 2 * h):
        s = a.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    return cv2_linear_resample(a, w, h, _cv_linear_taps(src_w, w, u8),
                               _cv_linear_taps(src_h, h, u8))


def cv2_linear_resample(a: np.ndarray, w: int, h: int, xtaps, ytaps) -> np.ndarray:
    """`cv2_linear_resize`'s two-tap pass on given taps: (source index,
    float32 fraction) a column and a row. OpenCV's INTER_AREA takes it when
    it upscales, with its own taps."""
    src_h, src_w = a.shape[:2]
    u8 = a.dtype == np.uint8
    sx, fx = xtaps
    edge = (sx < 0) | (sx >= src_w - 1)
    fx = np.where(edge, np.float32(0), fx)
    sx = np.clip(sx, 0, src_w - 1)
    x1 = np.minimum(sx + 1, src_w - 1)
    sy, fy = ytaps
    y0, y1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)
    src = a.reshape(src_h, src_w, -1)
    if u8:
        src = src.astype(np.int64)
        rows = (src[:, sx] * _cv_fixed(np.float32(1) - fx)[None, :, None]
                + src[:, x1] * _cv_fixed(fx)[None, :, None])
        b0 = _cv_fixed(np.float32(1) - fy)[:, None, None]
        b1 = _cv_fixed(fy)[:, None, None]
        out = ((((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        rows = (src[:, sx] * (np.float32(1) - fx)[None, :, None]
                + src[:, x1] * fx[None, :, None])
        out = (rows[y0] * (np.float32(1) - fy)[:, None, None]
               + rows[y1] * fy[:, None, None])
    return out.reshape((h, w) + a.shape[2:])


# -- PNG ---------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples a pixel
_MODE_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels → colour type (gray, RGB, RGBA)


# Pillow's Image.MAX_IMAGE_PIXELS: the most pixels `decode_png` reads (Pillow
# warns past it and refuses twice it)
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3
# the longest side it reads: the row filters take h + w numpy steps
MAX_IMAGE_SIDE = 16384
_MAX_TEXT_BYTES = 1 << 20  # Pillow's MAX_TEXT_CHUNK: the most a zTXt or iTXt text inflates to


class UnsupportedImage(ValueError):
    """An image the codec does not read; `format` names it."""

    def __init__(self, fmt: str):
        super().__init__(f"unsupported image format: {fmt} (the port reads 8-bit PNG only)")
        self.format = fmt


class ImageTooLarge(ValueError):
    """A PNG past `MAX_IMAGE_PIXELS` or `MAX_IMAGE_SIDE`, or a text chunk past
    1 MiB inflated."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """uint8 [H,W], [H,W,1], [H,W,3] or [H,W,4] → PNG bytes; `text` → one
    tEXt chunk a key (iTXt, UTF-8, where the value is not Latin-1)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _MODE_COLOR_TYPE:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, not {c}")
    out = [_PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                       _MODE_COLOR_TYPE[c], 0, 0, 0))]
    for key, value in (text or {}).items():
        try:
            out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1")))
        except UnicodeEncodeError:
            out.append(_chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0"
                              + value.encode("utf-8")))
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = arr.reshape(h, w * c)
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _sniff(data: bytes) -> str:
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\0", b"MM\0*"):
        return "TIFF"
    return "unknown"


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters → [h, stride] uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    ftypes, lines = data[:, 0], data[:, 1:]
    if ftypes.max() > 4:
        raise ValueError(f"PNG row filter {int(ftypes.max())} is not defined")
    if np.isin(ftypes, (3, 4)).any():
        return _unfilter_wavefront(lines, ftypes, bpp)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = ftypes[y], lines[y]
        if ftype == 0:
            row = line.copy()
        elif ftype == 1:  # Sub: a running sum along each byte lane
            row = np.empty(stride, np.uint8)
            for lane in range(bpp):
                row[lane::bpp] = np.cumsum(line[lane::bpp], dtype=np.uint64) % 256
        else:  # Up
            row = line + prior
        out[y] = row
        prior = row
    return out


def _unfilter_wavefront(lines: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """The row filters of an image with Average or Paeth rows, whose bytes each
    need their reconstructed left, upper and upper-left pixels: undone one
    anti-diagonal of pixels at a time, h + w − 1 numpy steps in place of
    h·w·bpp Python ones. In the padded [h+1, w+1] image, anti-diagonal d's
    pixels and their three neighbours lie w apart in the flat array."""
    h, n = lines.shape[0], lines.shape[1] // bpp
    out = np.zeros(((h + 1) * (n + 1), bpp), np.int16)  # row 0 and column 0: the zeros
    filt = lines.reshape(h * n, bpp).astype(np.int16)
    kind = ftypes.astype(np.int16)[:, None]
    for d in range(h + n - 1):
        lo, hi = max(0, d - n + 1), min(h, d + 1)  # the rows on this anti-diagonal
        at = slice(d + lo * n, d + (hi - 1) * n + 1, n)  # their upper-left neighbours
        c = out[at]
        b = out[at.start + 1:at.stop + 1:n]  # up
        a = out[at.start + n + 1:at.stop + n + 1:n]  # left
        ac, bc = a - c, b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = kind[lo:hi]
        pred = np.where(t == 4, paeth, np.where(t == 3, (a + b) >> 1,
                                                np.where(t == 2, b, np.where(t == 1, a, 0))))
        f = filt[d + lo * (n - 1):d + (hi - 1) * (n - 1) + 1:max(n - 1, 1)]
        out[at.start + n + 2:at.stop + n + 2:n] = (f + pred) & 255
    return out.reshape(h + 1, n + 1, bpp)[1:, 1:].reshape(h, n * bpp).astype(np.uint8)


def _inflate(data: bytes, limit: int, what: str) -> bytes:
    """zlib data → at most `limit` bytes; more raises (a decompression bomb)."""
    out = zlib.decompressobj().decompress(data, limit + 1)
    if len(out) > limit:
        raise ImageTooLarge(f"{what} inflates past {limit} bytes")
    return out


def _text_chunk(kind: bytes, data: bytes) -> Tuple[str, str]:
    key, _, rest = data.partition(b"\0")
    if kind == b"tEXt":
        return key.decode("latin-1"), rest.decode("latin-1")
    if kind == b"zTXt":
        return key.decode("latin-1"), _inflate(rest[1:], _MAX_TEXT_BYTES,
                                               "zTXt").decode("latin-1")
    compressed, rest = rest[0], rest[2:]  # iTXt: flag, method, language\0, translated\0, text
    _, _, rest = rest.partition(b"\0")
    _, _, rest = rest.partition(b"\0")
    if compressed:
        rest = _inflate(rest, _MAX_TEXT_BYTES, "iTXt")
    return key.decode("latin-1"), rest.decode("utf-8")


def decode_png(data: bytes) -> Tuple[np.ndarray, Dict[str, str]]:
    """PNG bytes → (uint8 pixels, text chunks). Pixels are [H,W] gray, [H,W,2]
    gray+alpha, [H,W,3] RGB or [H,W,4] RGBA; a palette image comes out
    through its palette as RGB (RGBA where it has a tRNS chunk)."""
    if data[:8] != _PNG_SIGNATURE:
        raise UnsupportedImage(_sniff(data))
    pos, ihdr, idat, text, palette, trns = 8, None, [], {}, None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind in (b"tEXt", b"zTXt", b"iTXt"):
            key, value = _text_chunk(kind, body)
            text[key] = value
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _COLOR_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not defined")
    if depth == 16:
        raise UnsupportedImage("16-bit PNG")
    if interlace:
        raise UnsupportedImage("interlaced PNG")
    if depth != 8 and ctype not in (0, 3):
        raise ValueError(f"PNG bit depth {depth} is not defined for colour type {ctype}")
    if not w * h:
        raise ValueError(f"PNG of {w}x{h} pixels holds none")
    if w * h > MAX_IMAGE_PIXELS or max(w, h) > MAX_IMAGE_SIDE:
        raise ImageTooLarge(f"PNG of {w}x{h} pixels: the port reads up to {MAX_IMAGE_PIXELS} "
                            f"pixels and {MAX_IMAGE_SIDE} a side")
    channels = _COLOR_CHANNELS[ctype]
    stride = (w * channels * depth + 7) // 8
    size = h * (stride + 1)  # the filtered rows' bytes; the stream is read no further
    raw = zlib.decompressobj().decompress(b"".join(idat), size)
    rows = _unfilter(raw, h, stride, max(channels * depth // 8, 1))
    if depth < 8:  # 1, 2 or 4 bits a sample, packed from the high bits
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1).astype(np.uint8)
        if ctype == 0:
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    else:
        px = rows.reshape(h, w, channels)
        if channels == 1:
            px = px[..., 0]
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        table = palette
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(palette)]
            table = np.concatenate([palette, alpha[:, None]], axis=1)
        px = table[px]
    return np.ascontiguousarray(px), text


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """Decoded pixels → uint8 [H,W,3], as Pillow's convert("RGB"): gray
    repeated, alpha dropped."""
    if pixels.ndim == 2:
        return np.repeat(pixels[..., None], 3, axis=-1)
    if pixels.shape[-1] == 2:
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


# -- saving (forge_tpu/pipeline/images.py:33-188) ---------------------------

_ROADMAP_ENCODERS = ("ROADMAP.md queue 1 item 7: the JPEG, WebP, AVIF and GIF encoders (the "
                     "card's machine has no Pillow)")


def save_image(image: np.ndarray, path: Optional[str] = None, outdir: str = "outputs",
               infotext: Optional[str] = None, file_format: Optional[str] = None,
               filename_pattern: Optional[str] = None, seed: int = 0, prompt: str = "",
               quality: Optional[int] = None, **pattern_extra) -> str:
    """uint8 [H,W,C] → the saved file's path, under the reference's saving
    options: the `directories_filename_pattern` subdirectory under
    `save_to_dirs`, the name from `samples_filename_pattern` (or
    `filename_pattern`, default "[seed]-[prompt_spaces]") with the
    `save_images_add_number` prefix (the count of the directory's names
    that start with digits, five wide) and a `-N` suffix on a clash. The
    `before_image_saved` and `image_saved` events get (path, image,
    infotext) around the write. A PNG carries the infotext in a
    "parameters" text chunk under `enable_pnginfo`; `save_txt` writes it
    beside the image as `.txt`, and `save_write_log_csv` appends a row to
    the directory's `log.csv`. Another `samples_format` (jpg, webp, avif,
    gif) raises NotImplementedError before anything is written: the
    reference writes AVIF and GIF through Pillow and, where Pillow cannot,
    a PNG without the infotext under the other name's stem."""
    from ..runtime.options import opts
    from ..runtime.scripts import fire

    img = np.asarray(image, np.uint8)
    file_format = (file_format or str(opts.get("samples_format"))).lower()
    if file_format != "png":
        raise NotImplementedError(f"saving images as {file_format!r} is not ported to "
                                  f"forge_tpu_torch yet ({_ROADMAP_ENCODERS})")
    if path is None:
        if opts.get("save_to_dirs"):
            sub = apply_filename_pattern(str(opts.get("directories_filename_pattern"))
                                         or "[date]", seed=seed, prompt=prompt, **pattern_extra)
            outdir = os.path.join(outdir, sub)
        os.makedirs(outdir, exist_ok=True)
        pattern = filename_pattern or str(opts.get("samples_filename_pattern")
                                          or "[seed]-[prompt_spaces]")
        name = apply_filename_pattern(pattern, seed=seed, prompt=prompt, **pattern_extra)
        if opts.get("save_images_add_number"):
            existing = len([f for f in os.listdir(outdir) if f.split("-")[0].isdigit()])
            name = f"{existing:05d}-{name}"
        base = os.path.join(outdir, name)
        path = f"{base}.{file_format}"
        i = 1
        while os.path.exists(path):
            path = f"{base}-{i}.{file_format}"
            i += 1

    fire("before_image_saved", path, img, infotext)
    text = {"parameters": infotext} if infotext and opts.get("enable_pnginfo") else None
    data = encode_png(img, text)
    with open(path, "wb") as f:
        f.write(data)
    if infotext and opts.get("save_txt"):
        with open(os.path.splitext(path)[0] + ".txt", "w", encoding="utf8") as f:
            f.write(infotext + "\n")
    if opts.get("save_write_log_csv") and infotext:
        _append_log_csv(os.path.dirname(path), path, prompt, seed, infotext)
    fire("image_saved", path, img, infotext)
    return path


def _append_log_csv(dirname: str, path: str, prompt: str, seed: int, infotext: str) -> None:
    """A row (filename, prompt, seed, infotext with its newlines as " | ") of
    the `log.csv` beside the saved images, its header first."""
    import csv

    log = os.path.join(dirname, "log.csv")
    new = not os.path.exists(log)
    try:
        with open(log, "a", newline="", encoding="utf8") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["filename", "prompt", "seed", "infotext"])
            w.writerow([os.path.basename(path), prompt, seed, infotext.replace("\n", " | ")])
    except OSError:
        pass


def read_infotext(source) -> Optional[str]:
    """A PNG file's path or bytes → its "parameters" text, or None."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    return decode_png(data)[1].get("parameters")


_INVALID_FN = re.compile(r'[\\/:*?"<>|\n\r]')


def apply_filename_pattern(pattern: str, seed: int = 0, prompt: str = "", **extra) -> str:
    """The reference's filename tokens replaced in `pattern`: [seed],
    [seed_first], [prompt_spaces], [prompt], [prompt_no_styles],
    [prompt_words] (the first `directories_max_prompt_words` words),
    [prompt_hash], [date], [datetime], [job_timestamp], [width], [height],
    [model_name], [model_hash], [sampler], [sampler_scheduler], [steps],
    [cfg], [denoising], [clip_skip], [batch_number], [generation_number],
    [user], [image_hash], [none] and [styles] (empty); the result stripped of
    "-", "_" and spaces at its ends, or the seed where nothing is left."""
    import hashlib

    from ..runtime.options import opts

    now = datetime.datetime.now()
    words = _INVALID_FN.sub("", prompt)[:120]
    max_words = int(opts.get("directories_max_prompt_words"))
    prompt_words = "_".join(words.split()[:max_words]) or "empty"
    repl = {
        "[seed]": str(seed),
        "[seed_first]": str(extra.get("seed_first", seed)),
        "[prompt_spaces]": words,
        "[prompt]": words.replace(" ", "_"),
        "[prompt_no_styles]": words.replace(" ", "_"),
        "[prompt_words]": prompt_words,
        "[prompt_hash]": hashlib.sha256(prompt.encode()).hexdigest()[:8],
        "[date]": now.strftime("%Y-%m-%d"),
        "[datetime]": now.strftime("%Y%m%d%H%M%S"),
        "[job_timestamp]": str(extra.get("job_timestamp", now.strftime("%Y%m%d%H%M%S"))),
    }
    for token in ("width", "height", "model_name", "model_hash", "sampler", "sampler_scheduler",
                  "steps", "cfg", "denoising", "clip_skip", "batch_number", "generation_number",
                  "user", "image_hash"):
        repl[f"[{token}]"] = str(extra.get(token, ""))
    repl.update({"[none]": "", "[styles]": ""})
    out = pattern
    for k, v in repl.items():
        out = out.replace(k, v)
    return out.strip("-_ ") or str(seed)

"""Image resizing for img2img (port of forge_tpu/pipeline/images.py
`resize_init_image`), CLIP-vision preprocessing, regional prompt masks and
the simple upscalers.

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
"""

from __future__ import annotations

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
    """One 8-bit pass of Pillow's resampler along `axis` of a uint8 array."""
    n_in = img.shape[axis]
    xmin, k = _coefficients(n_in, n_out, kind)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    extra = (1,) * (src.ndim - 1)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, n_in - 1)  # a zero tap past the edge reads any pixel
        acc += k[:, t].reshape((n_out,) + extra) * src[idx]
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

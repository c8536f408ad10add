"""OpenCV's image calls that the annotators make, rebuilt in numpy.

The port never imports cv2; the ControlNet annotators of the reference call
it for their resizes, colour conversions, thresholds and drawings. Each
function here follows OpenCV's own arithmetic (its fixed-point weights, its
rounding and its integer rasterizers), so that on uint8 images it gives
what cv2 gives, byte for byte:

  * `resize`: INTER_NEAREST, INTER_LINEAR (pipeline/images.py
    `cv2_linear_resize`), INTER_AREA, INTER_CUBIC and INTER_LANCZOS4, on
    uint8 and float32 images of any channel count;
  * `rgb_to_gray`, `bgr_to_hsv` and `bgr_to_lab` (pipeline/images.py
    `rgb_to_lab`): cv2.cvtColor's RGB2GRAY, BGR2HSV and BGR2LAB;
  * `threshold`: THRESH_BINARY_INV, with or without THRESH_OTSU;
  * `line` (thickness 1 and more), `circle` (filled), `ellipse2poly` and
    `fill_convex_poly`, all at LINE_8 with no sub-pixel shift, in place;
  * `gaussian_blur` (cv2.GaussianBlur: uint8 at ksize (5, 5) and σ 0 in
    OpenCV's fixed point, float32 at ksize (0, 0) from σ) and `laplacian`
    (cv2.Laplacian to CV_32F, aperture 1), both with BORDER_REFLECT_101;
  * `apply_color_map`: cv2.applyColorMap with COLORMAP_VIRIDIS or
    COLORMAP_PARULA, over OpenCV's two 256-entry tables.

Float32 resizes follow the same taps and weights in float32; OpenCV's
vector code may fuse or reorder a product and a sum, so a float32 result
may differ from cv2's in its last bits (tests/test_torch_cv2_np.py states
the bound). What is rebuilt is OpenCV's own code: a cv2 built with Intel
IPP hands INTER_CUBIC on 1–4 channels to IPP's kernel while IPP is on (its
default), which rounds some pixels one level apart; with
`cv2.ipp.setUseIPP(False)` cv2 runs OpenCV's code.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from ..pipeline.images import cv2_linear_resample, cv2_linear_resize, rgb_to_lab

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = 0, 1, 2, 3, 4
THRESH_BINARY_INV, THRESH_OTSU = 1, 8
_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE
_F32 = np.float32


def _cv_round(v) -> np.ndarray:
    """cvRound: to the nearest integer, halves to even."""
    return np.rint(v).astype(np.int64)


# -- resize --------------------------------------------------------------------


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    ifx = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64), n_in - 1)


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """interpolateCubic (A = −0.75), float32 → [n, 4]."""
    a = _F32(-0.75)
    x = x.astype(_F32)
    x1 = x + _F32(1)
    c0 = ((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1 - _F32(4) * a
    c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + _F32(1)
    ox = _F32(1) - x
    c2 = ((a + _F32(2)) * ox - (a + _F32(3))) * ox * ox + _F32(1)
    c3 = _F32(1) - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1).astype(_F32)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1),
               (-_S45, _S45))


def _lanczos4_coeffs(x: np.ndarray) -> np.ndarray:
    """interpolateLanczos4, float32 → [n, 8]."""
    out = np.zeros(x.shape + (8,), _F32)
    for n, xv in enumerate(x.astype(_F32)):
        y0 = -(float(xv) + 3) * math.pi * 0.25
        s0, c0 = math.sin(y0), math.cos(y0)
        total = _F32(0)
        for i in range(8):
            y0_ = _F32(xv + _F32(3 - i))
            if abs(y0_) >= _F32(1e-6):
                y = -float(y0_) * math.pi * 0.25
                out[n, i] = _F32((_LANCZOS_CS[i][0] * s0 + _LANCZOS_CS[i][1] * c0) / (y * y))
            else:
                out[n, i] = _F32(1e30)
            total = _F32(total + out[n, i])
        out[n] *= _F32(1) / total
    return out


def _kernel_taps(n_in: int, n_out: int, ksize: int, coeffs):
    """Source indices [n_out, ksize] (replicated at the edges) and float32
    weights of each output along one axis, from the centre
    float((i + 0.5)·scale − 0.5)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(_F32)).astype(_F32)
    idx = s[:, None] + np.arange(ksize)[None, :] - (ksize // 2 - 1)
    return np.clip(idx, 0, n_in - 1), coeffs(frac)


def _resize_kernel(a: np.ndarray, w: int, h: int, ksize: int, coeffs) -> np.ndarray:
    """INTER_CUBIC / INTER_LANCZOS4: the horizontal pass, then the vertical.
    uint8: weights rounded to 11 bits, sums in integers; the vertical sum of
    cubic's vector code is float32 (rounded, halves to even) on each full
    16-byte group of a row, fixed point (+2^21, >> 22) on the rest."""
    src_h, src_w = a.shape[:2]
    sx, ax = _kernel_taps(src_w, w, ksize, coeffs)
    sy, ay = _kernel_taps(src_h, h, ksize, coeffs)
    src = a.reshape(src_h, src_w, -1)
    if a.dtype == np.uint8:
        iax, iay = _cv_round(ax * _F32(_COEF_SCALE)), _cv_round(ay * _F32(_COEF_SCALE))
        s64 = src.astype(np.int64)
        rows = sum(s64[:, sx[:, k]] * iax[None, :, k, None] for k in range(ksize))  # [H, w, C]
        fixed = sum(rows[sy[:, k]] * iay[:, k, None, None] for k in range(ksize))
        out = (fixed + (1 << 21)) >> 22
        if ksize == 4:
            flat_w = w * src.shape[2]
            vec = (flat_w // 16) * 16
            if vec:
                scale = _F32(1.0 / (_COEF_SCALE * _COEF_SCALE))
                b = (iay.astype(_F32) * scale).astype(_F32)
                r = rows.reshape(src_h, flat_w)[:, :vec].astype(_F32)
                acc = (r[sy[:, 3]] * b[:, 3, None]).astype(_F32)
                for k in (2, 1, 0):
                    acc = (r[sy[:, k]] * b[:, k, None] + acc).astype(_F32)
                flat = out.reshape(h, flat_w)
                flat[:, :vec] = np.rint(acc).astype(np.int64)
                out = flat.reshape(out.shape)
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        x = src.astype(_F32)
        rows = x[:, sx[:, 0]] * ax[None, :, 0, None]
        for k in range(1, ksize):
            rows = (rows + x[:, sx[:, k]] * ax[None, :, k, None]).astype(_F32)
        out = rows[sy[:, 0]] * ay[:, 0, None, None]
        for k in range(1, ksize):
            out = (out + rows[sy[:, k]] * ay[:, k, None, None]).astype(_F32)
    return out.reshape((h, w) + a.shape[2:])


def _area_tab(n_in: int, n_out: int, scale: float):
    """computeResizeAreaTab → (destination, source, float32 weight) triples."""
    di, si, alpha = [], [], []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.array(di), np.array(si), np.array(alpha, np.float64).astype(_F32)


def _resize_area_down(a: np.ndarray, w: int, h: int) -> np.ndarray:
    """OpenCV's resizeArea_: float32 sums of the source cells' overlap, the
    horizontal taps of a row in table order, then the rows."""
    src_h, src_w = a.shape[:2]
    src = a.reshape(src_h, src_w, -1).astype(_F32)
    xd, xs, xa = _area_tab(src_w, w, 1.0 / (w / src_w))
    yd, ys, ya = _area_tab(src_h, h, 1.0 / (h / src_h))
    # the k-th tap of each destination column, in table order
    xpos = np.arange(len(xd)) - np.searchsorted(xd, xd)
    buf = np.zeros((src_h, w, src.shape[2]), _F32)
    for t in range(int(xpos.max()) + 1):
        sel = xpos == t
        buf[:, xd[sel]] = (buf[:, xd[sel]] + src[:, xs[sel]] * xa[sel][None, :, None]).astype(_F32)
    ypos = np.arange(len(yd)) - np.searchsorted(yd, yd)
    out = np.zeros((h, w, src.shape[2]), _F32)
    for t in range(int(ypos.max()) + 1):
        sel = ypos == t
        out[yd[sel]] = (out[yd[sel]] + buf[ys[sel]] * ya[sel][:, None, None]).astype(_F32)
    if a.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((h, w) + a.shape[2:])


def _resize_area_fast(a: np.ndarray, w: int, h: int, sx: int, sy: int) -> np.ndarray:
    """Integer factors: each cell's sum times 1/area (float32), rounded."""
    if a.dtype == np.uint8 and (sx, sy) == (2, 2):
        return cv2_linear_resize(a, w, h)  # OpenCV's 2×2 average, (a + b + c + d + 2) >> 2
    src = a.reshape(a.shape[0], a.shape[1], -1)
    cells = src[:h * sy, :w * sx].reshape(h, sy, w, sx, -1)
    if a.dtype == np.uint8:
        total = cells.astype(np.int64).sum(axis=(1, 3)).astype(_F32)
        out = np.clip(np.rint(total * _F32(1.0 / (sx * sy))), 0, 255).astype(np.uint8)
    else:
        total = cells.astype(_F32).transpose(0, 2, 4, 1, 3).reshape(h, w, -1, sx * sy)
        acc = np.zeros(total.shape[:3], _F32)
        for k in range(sx * sy):
            acc = (acc + total[..., k]).astype(_F32)
        out = (acc * _F32(1.0 / (sx * sy))).astype(_F32)
    return out.reshape((h, w) + a.shape[2:])


def _area_up_taps(n_in: int, n_out: int):
    """INTER_AREA upscaled: linear taps with sx = ⌊i·scale⌋ and the weight
    (i + 1) − (sx + 1)/scale, its fraction."""
    scale = 1.0 / (n_out / n_in)
    inv = n_out / n_in
    s = np.floor(np.arange(n_out) * scale).astype(np.int64)
    f = ((np.arange(n_out) + 1) - (s + 1) * inv).astype(_F32)
    f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(_F32)
    return s, f


def resize(img: np.ndarray, dsize: Tuple[int, int], interpolation: int = INTER_LINEAR
           ) -> np.ndarray:
    """`cv2.resize(img, dsize=(w, h), interpolation=...)` on a uint8 or
    float32 [H,W] or [H,W,C] array."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize takes uint8 or float32, not {a.dtype}")
    w, h = int(dsize[0]), int(dsize[1])
    src_h, src_w = a.shape[:2]
    if (src_w, src_h) == (w, h):
        return a.copy()
    if interpolation == INTER_LINEAR:
        return cv2_linear_resize(a, w, h)
    if interpolation == INTER_NEAREST:
        return a[_nearest_index(src_h, h)][:, _nearest_index(src_w, w)]
    if interpolation == INTER_CUBIC:
        return _resize_kernel(a, w, h, 4, _cubic_coeffs)
    if interpolation == INTER_LANCZOS4:
        return _resize_kernel(a, w, h, 8, _lanczos4_coeffs)
    if interpolation == INTER_AREA:
        scale_x, scale_y = 1.0 / (w / src_w), 1.0 / (h / src_h)
        if scale_x >= 1 and scale_y >= 1:
            ix, iy = int(round(scale_x)), int(round(scale_y))
            if abs(scale_x - ix) < np.finfo(np.float64).eps and \
                    abs(scale_y - iy) < np.finfo(np.float64).eps:
                return _resize_area_fast(a, w, h, ix, iy)
            return _resize_area_down(a, w, h)
        return cv2_linear_resample(a, w, h, _area_up_taps(src_w, w), _area_up_taps(src_h, h))
    raise ValueError(f"resize: unsupported interpolation {interpolation}")


# -- colour --------------------------------------------------------------------


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)` on uint8: (9798·R + 19235·G +
    3735·B + 2^14) >> 15."""
    x = np.asarray(img, np.uint8).astype(np.int64)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << 12) / np.maximum(i, 1)), 0).astype(np.int64)
        hdiv = np.where(i > 0, np.rint((180 << 12) / (6.0 * np.maximum(i, 1))), 0).astype(np.int64)
    return sdiv, hdiv


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2HSV)` on uint8 (H in 0..179)."""
    x = np.asarray(img, np.uint8).astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    sdiv, hdiv = _hsv_tables()
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def bgr_to_lab(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2LAB)` on uint8."""
    return rgb_to_lab(np.asarray(img)[..., ::-1])


def otsu_threshold(gray: np.ndarray) -> float:
    """getThreshVal_Otsu_8u: the level that maximises the between-class variance."""
    hist = np.bincount(np.asarray(gray, np.uint8).ravel(), minlength=256)
    scale = 1.0 / gray.size
    mu = float(sum(i * float(hist[i]) for i in range(256))) * scale
    mu1 = q1 = max_sigma = max_val = 0.0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, float(i)
    return max_val


def threshold(gray: np.ndarray, thresh: float, maxval: float, kind: int):
    """`cv2.threshold` on uint8 for THRESH_BINARY_INV, + THRESH_OTSU →
    (the threshold, the map)."""
    if kind & ~THRESH_OTSU != THRESH_BINARY_INV:
        raise ValueError("threshold: only THRESH_BINARY_INV (+ THRESH_OTSU) is supported")
    g = np.asarray(gray, np.uint8)
    if kind & THRESH_OTSU:
        thresh = otsu_threshold(g)
    ithresh, imax = math.floor(thresh), int(np.clip(_cv_round(maxval), 0, 255))
    if ithresh < 0 or ithresh >= 255:
        return float(ithresh), np.full_like(g, imax if ithresh >= 255 else 0)
    return float(ithresh), np.where(g > ithresh, 0, imax).astype(np.uint8)


# -- drawing (LINE_8, no sub-pixel shift; in place) -------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """clipLine to [0, w−1] × [0, h−1] → (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """Line(): LineIterator at 8-connectivity, left to right, clipped."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    delta_x = delta_y = 1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    if dy < 0:
        dy, delta_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        delta_x, delta_y = delta_y, delta_x
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    minus_shift, plus_shift, minus_step, plus_step = delta_x, 0, 0, delta_y
    if vert:
        plus_step, plus_shift = plus_shift, plus_step
        minus_step, minus_shift = minus_shift, minus_step
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        mask = -1 if err < 0 else 0
        err += minus_delta + (plus_delta & mask)
        x += minus_shift + (plus_shift & mask)
        y += minus_step + (plus_step & mask)


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """Line2(): a line between points with 16 fractional bits."""
    h, w = img.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, *p1, *p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _XY_ONE, _trunc_div((dy << _XY_SHIFT), ax | 1)
        ecount = (x2 - x1) >> _XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _trunc_div((dx << _XY_SHIFT), ay | 1), _XY_ONE
        ecount = (y2 - y1) >> _XY_SHIFT
    x1 += _XY_ONE >> 1
    y1 += _XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (_XY_ONE >> 1)) >> _XY_SHIFT, (y2 + (_XY_ONE >> 1)) >> _XY_SHIFT)
    if ax > ay:
        x1 >>= _XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> _XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= _XY_SHIFT
        while ecount >= 0:
            put(x1 >> _XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _fill_convex(img: np.ndarray, pts: Sequence[Tuple[int, int]], color, shift: int) -> None:
    """FillConvexPoly at LINE_8 over points with `shift` fractional bits."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = 1 << shift >> 1
    delta1 = delta2 = _XY_ONE >> 1
    px, py = pts[-1][0] << (_XY_SHIFT - shift), pts[-1][1] << (_XY_SHIFT - shift)
    xmin = xmax = pts[0][0]
    ymin = ymax = pts[0][1]
    imin = 0
    for i, (vx, vy) in enumerate(pts):
        if vy < ymin:
            ymin, imin = vy, i
        ymax, xmax, xmin = max(ymax, vy), max(xmax, vx), min(xmin, vx)
        qx, qy = vx << (_XY_SHIFT - shift), vy << (_XY_SHIFT - shift)
        if shift == 0:
            _line8(img, (px >> _XY_SHIFT, py >> _XY_SHIFT), (qx >> _XY_SHIFT, qy >> _XY_SHIFT),
                   color)
        else:
            _line2(img, (px, py), (qx, qy), color)
        px, py = qx, qy
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    e_idx, e_di, e_x, e_dx = [imin, imin], [1, n - 1], [-_XY_ONE, -_XY_ONE], [0, 0]
    y = ymin
    e_ye = [y, y]
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0, di = e_idx[i], e_di[i]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs = pts[idx0][0] << (_XY_SHIFT - shift)
                        xe = pts[idx][0] << (_XY_SHIFT - shift)
                        e_ye[i] = ty
                        e_dx[i] = _trunc_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta1) >> _XY_SHIFT
            xx2 = (e_x[right] + delta2) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def fill_convex_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """`cv2.fillConvexPoly(img, pts, color)` (LINE_8, shift 0), in place."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    _fill_convex(img, pts, _color(img, color), 0)
    return img


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """Circle() with fill: the midpoint walk, one span per octant pair."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                _hline(img, y11, x11, x12, color)
            if 0 <= y12 < h:
                _hline(img, y12, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    _hline(img, y21, x21, x22, color)
                if 0 <= y22 < h:
                    _hline(img, y22, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _color(img: np.ndarray, color):
    c = np.asarray(color, np.float64).reshape(-1)
    channels = 1 if img.ndim == 2 else img.shape[2]
    c = np.concatenate([c, np.zeros(max(channels - len(c), 0))])[:channels]
    c = np.clip(np.rint(c), 0, 255).astype(img.dtype)
    return c[0] if img.ndim == 2 else c


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, thickness=-1)`: filled, in place."""
    if thickness >= 0:
        raise ValueError("circle: only filled circles (thickness < 0) are supported")
    _circle_filled(img, int(center[0]), int(center[1]), int(radius), _color(img, color))
    return img


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, pt1, pt2, color, thickness)` (LINE_8), in place."""
    col = _color(img, color)
    x0, y0 = int(pt1[0]), int(pt1[1])
    x1, y1 = int(pt2[0]), int(pt2[1])
    if thickness <= 1:
        _line8(img, (x0, y0), (x1, y1), col)
        return img
    # a thick line is first clipped to the image grown by its thickness on every side
    t = thickness
    ok, x0, y0, x1, y1 = _clip_line(img.shape[1] + 2 * t, img.shape[0] + 2 * t,
                                    x0 + t, y0 + t, x1 + t, y1 + t)
    if not ok:
        return img
    x0, y0, x1, y1 = x0 - t, y0 - t, x1 - t, y1 - t
    p0 = (x0 << _XY_SHIFT, y0 << _XY_SHIFT)
    p1 = (x1 << _XY_SHIFT, y1 << _XY_SHIFT)
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * _XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        poly = [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)]
        _fill_convex(img, poly, col, _XY_SHIFT)
    rad = (thick + (_XY_ONE >> 1)) >> _XY_SHIFT
    for px, py in (p0, p1):
        _circle_filled(img, (px + (_XY_ONE >> 1)) >> _XY_SHIFT,
                       (py + (_XY_ONE >> 1)) >> _XY_SHIFT, rad, col)
    return img


def _sin_table() -> np.ndarray:
    """OpenCV's SinTable: sin of 0..450 degrees to 7 decimals, float32."""
    deg = np.arange(451, dtype=np.float64)
    return np.round(np.sin(np.radians(deg)), 7).astype(_F32)


_SIN = _sin_table()


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int, delta: int
                 ) -> np.ndarray:
    """`cv2.ellipse2Poly` → int32 [N, 2]."""
    cx, cy = float(center[0]), float(center[1])
    aw, ah = float(axes[0]), float(axes[1])
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_end, arc_start = arc_end - 360, arc_start - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = float(_SIN[450 - angle]), float(_SIN[angle])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = aw * float(_SIN[450 - a])
        y = ah * float(_SIN[a])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    out, prev = [], None
    for px, py in pts:
        p = (int(np.rint(px)), int(np.rint(py)))
        if p != prev:
            out.append(p)
            prev = p
    if len(out) == 1:
        out = [(int(cx), int(cy))] * 2
    return np.asarray(out, np.int32).reshape(-1, 2)


# -- filters (BORDER_REFLECT_101, OpenCV's default) -----------------------------------


def _reflect101(a: np.ndarray, r: int) -> np.ndarray:
    """`a` [H,W(,C)] grown by r rows and columns on each side, mirrored
    without repeating the edge (BORDER_REFLECT_101)."""
    pad = ((r, r), (r, r)) + ((0, 0),) * (a.ndim - 2)
    return np.pad(a, pad, mode="reflect")


def _gaussian_taps(n: int, sigma: float) -> np.ndarray:
    """getGaussianKernel(n, σ, CV_32F): exp(−(i − (n−1)/2)² / 2σ²) normalized
    in double, then to float32; n ≤ 7 with σ ≤ 0 takes the fixed binomial taps."""
    if sigma <= 0 and n % 2 == 1 and n <= 7:
        return (np.asarray({1: [32], 3: [8, 16, 8], 5: [2, 8, 12, 8, 2],
                            7: [1, 3.5, 7, 9, 7, 3.5, 1]}[n]) / 32.0).astype(_F32)
    if sigma <= 0:
        sigma = ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(_F32)


def _sep_filter_f32(a: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """One symmetric kernel along rows then columns, each pass summed in
    float64 and stored in float32 (OpenCV's float32 row buffer); scipy's
    "mirror" border is BORDER_REFLECT_101."""
    from scipy.ndimage import correlate1d

    k = taps.astype(np.float64)
    rows = correlate1d(np.asarray(a, np.float64), k, axis=1, mode="mirror").astype(_F32)
    return correlate1d(rows.astype(np.float64), k, axis=0, mode="mirror").astype(_F32)


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int], sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, ksize, sigma)` on a uint8 image at ksize (5, 5)
    and σ 0 (OpenCV's bit-exact fixed point: taps 1 4 6 4 1 in 8 fractional
    bits, rounded half up), or on a float32 image at ksize (0, 0), whose
    size OpenCV takes from σ as round(8σ + 1) | 1."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        if tuple(ksize) != (5, 5) or sigma > 0:
            raise ValueError("gaussian_blur takes uint8 at ksize (5, 5) and sigma 0 only")
        k = np.asarray([1, 4, 6, 4, 1], np.int64)
        p = _reflect101(a.astype(np.int64), 2)
        h, w = a.shape[:2]
        rows = sum(k[i] * p[:, i:i + w] for i in range(5))
        total = sum(k[i] * rows[i:i + h] for i in range(5))
        return ((total + 128) >> 8).astype(np.uint8)
    if a.dtype != np.float32:
        raise ValueError(f"gaussian_blur takes uint8 or float32, not {a.dtype}")
    n = int(ksize[0])
    if n <= 0:
        n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    return _sep_filter_f32(a, _gaussian_taps(n, sigma))


def laplacian(img: np.ndarray) -> np.ndarray:
    """`cv2.Laplacian(img, cv2.CV_32F)` (aperture 1: the 4-neighbour kernel
    0 1 0 / 1 −4 1 / 0 1 0), exact on uint8 input."""
    p = _reflect101(np.asarray(img).astype(np.float64), 1)
    h, w = img.shape[:2]
    out = (p[:h, 1:w + 1] + p[2:, 1:w + 1] + p[1:h + 1, :w] + p[1:h + 1, 2:]
           - 4.0 * p[1:h + 1, 1:w + 1])
    return out.astype(_F32)


# -- colour maps -----------------------------------------------------------------
# OpenCV's COLORMAP_VIRIDIS and COLORMAP_PARULA (modules/imgproc/src/colormap.cpp): the
# 256-entry lookup tables cv2.applyColorMap builds from them, BGR, a row a grey level
_VIRIDIS_BGR = np.frombuffer(bytes.fromhex(
    "5401445602445704455905455a07465c08465d0a465e0b46600d47610e47631047641147651347671448681648"
    "6917486a18486c1a486d1b486e1c486f1d48701f48712048732148742348752448762548772648782848792948"
    "7a2a477a2c477b2d477c2e477d2f477e30467e32467f3346803446813545813745823845833944833a44843b44"
    "843d43853e43853f4286404286414287424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d"
    "8a4e3d8a4f3c8b503c8b513b8b523b8b533a8c543a8c55398c56398c58388c59388c5a378d5b378d5c368d5d36"
    "8d5e358d5f358d60348d61348d62338d63338e64328e65328e66318e67318e68318e69308e6a308e6b2f8e6c2f"
    "8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c8e722c8e732c8e742b8e752b8e762a8e772a8e782a8e79298e7a29"
    "8e7b298e7c288e7d288e7e278e7f278e80278e81268e82268e82268e83258e84258e85258e86248e87248e8823"
    "8e89238d8a238d8b228d8c228d8d228d8e218d8f218d90218c91218c92208c92208c93208c941f8b951f8b961f"
    "8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f88a01f88a11f87a11f87a21f86a32086a420"
    "85a52185a62185a72284a82283a92383aa2482ab2582ac2581ad2681ad2780ae287faf297fb02a7eb12c7db22d"
    "7cb32e7cb42f7bb5317ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d73bc3f72bd4071be4270bf44"
    "6fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c62c95e60ca605fcb63"
    "5ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d17751d17a50d27c4ed37f4dd3814bd48449d586"
    "48d58946d68b45d68e43d79041d79340d8953ed8983cd99b3bd99d39daa037daa236dba534dba832dcaa30dcad"
    "2fddb02dddb22bdeb529deb828deba26dfbd25dfc023dfc221e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d5"
    "19e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef1de5f11ee6f420e6f621e6f823e7fb"
    "25e7fd"
), np.uint8).reshape(256, 3)
_PARULA_BGR = np.frombuffer(bytes.fromhex(
    "872a358a2c338d2e328f2f3092312f95332d98352c9b372a9e3828a03a27a33c25a63e24a93f22ac4121af431f"
    "b1451db4471cb7481aba4a19bd4c17bf4e16c25014c55112c85311cb550fce570ed0580cd35a0bd65c09d95e08"
    "dc6006df6104e16303e16404e06504e06605df6705df6806df6a06de6b07de6c07dd6d08dd6e08dc6f09dc7009"
    "dc710adb720bdb730bda740cda750cda760dd9770dd9780ed87a0ed87b0fd87c0fd77d10d77e10d67f11d68011"
    "d68112d58213d58313d48414d48514d38613d38713d38813d28a12d28b12d18c11d18d11d08e10d08f10d0900f"
    "cf910fcf920fce930ece940ecd950dcd960dcc970ccc980ccc9a0ccb9b0bcb9c0bca9d0aca9e0ac99f09c9a009"
    "c8a108c8a208c8a308c7a407c7a507c6a606c6a707c4a808c3a80ac2a90bc1a90dbfaa0ebeab10bdab12bbac13"
    "baac15b9ad16b8ad18b6ae19b5af1bb4af1db3b01eb1b020b0b121afb123aeb224acb326abb328aab429a9b42b"
    "a7b52ca6b52ea5b62fa4b631a2b733a1b834a0b8369fb9379db9399cb93c9bb93f99ba4298ba4597ba4895ba4a"
    "94ba4d93bb5091bb5390bb568ebb588dbb5b8cbc5e8abc6189bc6488bc6786bc6985bc6c84bd6f82bd7281bd75"
    "80bd787ebd7a7dbe7d7cbe807abe8379be8678be8876bf8b75bf8e74bf9172bf9372bf9671bf9870be9a6fbe9c"
    "6ebe9f6dbea16cbea36bbea56abda769bdaa68bdac68bdae67bdb066bdb365bdb564bcb763bcb962bcbb61bcbe"
    "60bcc05fbcc25ebbc45ebbc75dbbc95cbbcb5bbbcd5abbd059bbd258bad457bad656bad855bada54bbdb53bcdc"
    "51bcdd50bdde4fbedf4ebee04cbfe24bbfe34ac0e449c1e547c1e646c2e745c3e843c3e942c4ea41c5eb40c5ec"
    "3ec6ee3dc6ef3cc7f03bc8f139c8f238c9f337caf436caf534cbf633cbf732ccf931cdfa2fcdfb2ecefc2dcffc"
    "2cd1fc2bd2fc2ad3fc29d5fc28d6fb27d8fb26d9fb25dbfb24dcfb23ddfb22dffb21e0fb20e2fb1fe3fb1ee4fb"
    "1de6fa1ce7fa1be9fa1aeafa19ebfa18edfa17eefa16f0fa15f1fa14f3fa13f4f912f5f911f7f910f8f90ffaf9"
    "0efbf9"
), np.uint8).reshape(256, 3)
COLORMAP_VIRIDIS, COLORMAP_PARULA = "viridis", "parula"
_COLOR_MAPS = {COLORMAP_VIRIDIS: _VIRIDIS_BGR, COLORMAP_PARULA: _PARULA_BGR}


def apply_color_map(gray: np.ndarray, name: str) -> np.ndarray:
    """`cv2.applyColorMap(gray, cv2.COLORMAP_<NAME>)` on a uint8 [H,W] image →
    uint8 [H,W,3], BGR as OpenCV gives it; `name` "viridis" or "parula"."""
    a = np.asarray(gray)
    if a.dtype != np.uint8:
        raise ValueError(f"apply_color_map takes uint8, not {a.dtype}")
    return _COLOR_MAPS[name][a]

# Copied from forge_tpu/preprocessors/cv.py (all of it); numpy only.
"""Pure-numpy image helpers for the ControlNet hints: the preprocessors'
bilinear resize (`resize_image`: the short side to a resolution, both sides
multiples of 8), Canny edges, the Gaussian blur, standard lineart, XDoG
scribbles, the binarization and the content shuffle (the reference leans on
cv2; numpy needs no other package on the card's machine). Runs on the host
once a request."""

from __future__ import annotations

import numpy as np


def resize_image(img: np.ndarray, res: int) -> np.ndarray:
    """Resize so the SHORT side == res (reference HWC3+resize semantics),
    rounding dims to multiples of 8. Bilinear, channel-last."""
    h, w = img.shape[:2]
    if res <= 0:
        return img
    k = res / min(h, w)
    nh = int(np.round(h * k / 8.0)) * 8
    nw = int(np.round(w * k / 8.0)) * 8
    return bilinear_resize(img, max(nh, 8), max(nw, 8))


def bilinear_resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    h, w = img.shape[:2]
    if (h, w) == (nh, nw):
        return img
    dtype = img.dtype
    arr = img.astype(np.float32)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    out = (arr[y0][:, x0] * (1 - wy) * (1 - wx) + arr[y0][:, x1] * (1 - wy) * wx
           + arr[y1][:, x0] * wy * (1 - wx) + arr[y1][:, x1] * wy * wx)
    if squeeze:
        out = out[..., 0]
    if np.issubdtype(dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return out.astype(dtype)


def to_gray(img: np.ndarray) -> np.ndarray:
    f = img.astype(np.float32)
    if f.ndim == 3:
        f = f @ np.asarray([0.299, 0.587, 0.114], np.float32)
    if img.dtype == np.uint8:
        f = f / 255.0
    return f


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = max(int(np.ceil(3 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _conv1d(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    pad = len(k) // 2
    padding = [(0, 0)] * img.ndim
    padding[axis] = (pad, pad)
    padded = np.pad(img, padding, mode="edge")
    out = np.zeros_like(img, np.float32)
    sl = [slice(None)] * img.ndim
    for i, kv in enumerate(k):
        sl[axis] = slice(i, i + img.shape[axis])
        out += kv * padded[tuple(sl)]
    return out


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.astype(np.float32)
    k = _gauss_kernel1d(sigma)
    return _conv1d(_conv1d(img.astype(np.float32), k, 0), k, 1)


def sobel(gray: np.ndarray):
    """→ (gx, gy) with the standard 3×3 Sobel kernels."""
    p = np.pad(gray, 1, mode="edge")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[:-2, 1:-1] - p[:-2, 2:])
    return gx, gy


def canny(img: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Classic Canny (gauss → sobel → NMS → hysteresis), matching cv2.Canny's
    8-bit threshold convention. → float32 [H,W] edges in {0,1}."""
    gray = to_gray(img) * 255.0
    smoothed = gaussian_blur(gray, 1.4)
    gx, gy = sobel(smoothed)
    mag = np.abs(gx) + np.abs(gy)  # cv2 default L1 norm
    ang = np.arctan2(gy, gx)

    # non-maximum suppression: quantize gradient direction to 4 sectors
    q = ((np.round(ang / (np.pi / 4)).astype(np.int32)) % 4)
    padded = np.pad(mag, 1, mode="constant")
    c = padded[1:-1, 1:-1]
    neighbors = {
        0: (padded[1:-1, 2:], padded[1:-1, :-2]),    # E/W
        1: (padded[2:, 2:], padded[:-2, :-2]),        # NE/SW
        2: (padded[2:, 1:-1], padded[:-2, 1:-1]),     # N/S
        3: (padded[2:, :-2], padded[:-2, 2:]),        # NW/SE
    }
    keep = np.zeros_like(c, bool)
    for sector, (n1, n2) in neighbors.items():
        m = q == sector
        keep |= m & (c >= n1) & (c >= n2)
    nms = np.where(keep, c, 0.0)

    strong = nms >= high
    weak = (nms >= low) & ~strong
    # hysteresis: BFS from strong pixels through weak ones
    edges = strong.copy()
    frontier = strong
    for _ in range(512):  # bounded flood fill
        p = np.pad(frontier, 1)
        grown = (p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:] | p[1:-1, :-2]
                 | p[1:-1, 2:] | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:])
        new = grown & weak & ~edges
        if not new.any():
            break
        edges |= new
        frontier = new
    return edges.astype(np.float32)


def lineart_standard(img: np.ndarray, sigma: float = 6.0) -> np.ndarray:
    """'lineart_standard (from white bg & black line)': intensity minus its
    gaussian blur, inverted — extracts dark lines from light backgrounds."""
    g = to_gray(img)
    blurred = gaussian_blur(g, sigma)
    lines = np.clip(blurred - g, 0, 1)
    mx = lines.max()
    return lines / mx if mx > 1e-6 else lines


def scribble_xdog(img: np.ndarray, threshold: float = 32.0) -> np.ndarray:
    """XDoG scribble: difference-of-gaussians, thresholded."""
    g = to_gray(img) * 255.0
    g1 = gaussian_blur(g, 0.5)
    g2 = gaussian_blur(g, 5.0)
    dog = (1 + 0.98) * g1 - 0.98 * g2
    return (dog > threshold).astype(np.float32)


def threshold_map(img: np.ndarray, thr: float = 127.0) -> np.ndarray:
    return (to_gray(img) * 255.0 > thr).astype(np.float32)


def shuffle_map(img: np.ndarray, seed: int = 0) -> np.ndarray:
    """Content shuffle: smooth random flow-field warp (reference
    content shuffle annotator)."""
    h, w = img.shape[:2]
    r = np.random.default_rng(seed)
    fx = gaussian_blur(r.standard_normal((h, w)).astype(np.float32), 12.0)
    fy = gaussian_blur(r.standard_normal((h, w)).astype(np.float32), 12.0)
    scale = 0.25 * min(h, w)
    for f in (fx, fy):
        mx = np.abs(f).max()
        if mx > 1e-6:
            f *= scale / mx
    ys = np.clip(np.arange(h)[:, None] + fy, 0, h - 1).astype(np.int64)
    xs = np.clip(np.arange(w)[None, :] + fx, 0, w - 1).astype(np.int64)
    return img[ys, xs].astype(np.float32)

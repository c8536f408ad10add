# Copied from forge_tpu/preprocessors/cv.py (`canny` and its helpers); numpy only.
"""Pure-numpy Canny edges for the ControlNet-canny hint (the reference leans
on cv2; a numpy reimplementation needs no other package on the card's
machine). Runs on the host once a request."""

from __future__ import annotations

import numpy as np


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

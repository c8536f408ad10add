# Copied from forge_tpu/postprocessing/focal_crop.py (_edge_map, _entropy_map, focal_point, focal_crop); OpenCV's GaussianBlur, Laplacian and RGB2GRAY through preprocessors/cv2_np.py.
"""Auto focal-point crop (reference scripts/postprocessing_focal_crop.py →
modules/textual_inversion/autocrop.py): the crop window that covers the
image's most interesting region, scored by a weighted sum of edge density,
local entropy and face detections.

The face term: the reference takes it from OpenCV's Haar cascade data
(`cv2.data.haarcascades`) and leaves it out where that file is absent,
which it is wherever the reference runs here. The port has no OpenCV, so
its face term is always left out (`_face_map` returns None), as the
reference's is in practice; a detector of its own comes with the face
detection of ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..preprocessors import cv2_np


def _edge_map(gray: np.ndarray) -> np.ndarray:
    lap = np.abs(cv2_np.laplacian(cv2_np.gaussian_blur(gray, (5, 5), 0)))
    return lap / max(float(lap.max()), 1e-6)


def _entropy_map(gray: np.ndarray, block: int = 32) -> np.ndarray:
    h, w = gray.shape
    out = np.zeros((h, w), np.float32)
    for y in range(0, h, block):
        for x in range(0, w, block):
            tile = gray[y:y + block, x:x + block]
            hist, _ = np.histogram(tile, bins=32, range=(0, 255))
            p = hist / max(tile.size, 1)
            p = p[p > 0]
            out[y:y + block, x:x + block] = float(-(p * np.log2(p)).sum())
    return out / max(float(out.max()), 1e-6)


def _face_map(img: np.ndarray) -> Optional[np.ndarray]:
    """The faces' boxes as a 0/1 map; None: no detector (see the module)."""
    return None


def focal_point(img: np.ndarray, face_weight: float = 0.9, entropy_weight: float = 0.15,
                edges_weight: float = 0.5) -> Tuple[int, int]:
    """→ (cx, cy) of the strongest weighted region."""
    gray = cv2_np.rgb_to_gray(img)
    score = edges_weight * _edge_map(gray) + entropy_weight * _entropy_map(gray)
    fm = _face_map(img)
    if fm is not None:
        score = score + face_weight * fm
    # blurred, so that the argmax is a region's centre and not one hot pixel
    score = cv2_np.gaussian_blur(score.astype(np.float32), (0, 0),
                                 max(min(img.shape[:2]) / 16, 1))
    cy, cx = np.unravel_index(int(np.argmax(score)), score.shape)
    return int(cx), int(cy)


def focal_crop(img: np.ndarray, tw: int, th: int, face_weight: float = 0.9,
               entropy_weight: float = 0.15, edges_weight: float = 0.5) -> np.ndarray:
    """A tw×th crop around the focal point (clamped to the image)."""
    h, w = img.shape[:2]
    tw, th = min(tw, w), min(th, h)
    cx, cy = focal_point(img, face_weight, entropy_weight, edges_weight)
    left = int(np.clip(cx - tw // 2, 0, w - tw))
    top = int(np.clip(cy - th // 2, 0, h - th))
    return img[top:top + th, left:left + tw]

# Copied from forge_tpu/pipeline/masking.py; `resize_image` uses the port's Lanczos (pipeline/images.py) for PIL's.
"""Inpaint mask geometry: crop-region computation for "only masked" mode.

Behavioral port of modules/masking.py (get_crop_region_v2 + expand_crop_region):
find the mask's bounding box, pad it, then expand to the processing aspect
ratio so the crop upscales cleanly to the target resolution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .images import lanczos_resize

Region = Tuple[int, int, int, int]  # x1, y1, x2, y2


def get_crop_region(mask: np.ndarray, pad: int = 0) -> Optional[Region]:
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    if len(xs) == 0:
        return None
    h, w = mask.shape[:2]
    x1 = max(int(xs.min()) - pad, 0)
    y1 = max(int(ys.min()) - pad, 0)
    x2 = min(int(xs.max()) + 1 + pad, w)
    y2 = min(int(ys.max()) + 1 + pad, h)
    return (x1, y1, x2, y2)


def expand_crop_region(region: Region, processing_width: int, processing_height: int,
                       image_width: int, image_height: int) -> Region:
    """Grow the box to the target aspect ratio, staying inside the image."""
    x1, y1, x2, y2 = region
    ratio_crop = (x2 - x1) / max(y2 - y1, 1)
    ratio_proc = processing_width / processing_height

    if ratio_crop > ratio_proc:
        desired_h = round((x2 - x1) / ratio_proc)
        diff = desired_h - (y2 - y1)
        y1 -= diff // 2
        y2 += diff - diff // 2
        if y2 > image_height:
            y1 -= y2 - image_height
            y2 = image_height
        if y1 < 0:
            y2 = min(y2 - y1, image_height)
            y1 = 0
    else:
        desired_w = round((y2 - y1) * ratio_proc)
        diff = desired_w - (x2 - x1)
        x1 -= diff // 2
        x2 += diff - diff // 2
        if x2 > image_width:
            x1 -= x2 - image_width
            x2 = image_width
        if x1 < 0:
            x2 = min(x2 - x1, image_width)
            x1 = 0

    return (int(x1), int(y1), int(x2), int(y2))


def resize_image(img: np.ndarray, w: int, h: int) -> np.ndarray:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return lanczos_resize(arr, w, h)

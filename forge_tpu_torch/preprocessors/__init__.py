"""The ControlNet preprocessor (annotator) registry (port of
forge_tpu/preprocessors/__init__.py).

Every name, alias, slider, tag and default resolution the reference
registers, in its order: its pure-CV annotators, the reference, Revision
and inpaint entries, and the model-based annotators its submodules register
when it is imported (depth, openpose, HED, lineart, PiDiNet, MLSD, Depth
Anything, TEED, manga line, LeReS, DWPose, anime face, NormalBAE,
MediaPipe face, UniFormer, ZoeDepth, Marigold, DensePose, OneFormer).
`preprocessor_names()` lists each entry once, under its first name
(GET /controlnet/module_list).

Ported (`Preprocessor.ported`): the pure-CV entries (preprocessors/cv.py,
their OpenCV calls through preprocessors/cv2_np.py); the reference,
Revision and inpaint entries, which extensions/controlnet.py consumes by
their tags and which pass the image through as the reference's do; and the
model-based annotators depth_midas (depth.py), depth_anything_v2
(depth_anything.py), the five OpenPose entries (openpose.py), the HED
(hed.py), PiDiNet (pidinet.py) and TEED (teed.py) soft edges, the three
lineart nets (lineart.py), lineart_anime_denoise (manga_line.py), mlsd
(mlsd.py), normalbae (normalbae.py), depth_leres (leres.py), depth_zoe
(zoe.py), depth_marigold (marigold.py), seg_ufade20k (uniformer.py),
seg_anime_face (anime_face.py), inpaint_only+lama (lama.py: the entry
passes the image through; the unit's path runs the LaMa pre-fill),
mediapipe_face (mediapipe_face.py, which raises the reference's
RuntimeError: mediapipe is not there to import), both DensePose entries
(densepose.py) and seg_ofade20k and seg_ofcoco (oneformer.py): all but
dw_openpose_full. Each model-based module is imported
on the entry's first call; its detector runs on the card unless one made
on the CPU is installed (`get_*(device=...)`). This registry alone decides
which ControlNet modules run: calling any other entry raises
NotImplementedError naming ROADMAP queue 1 item 9, and a unit with such a
module is refused before it is built.

Contract: __call__(img uint8 [H,W,3], res, threshold_a, threshold_b) →
float32 map [H,W,3] in [0, 1] at the detect resolution (the caller resizes
it to the generation size).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

import importlib

from . import cv2_np
from .cv import (canny, gaussian_blur, lineart_standard, resize_image, scribble_xdog, shuffle_map,
                 threshold_map)

_ROADMAP_9 = "ROADMAP.md queue 1 item 9: the preprocessors"


@dataclasses.dataclass
class Preprocessor:
    name: str
    call: Callable  # (img u8 [H,W,3], res, a, b) → f32 [h,w,3] in [0,1]
    slider_a: Optional[tuple] = None  # (label, min, max, default)
    slider_b: Optional[tuple] = None
    resolution_default: int = 512
    tags: tuple = ()
    needs_weights: bool = False  # a model-based annotator
    ported: bool = True  # False: `call` raises NotImplementedError (item 9)

    def __call__(self, img: np.ndarray, res: int = 512,
                 threshold_a: float = 0.0, threshold_b: float = 0.0) -> np.ndarray:
        return self.call(img, res, threshold_a, threshold_b)


PREPROCESSORS: Dict[str, Preprocessor] = {}


def register(p: Preprocessor, aliases=()) -> Preprocessor:
    PREPROCESSORS[p.name] = p
    for a in aliases:
        PREPROCESSORS[a] = p
    return p


def get_preprocessor(name: str) -> Preprocessor:
    if name in PREPROCESSORS:
        return PREPROCESSORS[name]
    low = name.lower().replace(" ", "_")
    for key, p in PREPROCESSORS.items():
        if key.lower().replace(" ", "_") == low:
            return p
    raise KeyError(f"unknown preprocessor {name!r}")


def preprocessor_names():
    seen, out = set(), []
    for name, p in PREPROCESSORS.items():
        if id(p) not in seen:
            seen.add(id(p))
            out.append(name)
    return out


def _none(img: np.ndarray, res: int, a, b) -> np.ndarray:
    return np.asarray(resize_image(img, res), np.float32) / 255.0


def _to_float(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0 if img.dtype == np.uint8 \
        else np.asarray(img, np.float32)


def _gray3(g: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(g, np.float32)[..., None], 3, axis=2)


def _canny(img: np.ndarray, res: int, a, b) -> np.ndarray:
    edges = canny(resize_image(img, res), int(a) if a else 100, int(b) if b else 200)
    return np.repeat(edges[..., None], 3, axis=2)


def _invert(img, res, a, b):
    return 1.0 - _to_float(resize_image(img, res))


def _blur(img, res, a, b):
    return gaussian_blur(_to_float(resize_image(img, res)), float(a) if a else 9.0)


def _shuffle(img, res, a, b):
    return shuffle_map(_to_float(resize_image(img, res)), seed=int(b) if b else 0)


def _lineart_std(img, res, a, b):
    return _gray3(lineart_standard(resize_image(img, res), float(a) if a else 6.0))


def _xdog(img, res, a, b):
    return _gray3(scribble_xdog(resize_image(img, res), float(a) if a else 32.0))


def _threshold(img, res, a, b):
    return _gray3(threshold_map(resize_image(img, res), float(a) if a else 127.0))


def _recolor_luminance(img, res, a, b):
    """The LAB L channel to a gamma (the reference applies COLOR_BGR2LAB to
    the RGB array; kept so)."""
    lab = cv2_np.bgr_to_lab(resize_image(img, res))
    return _gray3(np.power(lab[:, :, 0].astype(np.float32) / 255.0, float(a) if a else 1.0))


def _recolor_intensity(img, res, a, b):
    hsv = cv2_np.bgr_to_hsv(resize_image(img, res))
    return _gray3(np.power(hsv[:, :, 2].astype(np.float32) / 255.0, float(a) if a else 1.0))


def _color_grid(img, res, a, b):
    """T2I color-adapter palette grid: 64× down (cubic), then nearest back up."""
    img = resize_image(img, res)
    h, w = img.shape[:2]
    small = cv2_np.resize(img, (max(w // 64, 1), max(h // 64, 1)), cv2_np.INTER_CUBIC)
    return _to_float(cv2_np.resize(small, (w, h), cv2_np.INTER_NEAREST))


def _binary(img, res, a, b):
    """Inverted binary threshold; 0 or 255 → Otsu's."""
    gray = cv2_np.rgb_to_gray(resize_image(img, res))
    thr = int(a) if a else 0
    kind = cv2_np.THRESH_BINARY_INV + (cv2_np.THRESH_OTSU if thr in (0, 255) else 0)
    _, out = cv2_np.threshold(gray, 0 if thr in (0, 255) else thr, 255, kind)
    return _gray3(out.astype(np.float32) / 255.0)


def _tile_resample(img, res, a, b):
    down = max(float(a), 1.0) if a else 1.0
    h, w = img.shape[:2]
    small = resize_image(img, int(min(h, w) / down))
    return _to_float(resize_image(small, res))


def _model(module: str, fn: str) -> Callable:
    """A model-based entry: `fn` of preprocessors/<module>.py, imported on
    the first call."""
    def call(img, res, a, b):
        return getattr(importlib.import_module(f"{__name__}.{module}"), fn)(img, res, a, b)

    return call


def _unported(name: str) -> Callable:
    def call(img, res, a, b):
        raise NotImplementedError(f"the {name!r} preprocessor is not ported to forge_tpu_torch "
                                  f"yet ({_ROADMAP_9})")

    return call


# (name, aliases, slider_a, slider_b, tags, needs_weights), the reference's order
_ENTRIES = (
    ("none", (), None, None, ("All",), False),
    ("invert", ("invert (from white bg & black line)",), None, None, ("All",), False),
    ("canny", (), ("Low Threshold", 0, 255, 100), ("High Threshold", 0, 255, 200),
     ("Canny",), False),
    ("blur_gaussian", (), ("Sigma", 0.01, 64.0, 9.0), None, ("Tile",), False),
    ("shuffle", (), None, None, ("Shuffle",), False),
    ("lineart_standard", ("lineart_standard (from white bg & black line)",),
     ("Guassian Sigma", 0.01, 16.0, 6.0), None, ("Lineart",), False),
    ("scribble_xdog", (), ("XDoG Threshold", 1, 64, 32), None, ("Scribble",), False),
    ("threshold", (), ("Binarization Threshold", 0, 255, 127), None, ("Scribble",), False),
    ("tile_resample", (), ("Down Sampling Rate", 1.0, 8.0, 1.0), None, ("Tile",), False),
    ("recolor_luminance", (), ("Gamma Correction", 0.1, 2.0, 1.0), None, ("Recolor",), False),
    ("recolor_intensity", (), ("Gamma Correction", 0.1, 2.0, 1.0), None, ("Recolor",), False),
    ("t2ia_color_grid", ("color",), None, None, ("T2I-Adapter",), False),
    ("threshold_binary", ("binary",), ("Binary Threshold", 0, 255, 0), None, ("Scribble",),
     False),
    ("reference_only", (), ("Style Fidelity", 0.0, 1.0, 0.5), None, ("Reference",), False),
    ("reference_adain", (), ("Style Fidelity", 0.0, 1.0, 0.5), None, ("Reference",), False),
    ("reference_adain+attn", (), ("Style Fidelity", 0.0, 1.0, 0.5), None, ("Reference",),
     False),
    ("CLIP-G (Revision)", ("revision_clipvision",), None, None, ("Revision",), False),
    ("CLIP-G (Revision ignore prompt)", ("revision_ignore_prompt",), None, None,
     ("Revision",), False),
    ("inpaint_global_harmonious", ("inpaint",), None, None, ("Inpaint",), False),
    ("inpaint_only", (), None, None, ("Inpaint",), False),
    ("inpaint_only+lama", (), None, None, ("Inpaint",), True),
    ("depth_midas", ("depth", "depth_midas (MiDaS)"), None, None, ("Depth",), True),
    ("openpose", ("openpose (body)",), None, None, ("OpenPose",), True),
    ("openpose_hand", (), None, None, ("OpenPose",), True),
    ("openpose_face", (), None, None, ("OpenPose",), True),
    ("openpose_faceonly", (), None, None, ("OpenPose",), True),
    ("openpose_full", (), None, None, ("OpenPose",), True),
    ("softedge_hed", ("hed",), None, None, ("SoftEdge",), True),
    ("softedge_hedsafe", (), None, None, ("SoftEdge",), True),
    ("scribble_hed", (), None, None, ("Scribble",), True),
    ("lineart_realistic", ("lineart",), None, None, ("Lineart",), True),
    ("lineart_coarse", (), None, None, ("Lineart",), True),
    ("lineart_anime", (), None, None, ("Lineart",), True),
    ("softedge_pidinet", ("pidinet",), None, None, ("SoftEdge",), True),
    ("softedge_pidisafe", (), None, None, ("SoftEdge",), True),
    ("scribble_pidinet", (), None, None, ("Scribble",), True),
    ("mlsd", (), ("Value Threshold", 0.01, 2.0, 0.1), ("Distance Threshold", 0.01, 20.0, 0.1),
     ("MLSD",), True),
    ("depth_anything_v2", ("depth_anything",), None, None, ("Depth",), True),
    ("softedge_teed", ("teed",), ("Safe Steps", 0, 10, 2), None, ("SoftEdge",), True),
    ("lineart_anime_denoise", ("manga_line",), None, None, ("Lineart",), True),
    ("depth_leres", ("leres",), ("Remove Near %", 0, 100, 0), ("Remove Background %", 0, 100, 0),
     ("Depth",), True),
    ("dw_openpose_full", ("dwpose",), None, None, ("OpenPose",), True),
    ("seg_anime_face", ("anime_face_segment",), None, None, ("Segmentation",), True),
    ("normalbae", ("normal_bae",), None, None, ("NormalMap",), True),
    ("mediapipe_face", (), ("Max Faces", 1, 10, 1), ("Min Confidence", 0.01, 1.0, 0.5),
     ("OpenPose",), True),
    ("seg_ufade20k", ("segmentation", "seg"), None, None, ("Segmentation",), True),
    ("depth_zoe", ("depth_zoe (ZoeDepth)",), None, None, ("Depth",), True),
    ("depth_marigold", (), None, None, ("Depth",), True),
    ("densepose (pruple bg & purple torso)", ("densepose",), None, None, ("OpenPose",), True),
    ("densepose_parula (black bg & blue torso)", (), None, None, ("OpenPose",), True),
    ("seg_ofade20k", ("oneformer",), None, None, ("Segmentation",), True),
    ("seg_ofcoco", (), None, None, ("Segmentation",), True),
)
# the entries that run: the image itself for those extensions/controlnet.py consumes
_PORTED = {"none": _none, "invert": _invert, "canny": _canny, "blur_gaussian": _blur,
           "shuffle": _shuffle, "lineart_standard": _lineart_std, "scribble_xdog": _xdog,
           "threshold": _threshold, "tile_resample": _tile_resample,
           "recolor_luminance": _recolor_luminance, "recolor_intensity": _recolor_intensity,
           "t2ia_color_grid": _color_grid, "threshold_binary": _binary,
           "reference_only": _none, "reference_adain": _none,
           "reference_adain+attn": _none, "CLIP-G (Revision)": _none,
           "CLIP-G (Revision ignore prompt)": _none, "inpaint_global_harmonious": _none,
           "inpaint_only": _none,
           "depth_midas": _model("depth", "depth_midas"),
           "depth_anything_v2": _model("depth_anything", "depth_anything"),
           "openpose": _model("openpose", "openpose_body"),
           "openpose_hand": _model("openpose", "openpose_hand"),
           "openpose_face": _model("openpose", "openpose_face"),
           "openpose_faceonly": _model("openpose", "openpose_faceonly"),
           "openpose_full": _model("openpose", "openpose_full"),
           "softedge_hed": _model("hed", "softedge_hed"),
           "softedge_hedsafe": _model("hed", "softedge_hedsafe"),
           "scribble_hed": _model("hed", "scribble_hed"),
           "lineart_realistic": _model("lineart", "lineart_realistic"),
           "lineart_coarse": _model("lineart", "lineart_coarse"),
           "lineart_anime": _model("lineart", "lineart_anime"),
           "softedge_pidinet": _model("pidinet", "softedge_pidinet"),
           "softedge_pidisafe": _model("pidinet", "softedge_pidisafe"),
           "scribble_pidinet": _model("pidinet", "scribble_pidinet"),
           "mlsd": _model("mlsd", "mlsd"),
           "softedge_teed": _model("teed", "softedge_teed"),
           "lineart_anime_denoise": _model("manga_line", "manga_line"),
           "normalbae": _model("normalbae", "normalbae"),
           "inpaint_only+lama": _model("lama", "inpaint_only_lama"),
           "depth_leres": _model("leres", "depth_leres"),
           "seg_anime_face": _model("anime_face", "seg_anime_face"),
           "mediapipe_face": _model("mediapipe_face", "mediapipe_face"),
           "seg_ufade20k": _model("uniformer", "seg_ufade20k"),
           "depth_zoe": _model("zoe", "depth_zoe"),
           "depth_marigold": _model("marigold", "depth_marigold"),
           "densepose (pruple bg & purple torso)": _model("densepose", "densepose"),
           "densepose_parula (black bg & blue torso)": _model("densepose", "densepose_parula"),
           "seg_ofade20k": _model("oneformer", "seg_ofade20k"),
           "seg_ofcoco": _model("oneformer", "seg_ofcoco")}

for _name, _aliases, _a, _b, _tags, _weights in _ENTRIES:
    register(Preprocessor(_name, _PORTED.get(_name) or _unported(_name), slider_a=_a,
                          slider_b=_b, tags=_tags, needs_weights=_weights,
                          ported=_name in _PORTED), aliases=_aliases)

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

Ported (`Preprocessor.ported`): "none" and "canny" (preprocessors/cv.py);
the reference, Revision and inpaint entries, which extensions/controlnet.py
consumes by their tags, pass the image through as the reference's do. This
registry alone decides which ControlNet modules run: calling any other
entry raises NotImplementedError naming ROADMAP queue 1 item 9, and a unit
with such a module is refused before it is built.

Contract: __call__(img uint8 [H,W,3], res, threshold_a, threshold_b) →
float32 map [H,W,3] in [0, 1] at the detect resolution (the caller resizes
it to the generation size).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .cv import canny, resize_image

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


def _canny(img: np.ndarray, res: int, a, b) -> np.ndarray:
    edges = canny(resize_image(img, res), int(a) if a else 100, int(b) if b else 200)
    return np.repeat(edges[..., None], 3, axis=2)


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
_PORTED = {"none": _none, "canny": _canny, "reference_only": _none, "reference_adain": _none,
           "reference_adain+attn": _none, "CLIP-G (Revision)": _none,
           "CLIP-G (Revision ignore prompt)": _none, "inpaint_global_harmonious": _none,
           "inpaint_only": _none}

for _name, _aliases, _a, _b, _tags, _weights in _ENTRIES:
    register(Preprocessor(_name, _PORTED.get(_name) or _unported(_name), slider_a=_a,
                          slider_b=_b, tags=_tags, needs_weights=_weights,
                          ported=_name in _PORTED), aliases=_aliases)

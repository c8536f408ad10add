# Copied from forge_tpu/postprocessing/faces.py (_square_expand, _feather_mask, restore_faces_in_image, FaceRestorer, get_face_restorer); crops resized with pipeline/images.py's rebuild of OpenCV's linear resize.
"""Face restoration: find the faces → crop → restore at 512² → paste back.

Behavioural twin of the reference's path (modules/codeformer_model.py
restore + face_restoration_utils): each face's square box, widened 1.6×, is
resized to 512², restored by the network (CodeFormer here,
postprocessing/gfpgan.py for GFPGAN) and resized back under a feathered
mask; the reference's truncating uint8 cast of the restored crop is kept.
Resizes are `cv2_linear_resize` (OpenCV's INTER_LINEAR, in numpy: the
card's machine has no OpenCV).

Detection: the reference runs a YuNet ONNX or a Haar cascade XML found
under `models/facedetection/` through OpenCV; the port does not, and such
a file raises NotImplementedError rather than being passed over. Without
one, the square centre of the frame is the one face, as in the reference.

A restorer with no checkpoint raises `RestorerMissing` (a
FileNotFoundError naming the directory) where the reference prints and
skips: a request that asks for restoration never silently gets none.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..pipeline.images import cv2_linear_resize

Box = Tuple[int, int, int, int]  # x, y, w, h
DETECTION_DIR = "models/facedetection"


class RestorerMissing(FileNotFoundError):
    """Face restoration was asked for and its checkpoint is not there."""


def detect_faces(img: np.ndarray, model_dir: str = DETECTION_DIR) -> List[Box]:
    """→ face boxes (x, y, w, h): the square centre of the frame. A detector
    file (a YuNet `.onnx`, a Haar `.xml`) in `model_dir` raises."""
    found = sorted(glob.glob(os.path.join(model_dir, "*.onnx"))
                   + glob.glob(os.path.join(model_dir, "*.xml")))
    if found:
        raise NotImplementedError(
            f"face detection with {found[0]} is not ported to forge_tpu_torch yet (it runs "
            "through OpenCV in the reference; ROADMAP.md queue 1 item 9)")
    h, w = img.shape[:2]
    side = min(h, w)
    return [((w - side) // 2, (h - side) // 2, side, side)]


def _square_expand(box: Box, img_h: int, img_w: int, expand: float = 1.6) -> Box:
    x, y, w, h = box
    cx, cy = x + w / 2, y + h / 2
    side = min(int(max(w, h) * expand), img_h, img_w)
    x0 = int(np.clip(cx - side / 2, 0, img_w - side))
    y0 = int(np.clip(cy - side / 2, 0, img_h - side))
    return (x0, y0, side, side)


def _feather_mask(size: int, border_frac: float = 0.08) -> np.ndarray:
    border = max(int(size * border_frac), 1)
    ramp = np.linspace(0.0, 1.0, border, dtype=np.float32)
    m = np.ones((size, size), np.float32)
    m[:border] *= ramp[:, None]
    m[-border:] *= ramp[::-1][:, None]
    m[:, :border] *= ramp[None, :]
    m[:, -border:] *= ramp[::-1][None, :]
    return m[..., None]


def restore_faces_in_image(img: np.ndarray, restore_fn: Callable[[np.ndarray], np.ndarray],
                           face_size: int = 512) -> np.ndarray:
    """Run `restore_fn` (a face_size² uint8 crop in, a face_size² crop out)
    on every face and paste it back under a feathered mask."""
    out = img.astype(np.float32)
    h, w = img.shape[:2]
    for box in detect_faces(img):
        x, y, bw, _ = _square_expand(box, h, w)
        crop = img[y:y + bw, x:x + bw]
        restored = restore_fn(cv2_linear_resize(crop, face_size, face_size))
        back = cv2_linear_resize(np.asarray(restored, np.uint8), bw, bw).astype(np.float32)
        mask = _feather_mask(bw)
        out[y:y + bw, x:x + bw] = back * mask + out[y:y + bw, x:x + bw] * (1 - mask)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


class FaceRestorer:
    """The CodeFormer restorer (reference FaceRestorerCodeFormer): the first
    of `model_dir`'s `.pth` files, then its `.safetensors` files (sorted),
    or `params` given, on `device` (the card unless given) in `dtype` (the
    device's compute dtype unless given), except what picks the codes (the
    encoder, the codebook, the transformer and `idx_pred_layer`, whose
    argmax over 1024 codes bf16 changes): that is stored and run in
    `code_dtype`, f32 unless given (PERF.md: in bf16 under 99 % of
    the codes agree with an f32 run's)."""

    name = "CodeFormer"
    GENERATOR = ("generator", "fuse_convs_dict")  # the parts in `dtype`

    def __init__(self, model_dir: str = "models/Codeformer", params=None, device=None,
                 dtype: Optional[torch.dtype] = None,
                 code_dtype: Optional[torch.dtype] = torch.float32):
        self.model_dir = model_dir
        self._params = params
        self.device = device
        self.dtype = dtype
        self.code_dtype = code_dtype

    def _paths(self) -> List[str]:
        return (glob.glob(os.path.join(self.model_dir, "*.pth"))
                + glob.glob(os.path.join(self.model_dir, "*.safetensors")))

    @property
    def available(self) -> bool:
        return self._params is not None or bool(self._paths())

    def load(self):
        if self._params is None:
            from ..core.convert import tree_to
            from ..core.state_dict import load_state_dict
            from ..models.codeformer import load_codeformer
            from ..pipeline.engine import default_device, default_dtype

            paths = self._paths()
            if not paths:
                raise RestorerMissing(f"no CodeFormer checkpoint under {self.model_dir}")
            device = torch.device(self.device) if self.device is not None else default_device()
            dtype = self.dtype or default_dtype(device)
            tree = load_codeformer(load_state_dict(sorted(paths)[0]))
            gen = {k: v for k, v in tree.items() if k in self.GENERATOR}
            self._params = {**tree_to(gen, device, dtype),
                            **tree_to({k: v for k, v in tree.items() if k not in gen}, device,
                                      self.code_dtype or dtype)}
        return self._params

    def restore_crop(self, crop: np.ndarray, w: float, codes_out: Optional[list] = None
                     ) -> np.ndarray:
        """A 512² uint8 crop → the restored crop, float32 in [0, 255]."""
        from ..models.codeformer import codeformer_apply

        params = self.load()
        leaf = params["quantize"]["embedding"]["weight"]
        x = torch.from_numpy(np.asarray(crop, np.float32)).permute(2, 0, 1)[None] / 127.5 - 1.0
        with torch.no_grad():
            y = codeformer_apply(params, x.to(leaf.device), w=float(w), codes_out=codes_out)
        return ((y[0].float() + 1.0) * 127.5).clamp(0, 255).permute(1, 2, 0).cpu().numpy()

    def restore(self, img: np.ndarray, w: Optional[float] = None) -> np.ndarray:
        """The whole image (reference codeformer_model.py restore); `w` from
        the `code_former_weight` option unless given."""
        if w is None:
            from ..runtime.options import opts

            w = float(opts.get("code_former_weight"))
        self.load()
        return restore_faces_in_image(img, lambda crop: self.restore_crop(crop, w))


_restorer: Optional[FaceRestorer] = None


def get_face_restorer(device=None):
    """The restorer the `face_restoration_model` option names (CodeFormer or
    GFPGAN), made once a process on `device` (the card unless given)."""
    from ..runtime.options import opts

    if str(opts.get("face_restoration_model")).lower() == "gfpgan":
        from .gfpgan import get_gfpgan

        return get_gfpgan(device)
    global _restorer
    if _restorer is None:
        _restorer = FaceRestorer(device=device)
    return _restorer

"""What the model-based annotators share: the detector that finds, loads and
places a checkpoint, and the small layers several networks use.

A `Detector` reads its checkpoint from the reference's directory and file
names through core/state_dict.py `load_state_dict`, keeps the weights in
their upstream key space and torch layout (OIHW kernels, [I, O, kh, kw]
transpose-conv kernels), nested by the key's dots, and holds them on its
device (the card unless given) in its dtype (the annotator's own unless
given). A missing checkpoint raises the reference's RuntimeError naming
the directory when the detector is called.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

_SUFFIXES = (".pth", ".pt", ".safetensors")
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class Detector:
    """One annotator network's weights. `filename` names the file under
    `model_dir`; otherwise the first file (sorted) with a checkpoint suffix
    and, where `match` is given, that substring in its lower-cased name.
    `convert` maps the flat state dict before it is nested; `missing` is the
    RuntimeError's text. DTYPE is the annotator's dtype on the card
    (PERF.md §4); on the CPU it runs in float32."""

    DTYPE = torch.float32

    def __init__(self, model_dir: str, filename: Optional[str] = None,
                 match: Optional[str] = None, suffixes=_SUFFIXES,
                 convert: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
                 missing: str = "no checkpoint", device=None,
                 dtype: Optional[torch.dtype] = None, params=None):
        self.model_dir = model_dir
        self.filename = filename
        self.match = match
        self.suffixes = suffixes
        self.convert = convert
        self.missing = missing
        self.device = device
        self.dtype = dtype
        self.params = params

    def path(self) -> Optional[str]:
        if self.filename:
            p = os.path.join(self.model_dir, self.filename)
            return p if os.path.exists(p) else None
        if not os.path.isdir(self.model_dir):
            return None
        for f in sorted(os.listdir(self.model_dir)):
            if f.endswith(self.suffixes) and (self.match is None or self.match in f.lower()):
                return os.path.join(self.model_dir, f)
        return None

    @property
    def available(self) -> bool:
        return self.params is not None or self.path() is not None

    def placement(self):
        """(device, dtype) the weights live in."""
        from ..core.device import placement

        return placement(self.device, self.dtype, self.DTYPE)

    def load(self) -> Dict[str, Any]:
        """The nested weights on the detector's device; RuntimeError where
        there is no checkpoint."""
        if self.params is None:
            from ..core.convert import nest, tree_to
            from ..core.state_dict import load_state_dict

            path = self.path()
            if path is None:
                raise RuntimeError(f"{self.missing} under {self.model_dir}")
            sd = load_state_dict(path)
            if self.convert is not None:
                sd = self.convert(sd)
            device, dtype = self.placement()
            self.params = tree_to(nest(sd), device, dtype)
        return self.params

    def image_tensor(self, x: np.ndarray) -> torch.Tensor:
        """float [H,W,C] (or [H,W]) numpy → [1,C,H,W] on the weights' device and dtype."""
        leaf = _first_leaf(self.load())
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = x[..., None]
        t = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))
        return t.to(leaf.device, leaf.dtype)


# the backend settings a forward found, put back after the last forward on any thread ends
_FLAGS_LOCK = threading.Lock()
_FLAGS = {"forwards": 0, "found": None}


def _backend_flags():
    c = torch.backends.cudnn
    return c.benchmark, c.deterministic, c.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set_backend_flags(benchmark, deterministic, cudnn_tf32, matmul_tf32):
    c = torch.backends.cudnn
    c.benchmark, c.deterministic, c.allow_tf32 = benchmark, deterministic, cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@contextlib.contextmanager
def inference():
    """A detector's forward: no autograd; cuDNN's deterministic algorithms,
    so that a rerun gives the same bytes (some of its transpose conv
    algorithms accumulate with atomics); and TF32 off in cuDNN and in
    matmuls, so that a network the card runs in f32 (its discrete output
    moves in bf16, PERF.md §4) computes in f32 wherever it is served. The
    settings are the process's: they hold while a forward runs on any
    thread, and the ones found are put back when the last one ends."""
    with _FLAGS_LOCK:
        if _FLAGS["forwards"] == 0:
            _FLAGS["found"] = _backend_flags()
            _set_backend_flags(False, True, False, False)
        _FLAGS["forwards"] += 1
    try:
        with torch.no_grad():
            yield
    finally:
        with _FLAGS_LOCK:
            _FLAGS["forwards"] -= 1
            if _FLAGS["forwards"] == 0:
                _set_backend_flags(*_FLAGS["found"])


def _first_leaf(tree: Mapping[str, Any]) -> torch.Tensor:
    for v in tree.values():
        return _first_leaf(v) if isinstance(v, Mapping) else v
    raise ValueError("empty weights")


def strip_module(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop DataParallel's `module.` from every key."""
    return {k.replace("module.", ""): v for k, v in sd.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def batch_norm(x: torch.Tensor, p: Mapping[str, Any], eps: float) -> torch.Tensor:
    """BatchNorm2d in eval mode with its running statistics, NCHW."""
    scale = p["weight"].float() * torch.rsqrt(p["running_var"].float() + eps)
    shift = p["bias"].float() - p["running_mean"].float() * scale
    return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2, the odd row and column dropped."""
    return F.max_pool2d(x, 2, 2)


def resize_align(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear to `hw` with align_corners=True (torch's F.interpolate)."""
    return F.interpolate(x, size=(int(hw[0]), int(hw[1])), mode="bilinear", align_corners=True)


def safe_step(x: np.ndarray, step: int = 2) -> np.ndarray:
    """annotator/util.py safe_step: quantize to `step` levels."""
    y = x.astype(np.float64) * float(step + 1)
    return y.astype(np.int32).astype(np.float64) / float(step)


def gray_map(g: np.ndarray) -> np.ndarray:
    """uint8 [H,W] → float32 [H,W,3] in [0, 1]."""
    return np.repeat(g[..., None].astype(np.float32) / 255.0, 3, axis=2)

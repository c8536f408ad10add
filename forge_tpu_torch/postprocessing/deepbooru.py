"""The DeepDanbooru tagger, resnet_custom_v3 (port of
forge_tpu/postprocessing/deepbooru.py).

The reference's deepbooru interrogator (modules/deepbooru.py:53-104
tag_multi, modules/deepbooru_model.py: a generated graph of 179 convs) is a
batch-norm-free bottleneck ResNet whose structure follows from the
checkpoint's ordered `n_Conv_{i}.weight` shapes; `build_plan` walks them:

  stem:      7×7 s2 (TF-SAME pad [2,3]) → relu → maxpool 3×3 s2 (pad [0,1], −inf)
  stage head A (projection first, deepbooru_model.py:27-31): proj 1×1 [s2
             unless the first stage] ∥ (reduce 1×1 → 3×3 [s2] → expand 1×1)
  mid-stage downsample B (projection last, :114-117 convs 97-100)
  identity:  reduce → 3×3 → expand, residual add
  head:      1×1 → global mean → sigmoid (:667-671)

Stride-2 3×3 convs pad [0,1] (the torch graph's F.pad(..., [0,1,0,1])).
Activations NCHW, kernels OIHW as the file holds them.

The tag names are the checkpoint's own `tags` list (model-resnet_custom_v3.pt
holds it beside the tensors); the reference's loader keeps tensors only and
so reads none (tests/test_torch_deepbooru.py shows both sides). The input
is the image resized to 512² by Pillow's LANCZOS (pipeline/images.py
`lanczos_resize`, Pillow-exact), in [0, 1].
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..preprocessors.annotator import inference


def _k(p, i):
    return p.get(f"n_Conv_{i}")


def build_plan(params: Mapping[str, Any]) -> List[Tuple]:
    """The ordered conv shapes → [('stem', i), ('block', proj|None, reduce,
    c3, expand, stride), ('head', i)]."""
    n = 0
    while _k(params, n) is not None:
        n += 1

    def shape(i):  # (kh, kw, in, out) of the OIHW kernel, as the reference reads HWIO
        o, c, kh, kw = _k(params, i)["weight"].shape
        return kh, kw, c, o

    plan: List[Tuple] = [("stem", 0)]
    trunk = shape(0)[-1]
    i = 1
    first_stage = True
    while i < n:
        if i == n - 1:
            plan.append(("head", i))
            break
        kh, kw, cin, cout = shape(i)
        nxt = shape(i + 1) if i + 1 < n else None
        if kh == 1 and cin == trunk and nxt and nxt[0] == 1 and nxt[2] == trunk and nxt[3] < cout:
            # A: the projection first, then the bottleneck
            plan.append(("block", i, i + 1, i + 2, i + 3, 1 if first_stage else 2))
            trunk = cout
            first_stage = False
            i += 4
            continue
        # a reduce begins a bottleneck; a projection may trail it (B)
        expand_out = shape(i + 2)[-1]
        if i + 3 < n - 1:
            k3 = shape(i + 3)
            if k3[0] == 1 and k3[2] == trunk and k3[3] == expand_out and expand_out == trunk:
                plan.append(("block", i + 3, i, i + 1, i + 2, 2))
                i += 4
                continue
        plan.append(("block", None, i, i + 1, i + 2, 1))
        trunk = expand_out
        i += 3
    return plan


def deepbooru_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B,3,H,W] in [0,1] → tag probabilities [B, n_tags] f32."""
    for spec in build_plan(params):
        if spec[0] == "stem":
            x = nn.conv2d(F.pad(x, (2, 3, 2, 3)), _k(params, spec[1]), stride=2)
            x = F.pad(F.relu(x), (0, 1, 0, 1), value=-float("inf"))
            x = F.max_pool2d(x, 3, 2)
        elif spec[0] == "block":
            _, proj, red, c3, exp, stride = spec
            h = F.relu(nn.conv2d(x, _k(params, red)))
            h = F.pad(h, (0, 1, 0, 1) if stride == 2 else (1, 1, 1, 1))
            h = F.relu(nn.conv2d(h, _k(params, c3), stride=stride))
            h = nn.conv2d(h, _k(params, exp))
            skip = x if proj is None else nn.conv2d(x, _k(params, proj), stride=stride)
            x = F.relu(h + skip)
        else:  # head
            x = nn.conv2d(x, _k(params, spec[1]))
            x = torch.sigmoid(x.float().mean(dim=(2, 3)))
    return x


_RE_SPECIAL = re.compile(r"([\\()])")


class DeepDanbooru:
    """The loader and the tag formatter (the reference's
    modules/deepbooru.py:53-104). The first .pt, .pth or .safetensors under
    `model_dir`; the weights on the card unless `device` is given, in
    `dtype` (DTYPE on the card, f32 on the CPU)."""

    DTYPE = torch.float32  # in bf16 tags cross the threshold (PERF.md §4)

    def __init__(self, model_dir: str = "models/torch_deepdanbooru", device=None,
                 dtype: Optional[torch.dtype] = None):
        self.model_dir = model_dir
        self.device = device
        self.dtype = dtype
        self.params: Optional[Dict[str, Any]] = None
        self.tags: List[str] = []

    @property
    def available(self) -> bool:
        try:
            self.load()
            return self.params is not None
        except Exception:
            return False

    def placement(self):
        from ..core.device import placement

        return placement(self.device, self.dtype, self.DTYPE)

    def load(self, path: Optional[str] = None):
        if self.params is not None:
            return
        if path is None:
            if not os.path.isdir(self.model_dir):
                return
            cands = [f for f in sorted(os.listdir(self.model_dir))
                     if f.endswith((".pt", ".pth", ".safetensors"))]
            if not cands:
                return
            path = os.path.join(self.model_dir, cands[0])
        from ..core.convert import nest, tree_to
        from ..core.state_dict import load_state_dict, load_torch_object

        if path.endswith(".safetensors"):
            sd, tags = load_state_dict(path), []
        else:  # the .pt holds the tag names beside the tensors
            obj = load_torch_object(path)
            tags = list(obj.get("tags", []))
            sd = {k: v for k, v in obj.items() if isinstance(v, np.ndarray)}
        self.tags = [str(t) for t in tags]
        self.params = tree_to(nest(sd), *self.placement())

    def probabilities(self, image: np.ndarray) -> np.ndarray:
        """image uint8/float [H,W,3] → per-tag probabilities."""
        from ..pipeline.images import lanczos_resize

        self.load()
        if self.params is None:
            raise RuntimeError(f"no deepbooru checkpoint under {self.model_dir}")
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img * (255 if img.max() <= 1.5 else 1), 0, 255).astype(np.uint8)
        x = lanczos_resize(img[..., :3], 512, 512).astype(np.float32) / 255.0
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))
        with inference():  # f32 on the card: TF32 off
            return deepbooru_apply(self.params, x.to(*self.placement()))[0].cpu().numpy()

    def tag(self, image: np.ndarray, threshold: float = 0.5, alpha_sort: bool = False,
            use_spaces: bool = True, use_escape: bool = True, include_ranks: bool = False,
            filter_tags: str = "") -> str:
        probs = self.probabilities(image)
        picked = {t: float(pr) for t, pr in zip(self.tags, probs)
                  if pr >= threshold and not t.startswith("rating:")}
        names = (sorted(picked) if alpha_sort
                 else [t for t, _ in sorted(picked.items(), key=lambda kv: -kv[1])])
        filtered = {x.strip().replace(" ", "_") for x in filter_tags.split(",")}
        out = []
        for t in names:
            if t in filtered:
                continue
            s = t.replace("_", " ") if use_spaces else t
            if use_escape:
                s = _RE_SPECIAL.sub(r"\\\1", s)
            if include_ranks:
                s = f"({s}:{picked[t]:.3f})"
            out.append(s)
        return ", ".join(out)


_MODEL: Optional[DeepDanbooru] = None


def get_deepbooru(device=None) -> DeepDanbooru:
    global _MODEL
    if _MODEL is None:
        _MODEL = DeepDanbooru(device=device)
    return _MODEL

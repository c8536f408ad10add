"""ControlNet units: loading, preprocessing and attachment (port of
forge_tpu/extensions/controlnet.py, itself of Forge's sd_forge_controlnet).

A unit is the API's dict {enabled, module, model | model_path, image, mask,
weight, guidance_start, guidance_end, processor_res, threshold_a,
threshold_b, advanced_weighting}. `attach_units` runs each unit's
preprocessor, loads its control model and appends the state to
`p.controlnets`; what needs the engine (a Control-LoRA's assembly onto the
live UNet, inpaint_only's VAE encode) goes to `p.deferred_hooks` as a
hook fn(engine, p, cond, uncond).

The control models, told apart by their keys (a `control_model.` prefix
stripped): a cldm ControlNet (`input_hint_block.*`), a T2I-Adapter
(`conv_in.*` and `body.*`, models/t2i_adapter.py) and a Control-LoRA
(`lora_controlnet`: the hint block, zero convs and `.up`/`.down` pairs on
the trunk, `assemble_control_lora`). A model is a file in the model
directories, a path, or a flat state dict. The modules taken: "none",
"canny", "inpaint_global_harmonious" and "inpaint_only"
(pipeline/cn_inpaint.py), and the ones that need no control model: the
reference modules ("reference_only", "reference_adain",
"reference_adain+attn": pipeline/reference_only.py, a deferred hook that
VAE-encodes the unit's image) and Revision ("CLIP-G (Revision)" or
"revision_clipvision", and the "ignore prompt" pair: pipeline/revision.py,
a deferred hook that encodes the image with the unit's `clip_vision_path`,
a file's path or a flat state dict, or the first file under
models/clip_vision). Every other module raises
NotImplementedError naming its ROADMAP item. Images are PNG (base64,
through pipeline/images.py) or arrays. Weights are OIHW, as the files hold
them.
"""

from __future__ import annotations

import base64
import hashlib
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.convert import flatten, nest
from ..core.device import default_device, default_dtype
from ..core.loader import to_device_tree
from ..core.patches import _f32, _highest
from ..core.state_dict import load_state_dict
from ..models.controlnet import ControlNetState
from ..models.t2i_adapter import T2IAdapterState, detect_adapter_config
from ..models.unet import UNetConfig
from ..ops.quant import QuantLeaf, dequantize
from ..preprocessors.cv import bilinear_resize, canny, resize_image

_MODEL_DIRS = ["models/ControlNet", "models/controlnet"]
_MODEL_CACHE: Dict[Any, Tuple[str, Any, Any, str]] = {}
_TRUNK = ("input_blocks", "middle_block", "time_embed", "label_emb")
_ROADMAP_6D = "ROADMAP queue 1 item 6 (d), the image-prompt family"
_ROADMAP_9 = "ROADMAP queue 1 item 9, the long tail of preprocessors"


def set_model_dirs(dirs) -> None:
    global _MODEL_DIRS
    _MODEL_DIRS = list(dirs)


def _find_model(name: str) -> Optional[str]:
    if os.path.isfile(name):
        return name
    for d in _MODEL_DIRS:
        if os.path.isdir(d):
            for f in os.listdir(d):
                if os.path.splitext(f)[0] == name or f == name:
                    return os.path.join(d, f)
    return None


def load_control_model(source, device=None, dtype: Optional[torch.dtype] = None):
    """A file's path or a flat state dict → (kind, tree, cfg, digest), kind
    "controlnet", "t2i_adapter" or "control_lora". A cldm or an adapter goes
    to `device` (the card unless given) in `dtype` (bf16 on CUDA, f32 on the
    CPU unless given); a Control-LoRA stays the flat dict its assembly reads.
    A file's model is cached by path, device and dtype. The digest names the
    keys and the file, or the dict object: one dict, one Control-LoRA
    assembly on an engine."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    key = (source, str(device), dtype) if isinstance(source, str) else None
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    sd = load_state_dict(source) if isinstance(source, str) else dict(source)
    tag = source if isinstance(source, str) else f"state dict {id(source)}"
    digest = hashlib.sha256(("|".join(sorted(sd)) + tag).encode()).hexdigest()[:16]
    if any(k.startswith("control_model.") for k in sd):
        sd = {k[len("control_model."):]: v for k, v in sd.items()
              if k.startswith("control_model.")}
    if "lora_controlnet" in sd:
        out = ("control_lora", sd, None, digest)
    elif any(k.startswith("input_hint_block") for k in sd):
        out = ("controlnet", to_device_tree(sd, dtype, device), _cn_config(sd), digest)
    elif "conv_in.weight" in sd and any(k.startswith("body.") for k in sd):
        params = to_device_tree(sd, dtype, device)
        out = ("t2i_adapter", params, detect_adapter_config(params), digest)
    else:
        raise ValueError(f"unrecognized control model format: {tag}")
    if key is not None:
        _MODEL_CACHE[key] = out
    return out


def assemble_control_lora(engine, sd: Mapping[str, Any], model_digest: str):
    """A Control-LoRA onto the live UNet → (cldm tree, cfg): the trunk
    (`input_blocks`, `middle_block`, `time_embed`, `label_emb`) is the
    engine's UNet, the file's own weights overlay it, and each `.up`/`.down`
    pair adds up·down, in f32 with TF32 off, to its trunk weight (kept in
    that weight's dtype and memory layout); the engine's tree is never
    written. Cached on the engine by the model's digest."""
    cache = engine.__dict__.setdefault("_control_lora_cache", {})
    if model_digest in cache:
        return cache[model_digest]
    out = {k: v for k, v in flatten(engine.loaded.unet).items() if k.split(".")[0] in _TRUNK}
    pairs: Dict[str, Dict[str, Any]] = {}
    own = {}
    for k, v in sd.items():
        if k == "lora_controlnet":
            continue
        if k.endswith((".up", ".down")):
            base, which = k.rsplit(".", 1)
            pairs.setdefault(base, {})[which] = v
        else:
            own[k] = v
    out.update(flatten(to_device_tree(own, engine.compute_dtype, engine.device)))
    with torch.no_grad(), _highest():
        for base, ud in pairs.items():
            wkey = base + ".weight"
            w = out.get(wkey)
            if w is None or "up" not in ud or "down" not in ud:
                continue
            up, down = (_f32(ud[name], engine.device) for name in ("up", "down"))
            dense = dequantize(w, torch.float32) if isinstance(w, QuantLeaf) else w.float()
            delta = up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)
            merged = torch.empty_like(w) if not isinstance(w, QuantLeaf) else torch.empty(
                dense.shape, dtype=engine.compute_dtype, device=engine.device)
            merged.copy_(dense + delta.reshape(dense.shape))
            out[wkey] = merged
    cache[model_digest] = (nest(out), engine.unet_cfg)
    return cache[model_digest]


def _cn_config(sd: Mapping[str, Any]) -> UNetConfig:
    """The cldm's attention geometry from its shapes: 768-wide context (or
    none) → SD1.5's heads of 40 channels, else heads of 64."""
    ctx = next((v.shape[1] for k, v in sd.items() if k.endswith("attn2.to_k.weight")), None)
    model_ch = sd["input_blocks.0.0.weight"].shape[0]
    if ctx in (None, 768):
        return UNetConfig(context_dim=768, num_heads=max(model_ch // 40, 1))
    return UNetConfig(context_dim=ctx, head_dim=64)


def _decode_image(image) -> np.ndarray:
    """unit['image']: a base64 PNG (a data URL too), an array or {'image': …}
    → uint8 [H,W,3]."""
    if isinstance(image, dict):
        image = image.get("image")
    if isinstance(image, str):
        from ..pipeline.images import decode_png, to_rgb

        return to_rgb(decode_png(base64.b64decode(image.split(",", 1)[-1]))[0])
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 else arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    return arr[..., :3]


def _decode_unit_mask(unit: Mapping[str, Any], image) -> Optional[np.ndarray]:
    """unit['mask'], unit['mask_image'] or the image dict's 'mask' → float
    [H,W] in [0, 1] (its first channel), or None."""
    m = unit.get("mask")
    if m is None:
        m = unit.get("mask_image")
    if m is None and isinstance(image, dict):
        m = image.get("mask")
    if m is None:
        return None
    return np.asarray(_decode_image(m)[..., 0], np.float32) / 255.0


def _none(img: np.ndarray, res: int, a, b) -> np.ndarray:
    return np.asarray(resize_image(img, res), np.float32) / 255.0


def _canny(img: np.ndarray, res: int, a, b) -> np.ndarray:
    edges = canny(resize_image(img, res), int(a) if a else 100, int(b) if b else 200)
    return np.repeat(edges[..., None], 3, axis=2)


PREPROCESSORS: Dict[str, Callable] = {"none": _none, "canny": _canny}
INPAINT_MODULES = ("inpaint_global_harmonious", "inpaint_only")
REFERENCE_MODULES = ("reference_only", "reference_adain", "reference_adain+attn")
# the reference's Revision preprocessors and their aliases → "ignore prompt"
REVISION_MODULES = {"clip-g (revision)": False, "revision_clipvision": False,
                    "clip-g (revision ignore prompt)": True, "revision_ignore_prompt": True}
_CLIP_VISION_DIRS = ("models/clip_vision", "models/ClipVision")
_WEIGHT_FILES = (".safetensors", ".ckpt", ".pt", ".pth", ".bin")


def _find_clip_vision() -> Optional[str]:
    """The first checkpoint under models/clip_vision (Revision's bigG encoder)."""
    for d in _CLIP_VISION_DIRS:
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                if f.endswith(_WEIGHT_FILES):
                    return os.path.join(d, f)
    return None


def _refuse_module(module: str) -> None:
    low = module.lower()
    if (low in PREPROCESSORS or low in INPAINT_MODULES or low in REFERENCE_MODULES
            or low in REVISION_MODULES):
        return
    if any(t in low for t in ("ip-adapter", "ipadapter", "insightface", "instant_id",
                              "instantid", "faceid")):
        raise NotImplementedError(
            f"ControlNet module {module!r} is not ported to forge_tpu_torch: the IP-Adapter, "
            f"FaceID and InstantID come through the 'ip-adapter' always-on script "
            f"({_ROADMAP_6D})")
    taken = ", ".join(list(PREPROCESSORS) + list(INPAINT_MODULES) + list(REFERENCE_MODULES)
                      + list(REVISION_MODULES))
    raise NotImplementedError(f"ControlNet module {module!r} is not ported to forge_tpu_torch "
                              f"yet (ported: {taken}): {_ROADMAP_9}")


def build_unit_state(unit: Mapping[str, Any], width: int, height: int, device=None,
                     dtype: Optional[torch.dtype] = None):
    """One unit → a ControlNetState or T2IAdapterState, a deferred hook,
    a list of them, or None (disabled, or no image). The hint is the
    preprocessed map at the request's size, [1,3,H,W] f32 in [0, 1] (an
    inpaint hint's masked pixels −1)."""
    if not unit.get("enabled", True):
        return None
    image = unit.get("image")
    if image is None:
        return None
    module = unit.get("module", "none") or "none"
    _refuse_module(module)
    img = _decode_image(image)
    extra: List[Callable] = []
    low = module.lower()
    if low in REFERENCE_MODULES:
        # no control model and no hint: the image is VAE-encoded for each request
        def build_reference(engine, p, cond, uncond, _img=img, _module=low, _u=dict(unit)):
            from ..pipeline.reference_only import attach_reference

            attach_reference(engine, p, _img, _module,
                             style_fidelity=float(_u.get("threshold_a", 0.5) or 0.5),
                             weight=float(_u.get("weight", 1.0)),
                             start=float(_u.get("guidance_start", 0.0)),
                             end=float(_u.get("guidance_end", 1.0)))

        return build_reference
    if low in REVISION_MODULES:
        cv_path = unit.get("clip_vision_path") or _find_clip_vision()
        if cv_path is None:
            raise FileNotFoundError("Revision needs CLIP-ViT-bigG weights: pass "
                                    "clip_vision_path or place a checkpoint under "
                                    "models/clip_vision")

        def build_revision(engine, p, cond, uncond, _img=img, _w=float(unit.get("weight", 1.0)),
                           _cv=cv_path, _ignore=REVISION_MODULES[low]):
            from ..core.loader import load_clip_vision
            from ..pipeline.revision import apply_revision, encode_revision_embed

            tree = load_clip_vision(_cv, engine.compute_dtype, engine.device)
            apply_revision(p, cond, uncond, encode_revision_embed(tree, _img, _w), _ignore)

        return build_revision
    if low in INPAINT_MODULES:
        from ..pipeline.cn_inpaint import mix_hint

        mask = _decode_unit_mask(unit, image)
        if mask is None:
            mask = np.zeros(img.shape[:2], np.float32)
        img_r = bilinear_resize(np.asarray(img, np.float32) / 255.0, height, width)
        mask_r = np.clip(bilinear_resize(np.repeat(mask[..., None], 3, 2), height,
                                         width)[..., 0], 0, 1)
        fmap = mix_hint(img_r, mask_r)
        if low == "inpaint_only":
            def build_inpaint(engine, p, cond, uncond, _img=img, _mask=mask):
                from ..pipeline.cn_inpaint import attach_inpaint_only

                attach_inpaint_only(engine, p, _img, _mask)

            extra.append(build_inpaint)
    else:
        res = int(unit.get("processor_res", 0) or 0) or min(img.shape[:2])
        fmap = PREPROCESSORS[low](img, res, unit.get("threshold_a", 0) or 0,
                                  unit.get("threshold_b", 0) or 0)
        fmap = np.clip(bilinear_resize(fmap, height, width), 0.0, 1.0)
    hint = torch.from_numpy(np.ascontiguousarray(fmap.transpose(2, 0, 1)[None], np.float32))

    model = unit.get("model")
    if model is None:
        model = unit.get("model_path")
    if model is None or (isinstance(model, str) and model.lower() in ("", "none", "null")):
        return extra or None  # inpaint_only without a model still composites
    if isinstance(model, str):
        path = _find_model(model)
        if path is None:
            raise FileNotFoundError(f"controlnet model {model!r} not found in {_MODEL_DIRS}")
        model = path
    kind, params, cfg, model_digest = load_control_model(model, device, dtype)
    common = dict(hint=hint, strength=float(unit.get("weight", 1.0)),
                  start_percent=float(unit.get("guidance_start", 0.0)),
                  end_percent=float(unit.get("guidance_end", 1.0)),
                  block_weights=unit.get("advanced_weighting"))
    if kind == "control_lora":
        def build_control_lora(engine, p, cond, uncond, _sd=params, _common=common):
            tree, ucfg = assemble_control_lora(engine, _sd, model_digest)
            p.controlnets = list(p.controlnets or []) + [
                ControlNetState(params=tree, cfg=ucfg, **_common)]

        return [build_control_lora] + extra
    state_cls = T2IAdapterState if kind == "t2i_adapter" else ControlNetState
    return [state_cls(params=params, cfg=cfg, **common)] + extra


def attach_units(p, units, device=None, dtype: Optional[torch.dtype] = None) -> int:
    """Every enabled unit's states appended to `p.controlnets` and its
    deferred hooks to `p.deferred_hooks` → the number of units taken. Models load
    to `device` (the card unless given) in `dtype`."""
    states = []
    n = 0
    for unit in units or ():
        st = build_unit_state(unit, p.width, p.height, device, dtype)
        if st is None:
            continue
        n += 1
        for item in (st if isinstance(st, list) else [st]):
            if callable(item):
                p.deferred_hooks = list(p.deferred_hooks or []) + [item]
            else:
                states.append(item)
    if states:
        p.controlnets = list(p.controlnets or []) + states
    return n

"""The port's apps for the bundled Forge Spaces (extensions-builtin/
forge_space_*), run by runtime/spaces.py as `python -m
forge_tpu_torch.spaces.<name> --host H --port P [--device cpu]`.

Each keeps its reference app's page, its POST /process body and its
answers. Uploads are decoded by the port's PNG codec (pipeline/images.py)
where the reference uses Pillow, and answered as PNG by it: an upload in
another format answers the harness's 500 with an error naming ROADMAP item
7, the image encoders and decoders.
"""

from __future__ import annotations

import base64

import numpy as np

_ROADMAP_CODECS = "ROADMAP.md queue 1 item 7: the image encoders"


def decode_upload(b64: str, mode: str = "RGB") -> np.ndarray:
    """A base64 PNG → uint8 RGB [H, W, 3] (Pillow's convert("RGB")), or with
    mode "L" uint8 [H, W] (Pillow's convert("L"): grey kept, colour weighted
    (19595·R + 38470·G + 7471·B + 2^15) >> 16)."""
    from ..pipeline.images import UnsupportedImage, decode_png, to_rgb

    try:
        pixels, _ = decode_png(base64.b64decode(b64))
    except UnsupportedImage as e:
        raise NotImplementedError(f"{e}: other formats are not ported to forge_tpu_torch yet "
                                  f"({_ROADMAP_CODECS})") from e
    if mode == "RGB":
        return to_rgb(pixels)
    if mode != "L":
        raise ValueError(f"decode_upload: mode {mode!r} (RGB or L)")
    if pixels.ndim == 2 or pixels.shape[-1] <= 2:
        return np.ascontiguousarray(pixels if pixels.ndim == 2 else pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def encode_answer(image: np.ndarray) -> str:
    """uint8 RGB or RGBA pixels → base64 PNG."""
    from ..pipeline.images import encode_png

    return base64.b64encode(encode_png(np.ascontiguousarray(image))).decode()

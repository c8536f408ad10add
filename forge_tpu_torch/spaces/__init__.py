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


def decode_upload(b64: str) -> np.ndarray:
    """A base64 PNG → uint8 RGB [H, W, 3] (Pillow's convert("RGB"))."""
    from ..pipeline.images import UnsupportedImage, decode_png, to_rgb

    try:
        pixels, _ = decode_png(base64.b64decode(b64))
    except UnsupportedImage as e:
        raise NotImplementedError(f"{e}: other formats are not ported to forge_tpu_torch yet "
                                  f"({_ROADMAP_CODECS})") from e
    return to_rgb(pixels)


def encode_answer(image: np.ndarray) -> str:
    """uint8 RGB or RGBA pixels → base64 PNG."""
    from ..pipeline.images import encode_png

    return base64.b64encode(encode_png(np.ascontiguousarray(image))).decode()

"""The ControlNet inpaint preprocessors' hint and composites (port of
forge_tpu/pipeline/cn_inpaint.py, itself of Forge's
forge_preprocessor_inpaint).

Both "inpaint_global_harmonious" and "inpaint_only" mix the mask into the
hint: masked pixels become −1 (`mix_hint`). "inpaint_only" also, through a
deferred hook (`attach_inpaint_only`), encodes the source image with the
VAE and leaves `p._cn_inpaint`, which pipeline/processing.py reads twice:
each model call of a pass at the source latent's size composites x0 with it
outside the latent mask (an 8×8 max-pool of the pixel mask,
`latent_mask_from_pixels`), and each final image is pasted over the source
under the pixel mask dilated by a 7×7 square and box-blurred 7×7
(`composite_final`: OpenCV's `cv2.dilate` and `cv2.blur` rebuilt in scipy,
the dilation ignoring the border, the blur reflecting it as
BORDER_REFLECT_101 does). Latents and masks are NCHW; the host images HWC.
"""

from __future__ import annotations

import numpy as np
import torch

from ..preprocessors.cv import bilinear_resize

_FEATHER = 7  # the reference's dilate and blur size


def mix_hint(img_f: np.ndarray, mask_f: np.ndarray) -> np.ndarray:
    """img [H,W,3] in [0,1], mask [H,W] in [0,1] → the hint, masked pixels −1."""
    m = np.round(mask_f)[..., None]
    return img_f * (1.0 - m) - m


def latent_mask_from_pixels(mask_f: np.ndarray) -> np.ndarray:
    """[H,W] pixel mask → [1,1,H/8,W/8] latent mask, 1 where any pixel of
    the 8×8 cell is masked (1 = regenerate, 0 = keep)."""
    m = np.round(mask_f).astype(np.float32)
    h, w = m.shape
    m = m[: h - h % 8, : w - w % 8]
    m = m.reshape(h // 8, 8, w // 8, 8).max(axis=(1, 3))
    return np.round(m)[None, None]


def attach_inpaint_only(engine, p, img_u8: np.ndarray, mask_f: np.ndarray,
                        lama_shift: bool = False) -> None:
    """The deferred hook's body: the source image and mask at the
    request's size, the source's latent, and both composites armed;
    `lama_shift` (inpaint_only+lama, whose source is the LaMa pre-fill)
    also moves a txt2img pass's start toward that latent."""
    arr = bilinear_resize(np.asarray(img_u8, np.float32) / 255.0, p.height, p.width)
    mask = np.clip(bilinear_resize(np.repeat(np.asarray(mask_f, np.float32)[..., None], 3, 2),
                                   p.height, p.width)[..., 0], 0.0, 1.0)
    images = torch.from_numpy(np.ascontiguousarray((arr * 2.0 - 1.0).transpose(2, 0, 1)[None]))
    p._cn_inpaint = {
        "latent": engine.encode_first_stage(images),
        "latent_mask": torch.from_numpy(latent_mask_from_pixels(mask)).to(engine.device),
        "image": arr,  # [H,W,3] float in [0, 1], for the final composite
        "mask": mask,  # [H,W] float
        "lama_shift": bool(lama_shift),
    }
    p.extra_generation_params.setdefault("ControlNet inpaint", "inpaint_only")


def feather_mask(mask: np.ndarray) -> np.ndarray:
    """`cv2.blur(cv2.dilate(mask, ones(7, 7)), (7, 7))` clipped to [0, 1]:
    float32 [H,W]."""
    from scipy import ndimage

    mask = np.asarray(mask, np.float32)
    dilated = ndimage.maximum_filter(mask, size=_FEATHER, mode="constant", cval=-np.inf)
    return np.clip(ndimage.uniform_filter(dilated, size=_FEATHER, mode="mirror"), 0.0, 1.0)


def composite_final(p, img_u8: np.ndarray) -> np.ndarray:
    """An image pasted over the inpaint_only source under the feathered
    mask; as it is where the request has no inpaint_only state."""
    st = getattr(p, "_cn_inpaint", None)
    if st is None:
        return img_u8
    mask = feather_mask(st["mask"])[..., None]
    raw = st["image"]
    if raw.shape[:2] != img_u8.shape[:2]:
        raw = bilinear_resize(raw, img_u8.shape[0], img_u8.shape[1])
        mask = bilinear_resize(np.repeat(mask, 3, 2), img_u8.shape[0], img_u8.shape[1])[..., :1]
    out = raw * 255.0 * (1.0 - mask) + img_u8.astype(np.float32) * mask
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)

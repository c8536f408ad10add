# Copied from forge_tpu/models/swinir.py (the window helpers, the RSTB, both upsamplers, load_swinir and infer_swinir_meta), in PyTorch.
"""SwinIR super-resolution network (JingyunLiang/SwinIR network_swinir.py).

Shallow conv → K residual Swin transformer blocks (window attention with a
relative position bias, alternating shifted windows, each group closed by a
conv) → conv → residual → upsampler. Parameters are the official
checkpoints' keys, nested, in their own layout (linear [out, in], conv
OIHW). Convolutions run on NCHW; the transformer on tokens [B, H·W, C] in
row-major pixel order. Window attention is `torch.matmul` and a softmax over
all windows at once, as the reference's batched einsum is: no kernel.

Upsamplers: the classical "pixelshuffle" (`upsample.N` convs, each followed
by a ×2 shuffle) and the real-SR "nearest+conv" (`conv_up1`/`conv_up2`),
told apart by their keys. The shuffle is torch's `F.pixel_shuffle`, as
upstream trains it; the reference's reads the conv's channels in another
order, a fault the port does not inherit (tests/test_torch_swinir.py hands
the reference a copy with those channels reordered). Gelu is the exact
(erf) one in every dtype, as the reference's `approximate=False`. One conv closes each
RSTB (`layers.i.conv`): SwinIR-L's `resi_connection="3conv"`
(`conv.0/.2/.4`) raises ValueError at load, where the reference fails on
the missing `conv.weight` in the forward.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K's mean, subtracted before the network


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B,H,W,C] → [B·nW, ws², C], windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B·nW, ws², C] → [B,H,W,C]."""
    b = win.shape[0] // (h * w // ws // ws)
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' additive mask [nW, ws², ws²]: −100 between pixels
    of different regions (network_swinir calculate_mask)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def device_constant(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """`fn(*args)`, a numpy constant (a mask, an index), on `device`, made once:
    the reference's jit folds these into the program, and rebuilt on the host
    for every block of every tile they cost more than the attention."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def to_image(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H·W, C] → NCHW."""
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, h, w)


def to_tokens(img: torch.Tensor) -> torch.Tensor:
    """NCHW → [B, H·W, C]."""
    b, c = img.shape[:2]
    return img.reshape(b, c, -1).transpose(1, 2)


def mlp(p: Mapping[str, Any], x: torch.Tensor, fc1: str = "fc1", fc2: str = "fc2") -> torch.Tensor:
    return nn.linear(F.gelu(nn.linear(x, p[fc1])), p[fc2])


def window_attention(p: Mapping[str, Any], x: torch.Tensor, bias: torch.Tensor, heads: int,
                     mask=None) -> torch.Tensor:
    """x [nW, L, C]; bias [heads, L, L] added to the scores; mask [m, L, L]
    added per window (nW a multiple of m)."""
    nw, l, c = x.shape
    qkv = nn.linear(x, p["qkv"]).reshape(nw, l, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [nW, H, L, D]
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        m = mask.shape[0]
        attn = (attn.reshape(nw // m, m, heads, l, l) + mask[None, :, None].to(attn.dtype))
        attn = attn.reshape(nw, heads, l, l)
    attn = F.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(nw, l, c)
    return nn.linear(out, p["proj"])


def _rel_pos_bias(p: Mapping[str, Any], ws: int) -> torch.Tensor:
    """[heads, ws², ws²] from the trained table and the checkpoint's index."""
    index = p["relative_position_index"].reshape(-1).long()
    bias = p["relative_position_bias_table"][index].reshape(ws * ws, ws * ws, -1)
    return bias.permute(2, 0, 1)


def shifted_windows(x: torch.Tensor, ws: int, shift: int, attend) -> torch.Tensor:
    """Window attention over [B,H,W,C]: rolled by −shift, partitioned,
    `attend(windows, mask)`, reversed and rolled back."""
    b, h, w, c = x.shape
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = device_constant(shift_mask, (h, w, ws, shift), x.device)
    x = window_reverse(attend(window_partition(x, ws), mask), ws, h, w)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x


def _swin_block(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], ws: int,
                heads: int, shift: int) -> torch.Tensor:
    h, w = hw
    b, l, c = x.shape
    bias = _rel_pos_bias(p["attn"], ws)
    y = nn.layer_norm(x, p["norm1"]).reshape(b, h, w, c)
    y = shifted_windows(y, ws, shift, lambda win, mask: window_attention(
        p["attn"], win, bias, heads, mask))
    x = x + y.reshape(b, l, c)
    return x + mlp(p["mlp"], nn.layer_norm(x, p["norm2"]))


def group_conv(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The conv closing a residual group, on tokens."""
    return to_tokens(nn.conv2d(to_image(x, *hw), p, padding=1))


def _rstb(p: Mapping[str, Any], x: torch.Tensor, hw: Tuple[int, int], ws: int,
          heads: int) -> torch.Tensor:
    res = x
    blocks = p["residual_group"]["blocks"]
    for j in range(len(blocks)):
        x = _swin_block(blocks[str(j)], x, hw, ws, heads, 0 if j % 2 == 0 else ws // 2)
    return res + group_conv(p["conv"], x, hw)


def _reflect_index(n: int, pad: int) -> np.ndarray:
    i = np.arange(n + pad)
    if n == 1:
        return np.zeros_like(i)
    i = i % (2 * (n - 1))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def reflect_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad NCHW's bottom and right by reflection, as numpy's (and jnp's) "reflect"
    does for any size: past the edge the index walks back and forth."""
    h, w = x.shape[2:]
    return (x.index_select(2, device_constant(_reflect_index, (h, ph), x.device))
            .index_select(3, device_constant(_reflect_index, (w, pw), x.device)))


def pad_input(img: torch.Tensor, multiple: int, mean: bool = True):
    """NCHW in [0, 1] → (the mean taken off, reflect-padded to a multiple;
    the original height and width)."""
    h0, w0 = img.shape[2:]
    if mean:
        img = img - torch.tensor(RGB_MEAN, dtype=img.dtype, device=img.device).reshape(1, 3, 1, 1)
    ph, pw = (multiple - h0 % multiple) % multiple, (multiple - w0 % multiple) % multiple
    if ph or pw:
        img = reflect_pad(img, ph, pw)
    return img, h0, w0


def body(params: Mapping[str, Any], x: torch.Tensor, stage, patch_norm: str = "patch_embed"):
    """conv_first → tokens (the patch norm where the checkpoint has one) →
    `stage(layer, tokens, hw)` for each layer → norm → conv_after_body + the
    shallow feature."""
    x = nn.conv2d(x, params["conv_first"], padding=1)
    h, w = x.shape[2:]
    tokens = to_tokens(x)
    if patch_norm == "patch_embed" and "norm" in params.get("patch_embed", {}):
        tokens = nn.layer_norm(tokens, params["patch_embed"]["norm"])
    elif patch_norm in params:
        tokens = nn.layer_norm(tokens, params[patch_norm]["1"])
    layers = params["layers"]
    for i in range(len(layers)):
        tokens = stage(layers[str(i)], tokens, (h, w))
    tokens = nn.layer_norm(tokens, params["norm"])
    return nn.conv2d(to_image(tokens, h, w), params["conv_after_body"], padding=1) + x


def pixelshuffle_tail(params: Mapping[str, Any], x: torch.Tensor, scale: int) -> torch.Tensor:
    """conv_before_upsample (leaky 0.01) → each 4-d `upsample.N` conv and a
    shuffle → conv_last."""
    x = F.leaky_relu(nn.conv2d(x, params["conv_before_upsample"]["0"], padding=1), 0.01)
    ups = params["upsample"]
    for key in sorted(ups, key=int):
        if "weight" in ups[key] and ups[key]["weight"].dim() == 4:
            x = F.pixel_shuffle(nn.conv2d(x, ups[key], padding=1), 2 if scale in (2, 4, 8) else 3)
    return nn.conv2d(x, params["conv_last"], padding=1)


def swinir_apply(params: Mapping[str, Any], img: torch.Tensor, window_size: int = 8,
                 heads: int = 6, scale: int = 4) -> torch.Tensor:
    """img [B,3,H,W] in [0, 1] → upscaled [B,3,sH,sW] (SwinIR.forward)."""
    x, h0, w0 = pad_input(img, window_size)
    x = body(params, x, lambda p, t, hw: _rstb(p, t, hw, window_size, heads))
    if "conv_up1" in params:  # real-SR "nearest+conv"
        x = F.leaky_relu(nn.conv2d(x, params["conv_before_upsample"]["0"], padding=1), 0.01)
        for key in ("conv_up1", "conv_up2")[: 2 if scale == 4 else 1]:
            x = F.leaky_relu(nn.conv2d(nn.upsample_nearest_2x(x), params[key], padding=1), 0.2)
        x = F.leaky_relu(nn.conv2d(x, params["conv_hr"], padding=1), 0.2)
        x = nn.conv2d(x, params["conv_last"], padding=1)
    elif "upsample" in params:  # classical pixelshuffle
        x = pixelshuffle_tail(params, x, scale)
    else:  # lightweight, one step
        x = nn.conv2d(x, params["conv_last"], padding=1)
    out = x + torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    return out[:, :, : h0 * scale, : w0 * scale]


def unwrap(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    """A released checkpoint's `params_ema` or `params` wrapper, unwrapped."""
    for wrap in ("params_ema", "params"):
        if isinstance(sd.get(wrap), dict):
            return sd[wrap]
    return sd


def load_swinir(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint's state dict → the nested tree (the `params`/`params_ema`
    wrapper unwrapped, `attn_mask` buffers dropped: recomputed per shape). A
    `3conv` checkpoint raises ValueError."""
    from ..core.convert import nest

    sd = unwrap(sd)
    if any(k.startswith("layers.") and ".conv.0." in k and ".residual_group." not in k
           for k in sd):
        raise ValueError("SwinIR resi_connection '3conv' (layers.N.conv.0/.2/.4, SwinIR-L) is "
                         "not ported: the reference reads one conv a group (ROADMAP.md queue 1 "
                         "item 9)")
    return nest({k: v for k, v in sd.items() if not k.endswith("attn_mask")})


def upsample_scale(params: Mapping[str, Any]) -> int:
    """2 to the number of 4-d `upsample.N` convs."""
    return 2 ** sum(1 for v in params["upsample"].values()
                    if isinstance(v, dict) and v.get("weight") is not None
                    and v["weight"].dim() == 4)


def infer_swinir_meta(params: Mapping[str, Any]) -> Dict[str, int]:
    """(window size, heads, scale) from the checkpoint's shapes."""
    table = params["layers"]["0"]["residual_group"]["blocks"]["0"]["attn"][
        "relative_position_bias_table"]
    ws = (int(np.sqrt(table.shape[0])) + 1) // 2
    if "conv_up2" in params:
        scale = 4
    elif "conv_up1" in params:
        scale = 2
    elif "upsample" in params:
        scale = upsample_scale(params)
    else:
        scale = 1
    return {"window_size": ws, "heads": int(table.shape[1]), "scale": scale}

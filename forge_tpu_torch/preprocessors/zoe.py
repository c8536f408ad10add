"""ZoeDepth metric depth (depth_zoe), ZoeD_M12_N (port of
forge_tpu/preprocessors/zoe.py).

The published ZoeDepth-N the reference's zoe annotator loads
(annotator/zoe/zoedepth/models/zoedepth/zoedepth_v1.py): a MiDaS 3.1
DPT-BEiT-L/384 relative-depth core whose decoder taps feed the metric-bins
head: the seed bin regressor (softplus), four inverse-attractor refinements
(mean aggregation, gamma 2, alpha 300: the reference's attractor layers
never hand their configured 1000 to the scripted function, whose default
is 300) and a conditional log-binomial over the bins. Block count, width,
heads, tap features and bin counts come from the checkpoint.

The BEiT attention adds each block's relative position bias (its table
resized bilinearly where the window is not the trained one, as
midas/backbones/beit.py:_get_rel_pos_bias does, through ops/resize.py), so
it stays plain, as the reference's does. The inference follows the
reference: the reflect pad augmentation (depth_model.py:_infer_with_pad_aug,
pad = sqrt(side/2)·3), the horizontal flip averaged as a batch of two, the
keep-aspect multiple-of-32 resize to cover the 384×512 net size by OpenCV's
INTER_CUBIC (preprocessors/cv2_np.py), and the annotator's 2 %/85 %
percentile normalization, inverted.

Checkpoint: the first .pt/.safetensors under models/zoedepth (ZoeD_M12_N.pt:
its `model` dict; `model.` dropped, the relative_position_index buffers and
the k_bias the reference never reads left out).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize
from . import cv2_np
from .annotator import Detector, inference, resize_align, to_numpy
from .cv import resize_image

# -- the backbone ---------------------------------------------------------------------


def _gen_rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """timm's gen_relative_position_index: [(N+1),(N+1)] table rows, the
    last three serving the class token's interactions."""
    num_rel = (2 * wh - 1) * (2 * ww - 1)
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


_INDEX: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _rel_pos_bias(p_attn: Mapping[str, Any], window: Tuple[int, int]) -> torch.Tensor:
    """A block's relative position bias [heads, N+1, N+1] at `window`, its
    trained table resized bilinearly where the window differs."""
    table = p_attn["relative_position_bias_table"]  # [(2s-1)^2 + 3, heads]
    rows, heads = table.shape
    side = int((np.sqrt(rows - 3) + 1) / 2)
    wh, ww = window
    new_h, new_w = 2 * wh - 1, 2 * ww - 1
    sub, extra = table[: rows - 3], table[rows - 3:]
    if (new_h, new_w) != (2 * side - 1, 2 * side - 1):
        grid = sub.reshape(2 * side - 1, 2 * side - 1, heads).permute(2, 0, 1)
        grid = resize(grid.float(), (new_h, new_w), "bilinear").to(sub.dtype)
        sub = grid.permute(1, 2, 0).reshape(new_h * new_w, heads)
    full = torch.cat([sub, extra], dim=0)
    key = (wh, ww, str(table.device))
    if key not in _INDEX:
        _INDEX[key] = torch.from_numpy(_gen_rel_pos_index(wh, ww).reshape(-1)).to(table.device)
    n = wh * ww + 1
    return full[_INDEX[key]].reshape(n, n, heads).permute(2, 0, 1)


def _beit_block(p: Mapping[str, Any], x: torch.Tensor, bias: torch.Tensor,
                heads: int) -> torch.Tensor:
    b, n, c = x.shape
    h = nn.layer_norm(x, p["norm1"], eps=1e-6)
    qb = p["attn"]["q_bias"]
    qkv = nn.linear(h, {"weight": p["attn"]["qkv"]["weight"],
                        "bias": torch.cat([qb, torch.zeros_like(qb), p["attn"]["v_bias"]])})
    q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    att = ((q * (c // heads) ** -0.5) @ k.transpose(-1, -2)).float() + bias.float()[None]
    h = (torch.softmax(att, dim=-1).to(v.dtype) @ v).transpose(1, 2).reshape(b, n, c)
    x = x + p["gamma_1"].to(x.dtype) * nn.linear(h, p["attn"]["proj"])
    h = nn.layer_norm(x, p["norm2"], eps=1e-6)
    h = nn.linear(F.gelu(nn.linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return x + p["gamma_2"].to(x.dtype) * h


def _project_readout(pp: Mapping[str, Any], tokens: torch.Tensor, gh: int, gw: int):
    """DPT's ProjectReadout and unflatten: [B,1+N,C] → [B,C',gh,gw]."""
    cls, patches = tokens[:, :1], tokens[:, 1:]
    h = F.gelu(nn.linear(torch.cat([patches, cls.expand_as(patches)], dim=-1),
                         pp["0"]["project"]["0"]))
    return h.transpose(1, 2).reshape(h.shape[0], -1, gh, gw)


def _rcu(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = nn.conv2d(F.relu(x), p["conv1"], padding=1)
    return x + nn.conv2d(F.relu(h), p["conv2"], padding=1)


def _fusion(p: Mapping[str, Any], x: torch.Tensor, skip: Optional[torch.Tensor], size):
    """FeatureFusionBlock_custom with an explicit output size (MiDaS 3.1
    blocks.py:410-436, align_corners=True)."""
    if skip is not None:
        x = x + _rcu(p["resConfUnit1"], skip)
    return nn.conv2d(resize_align(_rcu(p["resConfUnit2"], x), size), p["out_conv"])


def _dpt_beit(p: Mapping[str, Any], x: torch.Tensor):
    """The DPT-BEiT core → (relative depth [B,H,W], the MidasCore taps
    'out_conv', 'l4_rn', 'r4', 'r3', 'r2', 'r1' (zoe midas.py:191))."""
    pm = p["pretrained"]["model"]
    proj = pm["patch_embed"]["proj"]
    emb = nn.conv2d(x, proj, stride=proj["weight"].shape[-1])
    b, c, gh, gw = emb.shape
    heads = pm["blocks"]["0"]["attn"]["relative_position_bias_table"].shape[1]
    tokens = torch.cat([pm["cls_token"].reshape(1, 1, c).expand(b, 1, c).to(emb.dtype),
                        emb.flatten(2).transpose(1, 2)], dim=1)
    n_blocks = len(pm["blocks"])
    hooks = [n_blocks // 4 - 1, n_blocks // 2 - 1, 3 * n_blocks // 4 - 1, n_blocks - 1]
    acts = []
    for i in range(n_blocks):
        blk = pm["blocks"][str(i)]
        tokens = _beit_block(blk, tokens, _rel_pos_bias(blk["attn"], (gh, gw)), heads)
        if i in hooks:
            acts.append(tokens)

    post = p["pretrained"]
    lv = []
    for j in range(4):
        pp = post[f"act_postprocess{j + 1}"]
        h = nn.conv2d(_project_readout(pp, acts[j], gh, gw), pp["3"])
        if j == 0:
            h = nn.conv2d_transpose(h, pp["4"], stride=4)
        elif j == 1:
            h = nn.conv2d_transpose(h, pp["4"], stride=2)
        elif j == 3:
            h = nn.conv2d(h, pp["4"], stride=2, padding=1)
        lv.append(h)
    sc = p["scratch"]
    rn1, rn2, rn3, rn4 = (nn.conv2d(lv[j], sc[f"layer{j + 1}_rn"], padding=1) for j in range(4))
    r4 = _fusion(sc["refinenet4"], rn4, None, rn3.shape[2:])
    r3 = _fusion(sc["refinenet3"], r4, rn3, rn2.shape[2:])
    r2 = _fusion(sc["refinenet2"], r3, rn2, rn1.shape[2:])
    r1 = _fusion(sc["refinenet1"], r2, rn1, (rn1.shape[2] * 2, rn1.shape[3] * 2))
    out = sc["output_conv"]
    h = nn.conv2d(r1, out["0"], padding=1)
    h = resize_align(h, (h.shape[2] * 2, h.shape[3] * 2))
    out_conv_act = F.relu(nn.conv2d(h, out["2"], padding=1))
    rel = F.relu(nn.conv2d(out_conv_act, out["4"]))[:, 0]
    return rel, {"out_conv": out_conv_act, "l4_rn": rn4, "r4": r4, "r3": r3, "r2": r2, "r1": r1}


# -- the metric head --------------------------------------------------------------------


def _mlp2(pp: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """conv1×1 → relu → conv1×1 (the head layers' shared `_net`)."""
    return nn.conv2d(F.relu(nn.conv2d(x, pp["0"])), pp["2"])


def _log_binomial(p: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """LogBinomial (dist_layers.py:9-37) over the channel axis: the softmax
    over k classes of the binomial log-pmf with Stirling's log-nCk, at
    temperature t; the Stirling term in numpy float32, as the reference."""
    eps = 1e-4
    k_np = np.arange(k, dtype=np.float32)
    n = np.float32(k - 1) + np.float32(1e-7)
    kk = k_np + np.float32(1e-7)
    log_binom = torch.from_numpy(
        n * np.log(n) - kk * np.log(kk) - (n - kk) * np.log(n - kk + np.float32(1e-7))
    ).to(p.device)[None, :, None, None]
    k_idx = torch.arange(k, dtype=torch.float32, device=p.device)[None, :, None, None]
    one_minus = (1.0 - p).clamp(eps, 1.0)
    p = p.clamp(eps, 1.0)
    y = log_binom + k_idx * torch.log(p) + (k - 1 - k_idx) * torch.log(one_minus)
    return torch.softmax(y / t, dim=1)


def zoe_head(params: Mapping[str, Any], rel_depth: torch.Tensor,
             taps: Mapping[str, torch.Tensor], alpha: float = 300.0, gamma: int = 2,
             min_temp: float = 0.0212, max_temp: float = 50.0) -> torch.Tensor:
    """The metric-bins head over the MidasCore taps (zoedepth_v1.py:124-198),
    in f32 → metric depth [B,H,W]."""
    xd0 = nn.conv2d(taps["l4_rn"], params["conv2"])
    b_prev = F.softplus(_mlp2(params["seed_bin_regressor"]["_net"], xd0).float())
    prev_emb = _mlp2(params["seed_projector"]["_net"], xd0)
    emb = prev_emb
    for i, tap in enumerate([taps["r4"], taps["r3"], taps["r2"], taps["r1"]]):
        emb = _mlp2(params["projectors"][str(i)]["_net"], tap)
        h = emb + resize_align(prev_emb, tap.shape[2:])
        attr = F.softplus(_mlp2(params["attractors"][str(i)]["_net"], h).float())  # [B,nA,h,w]
        centers = resize_align(b_prev, tap.shape[2:])                            # [B,nbins,h,w]
        dx = attr[:, :, None] - centers[:, None]                                 # [B,nA,nbins,h,w]
        b_prev = centers + (dx / (1.0 + alpha * dx ** gamma)).mean(dim=1)
        prev_emb = emb
    out_conv = taps["out_conv"]
    last = torch.cat([out_conv, resize_align(rel_depth[:, None], out_conv.shape[2:])], dim=1)
    cond = resize_align(emb, last.shape[2:])
    mlp = params["conditional_log_binomial"]["mlp"]
    pt = nn.conv2d(torch.cat([last, cond], dim=1), mlp["0"])
    pt = F.softplus(nn.conv2d(F.gelu(pt), mlp["2"]).float())
    pp = pt[:, :2] + 1e-4
    prob = pp[:, 0] / (pp[:, 0] + pp[:, 1])
    tt = pt[:, 2:] + 1e-4
    temp = (max_temp - min_temp) * (tt[:, 0] / (tt[:, 0] + tt[:, 1])) + min_temp
    probs = _log_binomial(prob[:, None], temp[:, None], b_prev.shape[1])
    return (probs * resize_align(b_prev, probs.shape[2:])).sum(dim=1)


def zoe_apply(params: Mapping[str, Any], x: torch.Tensor, **head) -> torch.Tensor:
    """A normalized image [B,3,H,W] (mean and std 0.5, H, W % 32 == 0) →
    metric depth [B,H,W] f32 (the constants of config_zoedepth.json but
    alpha, see the module)."""
    rel_depth, taps = _dpt_beit(params["core"]["core"], x)
    return zoe_head(params, rel_depth, taps, **head)


# -- the detector ---------------------------------------------------------------------


def _net_size(h: int, w: int, net_h: int = 384, net_w: int = 512) -> Tuple[int, int]:
    """The keep-aspect multiple-of-32 'minimal' target (midas.py Resize):
    scaled to cover the net size, rounded to 32."""
    scale = max(net_h / h, net_w / w)
    return (max(32, int(round(h * scale / 32)) * 32), max(32, int(round(w * scale / 32)) * 32))


def _convert(sd):
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if "relative_position_index" not in k and "attn.k_bias" not in k}


class ZoeDetector(Detector):
    DTYPE = torch.bfloat16  # PERF.md §4

    def __init__(self, model_dir: str = "models/zoedepth", net_h: int = 384,
                 net_w: int = 512, **kw):
        super().__init__(model_dir, suffixes=(".pt", ".safetensors"), convert=_convert,
                         missing="no ZoeDepth checkpoint", **kw)
        self.net_h, self.net_w = net_h, net_w

    def detect(self, img: np.ndarray) -> np.ndarray:
        """uint8 [H,W,3] → the inverted percentile-normalized depth uint8 [H,W,3]."""
        params = self.load()
        h, w = img.shape[:2]
        pad_h, pad_w = int(np.sqrt(h / 2) * 3), int(np.sqrt(w / 2) * 3)
        padded = np.pad(img.astype(np.float32) / 255.0,
                        ((pad_h, pad_h), (pad_w, pad_w), (0, 0)), mode="reflect")
        ph, pw = padded.shape[:2]
        nh, nw = _net_size(ph, pw, self.net_h, self.net_w)
        feed = (cv2_np.resize(padded, (nw, nh), cv2_np.INTER_CUBIC) - 0.5) / 0.5
        x = self.image_tensor(feed)
        with inference():  # the flip augmentation as a batch of two
            depth = to_numpy(zoe_apply(params, torch.cat([x, x.flip(3)])))
        depth = 0.5 * (depth[0] + depth[1][:, ::-1])
        depth = cv2_np.resize(np.ascontiguousarray(depth, np.float32), (pw, ph),
                              cv2_np.INTER_CUBIC)
        depth = depth[pad_h:ph - pad_h, pad_w:pw - pad_w]
        vmin, vmax = np.percentile(depth, 2), np.percentile(depth, 85)
        depth = (depth - vmin) / max(vmax - vmin, 1e-6)
        out = ((1.0 - depth) * 255.0).clip(0, 255).astype(np.uint8)
        return np.repeat(out[..., None], 3, axis=2)


_DETECTOR: Optional[ZoeDetector] = None


def get_zoe(device=None) -> ZoeDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = ZoeDetector(device=device)
    return _DETECTOR


def depth_zoe(img, res, a, b):
    return np.asarray(get_zoe().detect(resize_image(img, res)), np.float32) / 255.0

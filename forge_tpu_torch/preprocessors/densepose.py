"""DensePose R50-FPN DeepLab (the densepose entries) (port of
forge_tpu/preprocessors/densepose.py).

The reference rebuilds the torchscript-only densepose_r50_fpn_dl model of
the legacy preprocessors as detectron2's GeneralizedRCNN with a DensePose
DeepLab head, its widths taken from the checkpoint:
  1. ResNet-50 with frozen BatchNorm (stride on the 3×3 conv) → C2..C5;
  2. the FPN: 1×1 laterals, nearest ×2 top-down, 3×3 outputs → P2..P5,
     P6 a stride-2 max pool of P5;
  3. the RPN head on each level; anchors, the delta decode, each level's
     top 1000 and NMS on the host (numpy);
  4. the box head: ROIAlign 7×7 on the box's FPN level, two FCs, the
     person score and the box deltas → host NMS, at most 8 boxes;
  5. the DeepLab head on those boxes: ROIAlign 28×28, the ASPP branches,
     the projection and the stacked 3×3 convs, the four 4×4 transpose-conv
     predictors, ×2 bilinear;
  6. the IUV painting of the reference's MatrixVisualizer: the coarse and
     fine maps resized into each box (OpenCV's INTER_LINEAR, cv2_np.py),
     the fine argmax where the coarse argmax is the person, part × 255/24
     through OpenCV's viridis or parula table (cv2_np.py
     `apply_color_map`), viridis's zero channels set to (68, 1, 84).

Kept as the reference has them: the image resized into a fixed 800²
canvas (BGR minus the pixel mean, zeros past the image), convolutions and
pools padded as XLA's "SAME" (bottom and right take the odd pixel, where
detectron2 pads both sides), ROIAlign on a fixed 2×2 sample grid a bin
(aligned, half-pixel), the box head's FC reading the pooled map in (h, w,
c) order, the box head on 64 padded proposals and the DeepLab head on 8
padded boxes, the ASPP branches by name (ASPP1..ASPP4 at dilations 1, 6,
12, 18 where 3×3, ASPP_pool the global average) and the head's convs with
their biases and no norm. The network is plain torch: no kernel.

Checkpoint: the first .pt/.pth/.safetensors under models/densepose, its
keys with or without detectron2's `model.` prefix.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize
from . import cv2_np
from .annotator import Detector, inference
from .cv import resize_image

# detectron2's defaults for densepose_rcnn_R_50_FPN_DL_s1x
_PIXEL_MEAN = np.array([103.53, 116.28, 123.675], np.float32)  # BGR
_ANCHOR_SIZES = (32, 64, 128, 256, 512)  # a level, P2..P6
_ASPECTS = (0.5, 1.0, 2.0)
_PRE_NMS_TOPK = 1000
_POST_NMS_TOPK = 1000
_RPN_NMS_T = 0.7
_SCORE_T = 0.5
_BOX_NMS_T = 0.5
_MAX_DET = 8
_CANVAS = 800
_N_PARTS = 24
_BOX_BATCH = 64  # the box head's padded proposals
_ASPP_DILATIONS = {"ASPP1": 1, "ASPP2": 6, "ASPP3": 12, "ASPP4": 18}


# -- host box utilities ---------------------------------------------------------


def _decode(anchors: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """detectron2 Box2BoxTransform.apply_deltas, weights (1, 1, 1, 1)."""
    w = anchors[:, 2] - anchors[:, 0]
    h = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + 0.5 * w
    cy = anchors[:, 1] + 0.5 * h
    dx, dy, dw, dh = deltas[:, 0], deltas[:, 1], deltas[:, 2], deltas[:, 3]
    dw = np.minimum(dw, 4.135)  # log(1000 / 16)
    dh = np.minimum(dh, 4.135)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = np.exp(dw) * w
    ph = np.exp(dh) * h
    return np.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], axis=1)


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> List[int]:
    order = np.argsort(-scores)
    keep: List[int] = []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= thresh]
    return keep


def _anchors_for(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """A grid of three anchors a cell (detectron2 DefaultAnchorGenerator)."""
    cell: List[List[float]] = []
    area = float(size * size)
    for ar in _ASPECTS:
        aw = np.sqrt(area / ar)
        ah = aw * ar
        cell.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    cell_a = np.array(cell, np.float32)
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift = np.stack(np.broadcast_arrays(sx[None, :], sy[:, None], sx[None, :], sy[:, None]),
                     axis=-1)
    return (shift[:, :, None, :] + cell_a[None, None]).reshape(-1, 4)


# -- the network ----------------------------------------------------------------


def _same_pad(x: torch.Tensor, k: int, stride: int, dilation: int = 1, value: float = 0.0):
    """XLA's "SAME" padding of NCHW x for a k×k window: the output ceil(size / stride), the odd
    pixel of the padding at the bottom and right."""
    eff = (k - 1) * dilation + 1
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + eff - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _frozen_bn(x: torch.Tensor, p) -> torch.Tensor:
    n = p["norm"]
    scale = n["weight"].float() * torch.rsqrt(n["running_var"].float() + 1e-5)
    shift = n["bias"].float() - n["running_mean"].float() * scale
    return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


def _conv(x: torch.Tensor, p, stride: int = 1, dilation: int = 1, bn: bool = True,
          relu: bool = False) -> torch.Tensor:
    k = p["weight"].shape[-1]
    y = F.conv2d(_same_pad(x, k, stride, dilation), p["weight"].to(x.dtype), stride=stride,
                 dilation=dilation)
    if bn and "norm" in p:
        y = _frozen_bn(y, p)
    elif "bias" in p:
        y = y + p["bias"].to(y.dtype)[None, :, None, None]
    return F.relu(y) if relu else y


def _bottleneck(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    out = _conv(x, p["conv1"], relu=True)
    out = _conv(out, p["conv2"], stride=stride, relu=True)
    out = _conv(out, p["conv3"])
    sc = _conv(x, p["shortcut"], stride=stride) if "shortcut" in p else x
    return F.relu(out + sc)


def _max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(_same_pad(x, k, stride, value=-math.inf), k, stride)


def _resnet_fpn(params, x: torch.Tensor) -> Dict[int, torch.Tensor]:
    """x [1, 3, H, W] (BGR minus the mean) → {2: P2, …, 6: P6}, NCHW, 256 channels."""
    bu = params["backbone"]["bottom_up"]
    h = _max_pool_same(_conv(x, bu["stem"]["conv1"], stride=2, relu=True), 3, 2)
    feats = {}
    for si, stage in enumerate(("res2", "res3", "res4", "res5")):
        blocks = bu[stage]
        for bi in range(len(blocks)):
            h = _bottleneck(h, blocks[str(bi)], stride=2 if bi == 0 and si > 0 else 1)
        feats[si + 2] = h
    fpn = params["backbone"]
    out: Dict[int, torch.Tensor] = {}
    prev = None
    for lvl in (5, 4, 3, 2):
        lat = _conv(feats[lvl], fpn[f"fpn_lateral{lvl}"], bn=False)
        if prev is not None:
            up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            lat = lat + up[:, :, :lat.shape[2], :lat.shape[3]]
        prev = lat
        out[lvl] = _conv(lat, fpn[f"fpn_output{lvl}"], bn=False)
    out[6] = _max_pool_same(out[5], 1, 2)
    return out


def _rpn_level(params, feat: torch.Tensor):
    rh = params["proposal_generator"]["rpn_head"]
    t = _conv(feat, rh["conv"], bn=False, relu=True)
    return _conv(t, rh["objectness_logits"], bn=False), _conv(t, rh["anchor_deltas"], bn=False)


def _roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int, stride: int):
    """[N, 4] xyxy canvas boxes → [N, C, out, out]: a fixed 2×2 sample grid
    a bin, bilinear, aligned (the half-pixel offset of detectron2's ROIAlignV2)."""
    n = boxes.shape[0]
    c, fh, fw = feat.shape[1:]
    b = boxes.float() / stride
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = torch.clamp(x1 - x0, min=1e-4) / out_size
    bh = torch.clamp(y1 - y0, min=1e-4) / out_size
    gi = torch.arange(out_size, dtype=torch.float32, device=feat.device)
    offs = torch.tensor([0.25, 0.75], dtype=torch.float32, device=feat.device)
    ys = (y0[:, None, None] + (gi[None, :, None] + offs[None, None]) * bh[:, None, None])
    xs = (x0[:, None, None] + (gi[None, :, None] + offs[None, None]) * bw[:, None, None])
    ys = ys.reshape(n, out_size * 2) - 0.5
    xs = xs.reshape(n, out_size * 2) - 0.5

    def bilin(coord, size):
        c0 = torch.clamp(torch.floor(coord), 0, size - 1)
        c1 = torch.clamp(c0 + 1, 0, size - 1)
        return c0.long(), c1.long(), torch.clamp(coord - c0, 0.0, 1.0)

    yl, yh, fy = bilin(ys, fh)
    xl, xh, fx = bilin(xs, fw)
    f0 = feat[0].permute(1, 2, 0)  # [fh, fw, C]
    s = out_size * 2
    rows = (f0[yl] * (1 - fy).to(f0.dtype)[:, :, None, None]
            + f0[yh] * fy.to(f0.dtype)[:, :, None, None])  # [N, S, fw, C]
    pick = lambda idx: torch.gather(rows, 2, idx[:, None, :, None].expand(n, s, s, c))  # noqa: E731
    g = (pick(xl) * (1 - fx).to(f0.dtype)[:, None, :, None]
         + pick(xh) * fx.to(f0.dtype)[:, None, :, None])  # [N, S, S, C]
    g = g.reshape(n, out_size, 2, out_size, 2, c).mean(dim=(2, 4))
    return g.permute(0, 3, 1, 2)


def _roi_align_multilevel(pyramid, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Each box on its level: floor(4 + log2(√area / 224)), clamped to 2..5."""
    areas = (torch.clamp(boxes[:, 2] - boxes[:, 0], min=0)
             * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0))
    lvl = torch.clamp(torch.floor(4.0 + torch.log2(torch.sqrt(areas) / 224.0 + 1e-8)), 2, 5).long()
    outs = torch.stack([_roi_align(pyramid[lv], boxes, out_size, 2 ** lv) for lv in (2, 3, 4, 5)])
    return outs[lvl - 2, torch.arange(boxes.shape[0], device=boxes.device)]


def _box_head(params, pooled: torch.Tensor):
    rh = params["roi_heads"]
    n = pooled.shape[0]
    h = pooled.permute(0, 2, 3, 1).reshape(n, -1)  # the reference's (h, w, c) order
    h = F.relu(nn.linear(h, rh["box_head"]["fc1"]))
    h = F.relu(nn.linear(h, rh["box_head"]["fc2"]))
    scores = nn.linear(h, rh["box_predictor"]["cls_score"])
    deltas = nn.linear(h, rh["box_predictor"]["bbox_pred"])
    return torch.softmax(scores.float(), dim=-1), deltas.float()


def _aspp(p, x: torch.Tensor) -> torch.Tensor:
    """The ASPP branches in the order of their names, concatenated on channels."""
    branches = []
    for key in sorted(p.keys()):
        q = p[key]
        if key.startswith("ASPP_pool") or "pooling" in key:
            g = _conv(x.mean(dim=(2, 3), keepdim=True), q, bn=False, relu=True)
            branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        else:
            k = q["weight"].shape[-1]
            dil = _ASPP_DILATIONS.get(key, 1) if k == 3 else 1
            branches.append(_conv(x, q, dilation=dil, bn=False, relu=True))
    return torch.cat(branches, dim=1)


def _densepose_head(params, pooled: torch.Tensor):
    """[N, 256, 28, 28] → coarse [N, 2, h, w], fine [N, 25, h, w], u, v (h = w = 112)."""
    rh = params["roi_heads"]
    h = pooled
    head = rh.get("densepose_head", {})
    if "ASPP" in head:
        h = _aspp(head["ASPP"], h)
        if "project" in head:
            h = _conv(h, head["project"], bn=False, relu=True)
    i = 1
    while f"body_conv_fcn{i}" in head or f"conv_fcn{i}" in head:
        key = f"body_conv_fcn{i}" if f"body_conv_fcn{i}" in head else f"conv_fcn{i}"
        h = _conv(h, head[key], bn=False, relu=True)
        i += 1
    pred = rh["densepose_predictor"]

    def up2(name):  # the 4×4 stride-2 transpose conv, then the predictor's ×2 bilinear
        t = nn.conv2d_transpose(h, pred[name], stride=2, padding=1)
        return resize(t, (t.shape[2] * 2, t.shape[3] * 2), "bilinear")

    return tuple(up2(k) for k in ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres"))


# -- painting (the reference's densepose.py MatrixVisualizer.visualize) ----------


def paint_iuv(canvas: np.ndarray, labels: np.ndarray, box_xywh: Tuple[int, int, int, int],
              cmap: str = "viridis") -> np.ndarray:
    """Part labels painted into the RGB canvas in place, as MatrixVisualizer
    with alpha 1 and val_scale 255/24: label·255/24 through OpenCV's table;
    label 0 keeps the canvas."""
    x, y, w, h = box_xywh
    ch, cw = canvas.shape[:2]
    x = max(0, min(x, cw - 1))
    y = max(0, min(y, ch - 1))
    w = min(w, cw - x)
    h = min(h, ch - y)
    if w <= 0 or h <= 0:
        return canvas
    lab = labels[:h, :w]
    scaled = np.clip(lab.astype(np.float32) * (255.0 / _N_PARTS), 0, 255).astype(np.uint8)
    colored = cv2_np.apply_color_map(scaled, cmap)[..., ::-1]  # BGR → RGB
    region = canvas[y:y + h, x:x + w]
    mask = lab > 0
    region[mask] = colored[mask]
    return canvas


def _labels_for_box(coarse: np.ndarray, fine: np.ndarray, h: int, w: int) -> np.ndarray:
    """resample_fine_and_coarse_segm_tensors_to_bbox: both maps [h', w', C] bilinear to (h,
    w), the fine argmax where the coarse argmax is the person."""
    cb = cv2_np.resize(coarse, (w, h), cv2_np.INTER_LINEAR)
    fb = cv2_np.resize(fine, (w, h), cv2_np.INTER_LINEAR)
    return fb.argmax(axis=-1) * (cb.argmax(axis=-1) > 0)


def _strip_model(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


class DensePoseDetector(Detector):
    """The R50-FPN DeepLab detector; `load(params=…)` takes weights already
    nested (made from a seed)."""

    DTYPE = torch.float32  # in bf16 the boxes' labels differ from f32's (PERF.md §4)

    def __init__(self, model_dir: str = "models/densepose", **kw):
        super().__init__(model_dir, convert=_strip_model,
                         missing="no DensePose checkpoint", **kw)

    def load(self, params: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        if params is not None and self.params is None:
            from ..core.convert import tree_to

            self.params = tree_to(params, *self.placement())
        return super().load()

    def detections(self, img: np.ndarray) -> List[Tuple[Tuple[int, int, int, int], np.ndarray]]:
        """uint8 RGB [H, W, 3] → each kept box, (x, y, w, h) in the image's
        pixels, with its part labels [h, w] (0 off the person)."""
        params = self.load()
        hh, ww = img.shape[:2]
        scale = _CANVAS / max(hh, ww)
        nh, nw = int(round(hh * scale)), int(round(ww * scale))
        resized = cv2_np.resize(img, (nw, nh), cv2_np.INTER_LINEAR)
        canvas_in = np.zeros((_CANVAS, _CANVAS, 3), np.float32)
        canvas_in[:nh, :nw] = resized[..., ::-1].astype(np.float32) - _PIXEL_MEAN
        x = self.image_tensor(canvas_in)
        with inference():
            pyramid = _resnet_fpn(params, x)
            per_level = {lv: _rpn_level(params, pyramid[lv]) for lv in pyramid}
            logits = {lv: t[0].permute(0, 2, 3, 1).float().cpu().numpy()
                      for lv, t in per_level.items()}
            deltas = {lv: t[1].permute(0, 2, 3, 1).float().cpu().numpy()
                      for lv, t in per_level.items()}
            boxes = self._proposals_to_boxes(params, logits, deltas, (nh, nw), pyramid)
            if not boxes.shape[0]:
                return []
            padded = np.zeros((_MAX_DET, 4), np.float32)
            padded[:boxes.shape[0]] = boxes[:_MAX_DET]
            pooled = _roi_align_multilevel(pyramid, torch.from_numpy(padded).to(x.device), 28)
            coarse, fine = [t.permute(0, 2, 3, 1).float().cpu().numpy()
                            for t in _densepose_head(params, pooled.to(x.dtype))[:2]]
        out = []
        for bi in range(min(boxes.shape[0], _MAX_DET)):
            bx = boxes[bi] / scale  # back to the image's coordinates
            w = max(int(bx[2] - bx[0]), 1)
            h = max(int(bx[3] - bx[1]), 1)
            out.append(((int(bx[0]), int(bx[1]), w, h),
                        _labels_for_box(coarse[bi], fine[bi], h, w)))
        return out

    def detect(self, img: np.ndarray, cmap: str = "viridis") -> np.ndarray:
        """uint8 RGB [H, W, 3] → the uint8 RGB IUV hint (viridis: its zero
        channels (68, 1, 84), as the reference's entry sets them)."""
        canvas = np.zeros(img.shape[:2] + (3,), np.uint8)
        for box, labels in self.detections(img):
            paint_iuv(canvas, labels, box, cmap=cmap)
        if cmap == "viridis":  # the reference's __init__.py:44-46: zero channels → viridis(0)
            for c, v in enumerate((68, 1, 84)):
                chan = canvas[:, :, c]
                chan[chan == 0] = v
        return canvas

    def _proposals_to_boxes(self, params, logits, deltas, hw, pyramid) -> np.ndarray:
        nh, nw = hw
        all_boxes, all_scores = [], []
        for li, lvl in enumerate((2, 3, 4, 5, 6)):
            if lvl not in logits:
                continue
            lg = logits[lvl][0]  # [h, w, A]
            dl = deltas[lvl][0]  # [h, w, 4A]
            h, w, a = lg.shape
            anchors = _anchors_for(h, w, 2 ** lvl, _ANCHOR_SIZES[li])
            lg_f = lg.reshape(-1)
            dl_f = dl.reshape(h * w, a, 4).reshape(-1, 4)
            k = min(_PRE_NMS_TOPK, lg_f.size)
            top = np.argpartition(-lg_f, k - 1)[:k]
            bx = _decode(anchors[top], dl_f[top])
            bx[:, 0::2] = bx[:, 0::2].clip(0, nw)
            bx[:, 1::2] = bx[:, 1::2].clip(0, nh)
            sc = lg_f[top]
            # find_top_rpn_proposals drops empty boxes
            nonempty = (bx[:, 2] > bx[:, 0]) & (bx[:, 3] > bx[:, 1])
            bx, sc = bx[nonempty], sc[nonempty]
            if not bx.shape[0]:
                continue
            keep = _nms(bx, sc, _RPN_NMS_T)
            all_boxes.append(bx[keep])
            all_scores.append(sc[keep])
        if not all_boxes:
            return np.zeros((0, 4), np.float32)
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        order = np.argsort(-scores)[:_POST_NMS_TOPK]
        boxes, scores = boxes[order], scores[order]
        # the second stage on the best proposals, padded to a fixed batch
        n = min(_BOX_BATCH, boxes.shape[0])
        padded = np.zeros((_BOX_BATCH, 4), np.float32)
        padded[:n] = boxes[:n]
        dev = pyramid[2].device
        pooled = _roi_align_multilevel(pyramid, torch.from_numpy(padded).to(dev), 7)
        probs, bdeltas = [t.cpu().numpy() for t in _box_head(params, pooled)]
        person = probs[:n, 0]  # class 0: the person (one class and the background)
        sel = person > _SCORE_T
        final = _decode(padded[:n][sel],
                        bdeltas[:n][sel][:, :4] / np.array([10.0, 10.0, 5.0, 5.0], np.float32))
        if final.shape[0] == 0:
            return np.zeros((0, 4), np.float32)
        final[:, 0::2] = final[:, 0::2].clip(0, nw)
        final[:, 1::2] = final[:, 1::2].clip(0, nh)
        fsc = person[sel]
        nonempty = (final[:, 2] > final[:, 0]) & (final[:, 3] > final[:, 1])
        final, fsc = final[nonempty], fsc[nonempty]
        if final.shape[0] == 0:
            return np.zeros((0, 4), np.float32)
        return final[_nms(final, fsc, _BOX_NMS_T)].astype(np.float32)


_DETECTOR: Optional[DensePoseDetector] = None


def get_densepose(device=None) -> DensePoseDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = DensePoseDetector(device=device)
    return _DETECTOR


def _densepose(img, res, a, b, cmap: str = "viridis"):
    return get_densepose().detect(resize_image(img, res), cmap=cmap).astype(np.float32) / 255.0


def densepose(img, res, a, b):
    return _densepose(img, res, a, b, "viridis")


def densepose_parula(img, res, a, b):
    return _densepose(img, res, a, b, "parula")

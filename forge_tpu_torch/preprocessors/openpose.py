"""OpenPose (openpose, openpose_hand, openpose_face, openpose_faceonly,
openpose_full): the CMU body, hand and face CPMs and the host
postprocessor (port of forge_tpu/preprocessors/openpose.py).

The body net is the VGG trunk (model0) and six stages of a PAF branch
(L1 → 38 maps) and a heatmap branch (L2 → 19 maps) over cat(L1, L2, trunk);
the hand net (model1_0, model1_1, model2..6 → 22 maps) and the face net
(flat keys → 71 maps) are the same trunk with five refinement stages.
Everything after the networks is host numpy and scipy, copied from the
reference: peak NMS on σ-3 smoothed heatmaps, PAF line integrals, greedy
limb matching and person assembly, the hand and face boxes, the hand
peaks, and the drawings (preprocessors/cv2_np.py in place of cv2). The
body net runs at 0.5·368/H of the image (Lanczos, padded to a multiple of
8 with 128); its maps come back with cubic resizes; the hand net at 184²
and 368² on each hand box, the face net at 384² on the face box.

Checkpoints under models/openpose: the first file with "body" in its name
(body_pose_model.pth), "hand" (hand_pose_model.pth) and "face"
(facenet.pth).
"""

from __future__ import annotations

import colorsys
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from . import cv2_np
from .annotator import Detector, inference, max_pool_2x, to_numpy
from .cv import resize_image

# limb sequence / PAF map pairs / draw colors: published CMU model constants
LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
           [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
           [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
           [45, 46]]
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85]]




def find_peaks(heatmap: np.ndarray, thre1: float = 0.1):
    """Per-part peak lists [(x, y, score, id), ...] via 4-neighbor NMS on
    gaussian-smoothed maps."""
    from scipy.ndimage import gaussian_filter

    all_peaks = []
    counter = 0
    for part in range(18):
        m = heatmap[:, :, part]
        sm = gaussian_filter(m, sigma=3)
        left = np.zeros_like(sm); left[1:] = sm[:-1]
        right = np.zeros_like(sm); right[:-1] = sm[1:]
        up = np.zeros_like(sm); up[:, 1:] = sm[:, :-1]
        down = np.zeros_like(sm); down[:, :-1] = sm[:, 1:]
        keep = (sm >= left) & (sm >= right) & (sm >= up) & (sm >= down) & (sm > thre1)
        ys, xs = np.nonzero(keep)
        peaks = [(x, y, m[y, x], counter + i) for i, (x, y) in enumerate(zip(xs, ys))]
        all_peaks.append(peaks)
        counter += len(peaks)
    return all_peaks


def match_limbs(paf: np.ndarray, all_peaks, img_h: int, thre2: float = 0.05):
    """Greedy bipartite limb matching by PAF line integrals."""
    connections = []
    for k, (limb, midx) in enumerate(zip(LIMB_SEQ, MAP_IDX)):
        score_mid = paf[:, :, [m - 19 for m in midx]]
        cand_a = all_peaks[limb[0] - 1]
        cand_b = all_peaks[limb[1] - 1]
        if not cand_a or not cand_b:
            connections.append(np.zeros((0, 5)))
            continue
        cands = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(np.linalg.norm(vec), 1e-3)
                vec = vec / norm
                xs = np.round(np.linspace(a[0], b[0], 10)).astype(int)
                ys = np.round(np.linspace(a[1], b[1], 10)).astype(int)
                mids = score_mid[ys, xs]  # [10, 2]
                scores = mids[:, 0] * vec[0] + mids[:, 1] * vec[1]
                prior = scores.mean() + min(0.5 * img_h / norm - 1, 0)
                if (scores > thre2).sum() > 0.8 * len(scores) and prior > 0:
                    cands.append((i, j, prior, prior + a[2] + b[2]))
        cands.sort(key=lambda c: -c[2])
        used_i, used_j = set(), set()
        rows = []
        for i, j, s, _ in cands:
            if i in used_i or j in used_j:
                continue
            rows.append([cand_a[i][3], cand_b[j][3], s, i, j])
            used_i.add(i); used_j.add(j)
            if len(rows) >= min(len(cand_a), len(cand_b)):
                break
        connections.append(np.asarray(rows, np.float64).reshape(-1, 5))
    return connections


def assemble_people(all_peaks, connections):
    """Merge limb connections into per-person part-index rows (subset),
    reference body.py:157-207."""
    candidate = np.array([p for peaks in all_peaks for p in peaks],
                         np.float64).reshape(-1, 4)
    subset = -1 * np.ones((0, 20))
    for k, conn in enumerate(connections):
        if len(conn) == 0:
            continue
        ia, ib = np.array(LIMB_SEQ[k]) - 1
        for row in conn:
            pa, pb, score = row[0], row[1], row[2]
            found = [j for j in range(len(subset))
                     if subset[j][ia] == pa or subset[j][ib] == pb]
            if len(found) == 1:
                j = found[0]
                if subset[j][ib] != pb:
                    subset[j][ib] = pb
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(pb), 2] + score
            elif len(found) >= 2:
                j1, j2 = found[:2]
                member = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if not (member == 2).any():
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += score
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][ib] = pb
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(pb), 2] + score
            elif k < 17:
                new = -1 * np.ones(20)
                new[ia], new[ib] = pa, pb
                new[-1] = 2
                new[-2] = candidate[int(pa), 2] + candidate[int(pb), 2] + score
                subset = np.vstack([subset, new])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def draw_bodypose(canvas_hw: Tuple[int, int], candidate: np.ndarray,
                  subset: np.ndarray) -> np.ndarray:
    """Render the skeleton map (reference annotator/openpose/util.py
    draw_bodypose: stickwidth-4 ellipses + radius-4 joints on black)."""
    h, w = canvas_hw
    canvas = np.zeros((h, w, 3), np.uint8)
    for k in range(17):
        ia, ib = np.array(LIMB_SEQ[k]) - 1
        for person in subset:
            idx_a, idx_b = int(person[ia]), int(person[ib])
            if idx_a < 0 or idx_b < 0:
                continue
            ax, ay = candidate[idx_a, :2]
            bx, by = candidate[idx_b, :2]
            mx, my = (ax + bx) / 2, (ay + by) / 2
            length = np.hypot(ax - bx, ay - by)
            angle = np.degrees(np.arctan2(ay - by, ax - bx))
            poly = cv2_np.ellipse2poly((int(mx), int(my)), (int(length / 2), 4),
                                    int(angle), 0, 360, 1)
            cv2_np.fill_convex_poly(canvas, poly, [int(c * 0.6) for c in COLORS[k]])
    for part in range(18):
        for person in subset:
            idx = int(person[part])
            if idx < 0:
                continue
            x, y = candidate[idx, :2]
            cv2_np.circle(canvas, (int(x), int(y)), 4, COLORS[part], thickness=-1)
    return canvas


def person_keypoints(candidate: np.ndarray, subset: np.ndarray):
    """subset rows → per-person lists of 18 (x, y) tuples or None."""
    people = []
    for person in subset:
        kps = []
        for part in range(18):
            idx = int(person[part])
            kps.append(None if idx < 0 else (float(candidate[idx, 0]),
                                             float(candidate[idx, 1])))
        people.append(kps)
    return people


def hand_boxes(kps, img_h: int, img_w: int):
    """Hand square boxes from body keypoints (reference util.py:230
    handDetect: wrist extended by 0.33·(wrist−elbow), width 1.5·max(|we|,
    0.9·|es|), clamped, ≥20 px). → [(x, y, w, is_left), ...]"""
    out = []
    for sh_i, el_i, wr_i, is_left in ((5, 6, 7, True), (2, 3, 4, False)):
        if any(kps[i] is None for i in (sh_i, el_i, wr_i)):
            continue
        (x1, y1), (x2, y2), (x3, y3) = kps[sh_i], kps[el_i], kps[wr_i]
        x = x3 + 0.33 * (x3 - x2)
        y = y3 + 0.33 * (y3 - y2)
        width = 1.5 * max(np.hypot(x3 - x2, y3 - y2),
                          0.9 * np.hypot(x2 - x1, y2 - y1))
        x, y = max(x - width / 2, 0), max(y - width / 2, 0)
        width = min(width, img_w - x, img_h - y)
        if width >= 20:
            out.append((int(x), int(y), int(width), is_left))
    return out


def face_box(kps, img_h: int, img_w: int):
    """Face square box from nose/eyes/ears (reference util.py:324
    faceDetect). → (x, y, w) or None."""
    head = kps[0]
    feats = [kps[i] for i in (14, 15, 16, 17)]
    if head is None or all(f is None for f in feats):
        return None
    x0, y0 = head
    width = 0.0
    for f, mult in zip(feats, (3.0, 3.0, 1.5, 1.5)):
        if f is not None:
            width = max(width, max(abs(x0 - f[0]), abs(y0 - f[1])) * mult)
    x, y = max(x0 - width, 0), max(y0 - width, 0)
    width = min(width * 2, img_w - x, img_h - y)
    return (int(x), int(y), int(width)) if width >= 20 else None


def hand_peaks_from_heatmap(heat: np.ndarray, crop_h: int, crop_w: int,
                            thre: float = 0.05):
    """128² averaged hand heatmaps → 21 (x, y) peaks in crop coordinates
    (reference hand.py:64-83: gaussian σ3, largest connected component,
    argmax), (0,0) marking a miss."""
    from scipy.ndimage import gaussian_filter, label

    wsize = heat.shape[0]
    peaks = []
    for part in range(21):
        m = heat[:, :, part].copy()
        sm = gaussian_filter(m, sigma=3)
        binary = sm > thre
        if not binary.any():
            peaks.append((0, 0))
            continue
        lab, n = label(binary)
        sums = [m[lab == i].sum() for i in range(1, n + 1)]
        keep = int(np.argmax(sums)) + 1
        m[lab != keep] = 0
        y, x = np.unravel_index(np.argmax(m), m.shape)
        peaks.append((int(x * crop_w / wsize), int(y * crop_h / wsize)))
    return peaks


HAND_EDGES = [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
              [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14],
              [14, 15], [15, 16], [0, 17], [17, 18], [18, 19], [19, 20]]


def draw_handpose(canvas: np.ndarray, peaks, ox: int, oy: int) -> np.ndarray:
    """HSV-per-edge hand skeleton (reference util.py:142)."""
    for ie, (a, b) in enumerate(HAND_EDGES):
        (xa, ya), (xb, yb) = peaks[a], peaks[b]
        if min(xa, ya, xb, yb) <= 0:
            continue
        rgb = colorsys.hsv_to_rgb(ie / len(HAND_EDGES), 1.0, 1.0)
        cv2_np.line(canvas, (ox + xa, oy + ya), (ox + xb, oy + yb),
                 tuple(int(c * 255) for c in rgb), 2)
    for x, y in peaks:
        if x > 0 and y > 0:
            cv2_np.circle(canvas, (ox + x, oy + y), 4, (0, 0, 255), thickness=-1)
    return canvas


def draw_facepose(canvas: np.ndarray, peaks, ox: int, oy: int) -> np.ndarray:
    """White landmark dots (reference util.py:193)."""
    for x, y in peaks:
        if x > 0 and y > 0:
            cv2_np.circle(canvas, (ox + x, oy + y), 3, (255, 255, 255), thickness=-1)
    return canvas




# ---------------------------------------------------------------------------
# the networks


def _seq(p: Mapping[str, Any], x: torch.Tensor, names: List[Tuple[str, int, bool]]):
    """An ordered conv list: (name, pad, relu), or ("pool", 0, False)."""
    for name, pad, relu in names:
        if name == "pool":
            x = max_pool_2x(x)
            continue
        x = nn.conv2d(x, p[name], padding=pad)
        if relu:
            x = F.relu(x)
    return x


def _trunk_plan():
    plan = [("conv1_1", 1, True), ("conv1_2", 1, True), ("pool", 0, False),
            ("conv2_1", 1, True), ("conv2_2", 1, True), ("pool", 0, False)]
    plan += [(f"conv3_{i}", 1, True) for i in range(1, 5)] + [("pool", 0, False)]
    return plan + [(n, 1, True) for n in ("conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM")]


def _stage_plan(stage: int, branch: int):
    if stage == 1:
        names = [f"conv5_{i}_CPM_L{branch}" for i in range(1, 6)]
        pads = [1, 1, 1, 0, 0]
    else:
        names = [f"Mconv{i}_stage{stage}_L{branch}" for i in range(1, 8)]
        pads = [3, 3, 3, 3, 3, 0, 0]
    return [(n, p, i < len(names) - 1) for i, (n, p) in enumerate(zip(names, pads))]


def body_apply(params: Mapping[str, Any], x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,3,H,W] (value/256 − 0.5) → (PAF [B,38,h,w], heatmaps [B,19,h,w]) at stride 8."""
    trunk = _seq(params["model0"], x, _trunk_plan())
    l1 = _seq(params["model1_1"], trunk, _stage_plan(1, 1))
    l2 = _seq(params["model1_2"], trunk, _stage_plan(1, 2))
    for s in range(2, 7):
        cat = torch.cat([l1, l2, trunk], dim=1)
        l1 = _seq(params[f"model{s}_1"], cat, _stage_plan(s, 1))
        l2 = _seq(params[f"model{s}_2"], cat, _stage_plan(s, 2))
    return l1, l2


def _cpm_trunk_plan():
    plan = []
    for group, n in (("conv1", 2), ("conv2", 2), ("conv3", 4)):
        plan += [(f"{group}_{i}", 1, True) for i in range(1, n + 1)] + [("pool", 0, False)]
    plan += [(f"conv4_{i}", 1, True) for i in range(1, 5)]
    return plan + [("conv5_1", 1, True), ("conv5_2", 1, True), ("conv5_3_CPM", 1, True)]


def _refine_plan(s: int):
    names = [(f"Mconv{i}_stage{s}", 3, True) for i in range(1, 6)]
    return names + [(f"Mconv6_stage{s}", 0, True), (f"Mconv7_stage{s}", 0, False)]


def hand_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The hand CPM: x [B,3,H,W] (value/256 − 0.5) → [B,22,H/8,W/8]."""
    trunk = _seq(params["model1_0"], x, _cpm_trunk_plan())
    out = _seq(params["model1_1"], trunk, [("conv6_1_CPM", 0, True), ("conv6_2_CPM", 0, False)])
    for s in range(2, 7):
        out = _seq(params[f"model{s}"], torch.cat([out, trunk], dim=1), _refine_plan(s))
    return out


def face_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The face CPM: x [B,3,H,W] (value/256 − 0.5) → [B,71,H/8,W/8]."""
    trunk = _seq(params, x, _cpm_trunk_plan())
    out = _seq(params, trunk, [("conv6_1_CPM", 0, True), ("conv6_2_CPM", 0, False)])
    for s in range(2, 7):
        out = _seq(params, torch.cat([out, trunk], dim=1), _refine_plan(s))
    return out


def _hwc(t: torch.Tensor) -> np.ndarray:
    """[1,C,h,w] → float32 [h,w,C] on the host."""
    return np.ascontiguousarray(to_numpy(t[0]).transpose(1, 2, 0))


class OpenposeDetector:
    """The body net, and the hand and face nets where their files are there,
    each a `Detector` in f32 on the card (bf16 moves peaks: its drawings
    9.21 dB against f32's on an H100, PERF.md §4)."""

    def __init__(self, model_dir: str = "models/openpose", device=None, dtype=None):
        self.model_dir = model_dir
        kw = dict(device=device, dtype=dtype)
        self.body = Detector(model_dir, match="body", missing="no body_pose checkpoint", **kw)
        self.hand = Detector(model_dir, match="hand", **kw)
        self.face = Detector(model_dir, match="face", **kw)

    @property
    def available(self) -> bool:
        return self.body.available

    def _net(self, det: Detector, apply, feed: np.ndarray):
        params = det.load()
        x = det.image_tensor(feed.astype(np.float32) / 256.0 - 0.5)
        with inference():
            return apply(params, x)

    def _detect_hands(self, img: np.ndarray, kps, canvas: np.ndarray):
        """Each hand box at two scales (184², 368²), the 128² heatmaps averaged."""
        h, w = img.shape[:2]
        for x0, y0, bw, _is_left in hand_boxes(kps, h, w):
            crop = img[y0:y0 + bw, x0:x0 + bw]
            heat = np.zeros((128, 128, 22), np.float32)
            scales = (184, 368)
            for s in scales:
                feed = cv2_np.resize(crop, (s, s), cv2_np.INTER_CUBIC)
                out = _hwc(self._net(self.hand, hand_apply, feed))
                heat += cv2_np.resize(out, (128, 128), cv2_np.INTER_CUBIC) / len(scales)
            draw_handpose(canvas, hand_peaks_from_heatmap(heat, bw, bw), x0, y0)

    def _detect_face(self, img: np.ndarray, kps, canvas: np.ndarray):
        """The face box at 384²; each part's argmax above 0.05."""
        h, w = img.shape[:2]
        box = face_box(kps, h, w)
        if box is None:
            return
        x0, y0, bw = box
        feed = cv2_np.resize(img[y0:y0 + bw, x0:x0 + bw], (384, 384), cv2_np.INTER_CUBIC)
        heat = cv2_np.resize(_hwc(self._net(self.face, face_apply, feed)), (bw, bw),
                             cv2_np.INTER_CUBIC)
        peaks = []
        for part in range(70):
            m = heat[:, :, part]
            if (m > 0.05).any():
                y, x = np.unravel_index(np.argmax(np.where(m > 0.05, m, 0)), m.shape)
                peaks.append((int(x), int(y)))
        draw_facepose(canvas, peaks, x0, y0)

    def body_maps(self, img: np.ndarray):
        """uint8 [H,W,3] → (PAF [H,W,38], heatmaps [H,W,19]), float32 at the image's size."""
        h, w = img.shape[:2]
        scale = 0.5 * 368 / h
        sh, sw = int(round(h * scale)), int(round(w * scale))
        small = cv2_np.resize(img, (sw, sh), cv2_np.INTER_LANCZOS4)
        padded = np.pad(small, ((0, (-sh) % 8), (0, (-sw) % 8), (0, 0)), constant_values=128)
        paf, heat = self._net(self.body, body_apply, padded)
        return (cv2_np.resize(_hwc(paf), (w, h), cv2_np.INTER_CUBIC),
                cv2_np.resize(_hwc(heat), (w, h), cv2_np.INTER_CUBIC))

    def detect(self, img: np.ndarray, include_hand: bool = False, include_face: bool = False,
               include_body: bool = True) -> np.ndarray:
        """uint8 [H,W,3] → pose map uint8 [H,W,3]."""
        h, w = img.shape[:2]
        paf, heat = self.body_maps(img)
        peaks = find_peaks(heat)
        candidate, subset = assemble_people(peaks, match_limbs(paf, peaks, h))
        canvas = (draw_bodypose((h, w), candidate, subset) if include_body
                  else np.zeros((h, w, 3), np.uint8))
        if include_hand and self.hand.available:
            for kps in person_keypoints(candidate, subset):
                self._detect_hands(img, kps, canvas)
        if include_face and self.face.available:
            for kps in person_keypoints(candidate, subset):
                self._detect_face(img, kps, canvas)
        return canvas


_DETECTOR: Optional[OpenposeDetector] = None


def get_openpose(device=None) -> OpenposeDetector:
    global _DETECTOR
    if _DETECTOR is None:
        _DETECTOR = OpenposeDetector(device=device)
    return _DETECTOR


def _entry(hand: bool, face: bool, body: bool = True):
    def call(img, res, a, b):
        out = get_openpose().detect(resize_image(img, res), include_hand=hand,
                                    include_face=face, include_body=body)
        return np.asarray(out, np.float32) / 255.0

    return call


openpose_body = _entry(False, False)
openpose_hand = _entry(True, False)
openpose_face = _entry(False, True)
openpose_faceonly = _entry(False, True, body=False)
openpose_full = _entry(True, True)

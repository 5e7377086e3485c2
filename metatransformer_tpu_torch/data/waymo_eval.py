"""Waymo detection metric: AP and APH (heading-weighted AP).

Port of ``metatransformer_tpu/data/waymo_eval.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

Reference: ``AutonomousDriving/pcdet/datasets/waymo/`` — the dataset
formats frames for the Waymo Open Dataset evaluator
(``waymo_eval.py`` delegates to waymo_open_dataset's compute_detection
_metrics). Its protocol is implemented natively here:

 - matching by 3D IoU (BEV-rotated x height overlap, the repo's
   ``ops/iou3d`` math on host numpy) at the per-class thresholds
   (vehicle 0.7, pedestrian/cyclist 0.5);
 - AP over the 101-point interpolated PR curve;
 - APH: each true positive's contribution is weighted by
   min(|heading error|, 2pi - |heading error|) mapped to
   1 - err/pi (the WOD heading accuracy weight);
 - LEVEL filtering by minimum points-in-gt (L1 >= 5, L2 >= 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = {0: 0.7, 1: 0.5, 2: 0.5}  # vehicle, pedestrian, cyclist


@dataclasses.dataclass
class WaymoFrame:
    boxes: np.ndarray  # [N, 7]
    labels: np.ndarray  # [N]
    scores: Optional[np.ndarray] = None
    num_points: Optional[np.ndarray] = None  # [N] points-in-gt (gt only)


def _bev_corners(box: np.ndarray) -> np.ndarray:
    c, s = np.cos(box[6]), np.sin(box[6])
    dx, dy = box[3] / 2, box[4] / 2
    # counter-clockwise order (the Sutherland-Hodgman clip below keeps
    # the left side of each clip edge)
    local = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]])
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + box[:2]


def _poly_clip(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = []
    n = len(subject)
    for i in range(n):
        p, q = subject[i], subject[(i + 1) % n]
        side_p = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        side_q = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
        if side_p >= 0:
            out.append(p)
        if side_p * side_q < 0:
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return np.asarray(out)


def _bev_overlap(a: np.ndarray, b: np.ndarray) -> float:
    poly = _bev_corners(a)
    clip = _bev_corners(b)
    for i in range(4):
        if len(poly) == 0:
            return 0.0
        poly = _poly_clip(poly, clip[i], clip[(i + 1) % 4])
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def iou3d(a: np.ndarray, b: np.ndarray) -> float:
    bev = _bev_overlap(a, b)
    za1, za2 = a[2] - a[5] / 2, a[2] + a[5] / 2
    zb1, zb2 = b[2] - b[5] / 2, b[2] + b[5] / 2
    h = max(0.0, min(za2, zb2) - max(za1, zb1))
    inter = bev * h
    vol = float(np.prod(a[3:6]) + np.prod(b[3:6]) - inter)
    return inter / max(vol, 1e-9)


def _heading_weight(pred_yaw: float, gt_yaw: float) -> float:
    d = abs(pred_yaw - gt_yaw) % (2 * np.pi)
    d = min(d, 2 * np.pi - d)
    return max(0.0, 1.0 - d / np.pi)


def _level_mask(g: WaymoFrame, level: int) -> np.ndarray:
    if g.num_points is None:
        return np.ones(len(g.labels), bool)
    return g.num_points >= (5 if level == 1 else 1)


def _ap_curve(tp_weight: np.ndarray, tp_flag: np.ndarray, n_gt: int) -> float:
    """Interpolated AP with per-TP weights (APH uses heading weights)."""
    if n_gt == 0 or len(tp_flag) == 0:
        return 0.0
    cum_w = np.cumsum(tp_weight)
    cum_tp = np.cumsum(tp_flag)
    cum_fp = np.cumsum(~tp_flag)
    prec = cum_w / np.maximum(cum_tp + cum_fp, 1)
    rec = cum_tp / n_gt
    rec_i = np.linspace(0, 1, 101)
    prec_i = np.interp(rec_i, rec, prec, right=0)
    # monotone non-increasing envelope
    prec_i = np.maximum.accumulate(prec_i[::-1])[::-1]
    return float(np.mean(prec_i))


def evaluate(
    preds: List[WaymoFrame],
    gts: List[WaymoFrame],
    classes: Sequence[int] = (0, 1, 2),
    level: int = 2,
) -> Dict[str, float]:
    """-> {"mAP", "mAPH", per-class "AP_c"/"APH_c"} at the given LEVEL."""
    aps, aphs = [], []
    out: Dict[str, float] = {}
    for cls in classes:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        rows = []
        for fi, p in enumerate(preds):
            for di in np.where(p.labels == cls)[0]:
                rows.append((float(p.scores[di]), fi, int(di)))
        rows.sort(key=lambda r: -r[0])
        n_gt = 0
        masks = []
        for g in gts:
            m = (g.labels == cls) & _level_mask(g, level)
            masks.append(m)
            n_gt += int(m.sum())
        taken = [set() for _ in gts]
        tp_flag = np.zeros(len(rows), bool)
        tp_w = np.zeros(len(rows), np.float64)
        for ri, (score, fi, di) in enumerate(rows):
            g = gts[fi]
            best, best_iou = -1, thr
            for gi in np.where(masks[fi])[0]:
                if gi in taken[fi]:
                    continue
                v = iou3d(preds[fi].boxes[di], g.boxes[gi])
                if v >= best_iou:
                    best, best_iou = gi, v
            if best >= 0:
                taken[fi].add(best)
                tp_flag[ri] = True
                tp_w[ri] = _heading_weight(
                    preds[fi].boxes[di][6], g.boxes[best][6]
                )
        ap = _ap_curve(tp_flag.astype(np.float64), tp_flag, n_gt)
        aph = _ap_curve(tp_w, tp_flag, n_gt)
        out[f"AP_class{cls}"] = ap
        out[f"APH_class{cls}"] = aph
        aps.append(ap)
        aphs.append(aph)
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    out["mAPH"] = float(np.mean(aphs)) if aphs else 0.0
    return out

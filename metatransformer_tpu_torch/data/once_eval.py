"""ONCE detection metric: per-class AP with distance-range breakdown.

Port of ``metatransformer_tpu/data/once_eval.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

Reference: ``AutonomousDriving/pcdet/datasets/once/once_eval/
evaluation.py`` — superclass IoU thresholds (Vehicle 0.7,
Pedestrian 0.3, Cyclist 0.5; evaluation.py:12-25), overall plus
0-30 m / 30-50 m / 50 m+ distance splits (eval_utils.distance_filter),
101-point interpolated AP over 3D-IoU matches. IoU machinery shared
with ``data/waymo_eval.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from metatransformer_tpu_torch.data.waymo_eval import WaymoFrame, _ap_curve, iou3d

IOU_THRESHOLDS = {0: 0.7, 1: 0.3, 2: 0.5}  # Vehicle, Pedestrian, Cyclist
DIST_RANGES = ((0.0, 30.0), (30.0, 50.0), (50.0, np.inf))


def _range_mask(boxes: np.ndarray, rng) -> np.ndarray:
    d = np.linalg.norm(boxes[:, :3], axis=1)
    return (d >= rng[0]) & (d < rng[1])


def _ap_for(preds, gts, cls, thr, rng=None) -> float:
    rows = []
    for fi, p in enumerate(preds):
        m = p.labels == cls
        if rng is not None:
            m &= _range_mask(p.boxes, rng)
        for di in np.where(m)[0]:
            rows.append((float(p.scores[di]), fi, int(di)))
    rows.sort(key=lambda r: -r[0])
    masks, n_gt = [], 0
    for g in gts:
        m = g.labels == cls
        if rng is not None:
            m &= _range_mask(g.boxes, rng)
        masks.append(m)
        n_gt += int(m.sum())
    taken = [set() for _ in gts]
    tp = np.zeros(len(rows), bool)
    for ri, (score, fi, di) in enumerate(rows):
        best, best_iou = -1, thr
        for gi in np.where(masks[fi])[0]:
            if gi in taken[fi]:
                continue
            v = iou3d(preds[fi].boxes[di], gts[fi].boxes[gi])
            if v >= best_iou:
                best, best_iou = gi, v
        if best >= 0:
            taken[fi].add(best)
            tp[ri] = True
    return _ap_curve(tp.astype(np.float64), tp, n_gt)


def evaluate(
    preds: List[WaymoFrame],
    gts: List[WaymoFrame],
    classes: Sequence[int] = (0, 1, 2),
) -> Dict[str, float]:
    """-> {"mAP", per-class "AP_c", per-class-and-range
    "AP_c_0-30m"/"30-50m"/"50m-inf"}."""
    out: Dict[str, float] = {}
    aps = []
    names = ("0-30m", "30-50m", "50m-inf")
    for cls in classes:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        ap = _ap_for(preds, gts, cls, thr)
        out[f"AP_class{cls}"] = ap
        aps.append(ap)
        for name, rng in zip(names, DIST_RANGES):
            out[f"AP_class{cls}_{name}"] = _ap_for(preds, gts, cls, thr, rng)
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    return out

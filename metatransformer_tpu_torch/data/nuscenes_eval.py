"""nuScenes detection metric (mAP + NDS) and point-format helpers.

Port of ``metatransformer_tpu/data/nuscenes_eval.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

Reference: ``AutonomousDriving/pcdet/datasets/nuscenes/`` — the dataset
loads info-file frames with multi-sweep lidar accumulation
(``nuscenes_dataset.py`` get_lidar_with_sweeps: [x, y, z, intensity,
dt]) and delegates scoring to the nuscenes-devkit, whose protocol
(``nuscenes_utils.py:517-523`` reports its mAP/NDS) is implemented
natively here:

 - AP per class at center-distance thresholds {0.5, 1, 2, 4} m,
   integrated over the precision-recall curve above (recall, precision)
   = (0.1, 0.1) as the devkit does;
 - TP errors at the 2 m threshold: ATE (center distance), ASE
   (1 - IoU of aligned boxes), AOE (min angle diff), AVE (velocity L2),
   AAE (attribute error, optional);
 - NDS = (5 * mAP + sum_tp (1 - min(1, err))) / 10.

Host-side numpy like the KITTI evaluator (``data/kitti_eval.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1


@dataclasses.dataclass
class NuscFrame:
    """Per-frame detections or ground truth in global/lidar frame."""

    boxes: np.ndarray  # [N, 7] (x, y, z, dx, dy, dz, yaw)
    labels: np.ndarray  # [N] int class ids
    scores: Optional[np.ndarray] = None  # [N] (detections only)
    velocities: Optional[np.ndarray] = None  # [N, 2] vx, vy


def _angle_diff(a: np.ndarray, b: np.ndarray, period=2 * np.pi) -> np.ndarray:
    d = (a - b + period / 2) % period - period / 2
    return np.abs(d)


def _aligned_iou(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """3D IoU of center-aligned, axis-aligned boxes (devkit scale_iou)."""
    inter = np.prod(np.minimum(box_a[3:6], box_b[3:6]))
    union = np.prod(box_a[3:6]) + np.prod(box_b[3:6]) - inter
    return float(inter / max(union, 1e-9))


def _accumulate_class(
    preds: List[NuscFrame],
    gts: List[NuscFrame],
    cls: int,
    dist_th: float,
):
    """-> (tp flags sorted by score desc, n_gt, tp_errors list).
    Center-distance greedy matching (devkit accumulate)."""
    rows = []  # (score, frame, det index)
    for fi, p in enumerate(preds):
        for di in np.where(p.labels == cls)[0]:
            rows.append((float(p.scores[di]), fi, int(di)))
    rows.sort(key=lambda r: -r[0])
    n_gt = sum(int(np.sum(g.labels == cls)) for g in gts)

    taken = [set() for _ in gts]
    tp = np.zeros(len(rows), bool)
    errors = []  # dicts for true positives
    for ri, (score, fi, di) in enumerate(rows):
        g = gts[fi]
        gidx = np.where(g.labels == cls)[0]
        best, best_d = -1, np.inf
        pxy = preds[fi].boxes[di, :2]
        for gi in gidx:
            if gi in taken[fi]:
                continue
            d = float(np.linalg.norm(g.boxes[gi, :2] - pxy))
            if d < best_d:
                best, best_d = gi, d
        if best >= 0 and best_d < dist_th:
            taken[fi].add(best)
            tp[ri] = True
            pb = preds[fi].boxes[di]
            gb = g.boxes[best]
            err = {
                "trans": best_d,
                "scale": 1.0 - _aligned_iou(pb, gb),
                "orient": float(_angle_diff(pb[6], gb[6])),
            }
            if preds[fi].velocities is not None and g.velocities is not None:
                err["vel"] = float(
                    np.linalg.norm(
                        preds[fi].velocities[di] - g.velocities[best]
                    )
                )
            errors.append(err)
    return tp, n_gt, errors


def _ap_from_tp(tp: np.ndarray, n_gt: int) -> float:
    """Devkit-style AP: 101-point interpolated PR, clipped below
    (0.1 recall, 0.1 precision), renormalized by (1 - 0.1)^2 ... the
    devkit subtracts the clip floor and divides by (1 - min_r)."""
    if n_gt == 0 or len(tp) == 0:
        return 0.0
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    rec = cum_tp / n_gt
    rec_interp = np.linspace(0, 1, 101)
    prec_interp = np.interp(rec_interp, rec, prec, right=0)
    mask = rec_interp >= MIN_RECALL
    prec_clip = np.maximum(prec_interp - MIN_PRECISION, 0.0)[mask]
    return float(np.mean(prec_clip) / (1.0 - MIN_PRECISION))


def evaluate(
    preds: List[NuscFrame],
    gts: List[NuscFrame],
    classes: Sequence[int],
) -> Dict[str, float]:
    """-> {"mAP", "NDS", "mATE", "mASE", "mAOE"[, "mAVE"], per-class AP}."""
    aps: Dict[int, List[float]] = {}
    tp_errs: Dict[str, List[float]] = {}
    for cls in classes:
        aps[cls] = []
        for th in DIST_THRESHOLDS:
            tp, n_gt, errors = _accumulate_class(preds, gts, cls, th)
            aps[cls].append(_ap_from_tp(tp, n_gt))
            if th == TP_THRESHOLD and errors:
                for k in errors[0]:
                    tp_errs.setdefault(k, []).append(
                        float(np.mean([e[k] for e in errors]))
                    )
    mean_ap = float(np.mean([np.mean(v) for v in aps.values()])) if aps else 0.0
    out = {"mAP": mean_ap}
    name = {"trans": "mATE", "scale": "mASE", "orient": "mAOE", "vel": "mAVE"}
    tp_score = 0.0
    tp_names = ["trans", "scale", "orient"] + (
        ["vel"] if "vel" in tp_errs else []
    )
    for k in tp_names:
        v = float(np.mean(tp_errs.get(k, [1.0])))
        out[name[k]] = v
        tp_score += max(0.0, 1.0 - min(1.0, v))
    # devkit NDS uses 5 TP metrics; absent ones (vel/attr here when not
    # provided) contribute 0, matching a detector that does not predict them
    out["NDS"] = float((5 * mean_ap + tp_score) / 10.0)
    for cls in classes:
        out[f"AP_class{cls}"] = float(np.mean(aps[cls]))
    return out


# --- multi-sweep point accumulation -----------------------------------------


def accumulate_sweeps(
    sweeps: Sequence[Tuple[np.ndarray, np.ndarray, float]],
    max_points: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """[(points [N_i, 4] xyz+intensity, T_i [4, 4] transform to the
    keyframe, dt_i seconds)] -> ([max_points, 5] x,y,z,intensity,dt,
    mask) — the get_lidar_with_sweeps format (nuscenes_dataset.py)."""
    rows = []
    for pts, tf, dt in sweeps:
        xyz1 = np.concatenate(
            [pts[:, :3], np.ones((len(pts), 1), pts.dtype)], axis=1
        )
        moved = (xyz1 @ tf.T)[:, :3]
        rows.append(
            np.concatenate(
                [moved, pts[:, 3:4],
                 np.full((len(pts), 1), dt, pts.dtype)], axis=1,
            )
        )
    allp = np.concatenate(rows, axis=0) if rows else np.zeros((0, 5), np.float32)
    out = np.zeros((max_points, 5), np.float32)
    n = min(len(allp), max_points)
    out[:n] = allp[:n]
    mask = np.zeros((max_points,), bool)
    mask[:n] = True
    return out, mask

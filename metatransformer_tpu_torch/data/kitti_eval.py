"""KITTI 3D-detection evaluation: AP_R40 over BEV / 3D IoU.

Reference: ``AutonomousDriving/pcdet/datasets/kitti/kitti_object_eval_python/eval.py``
(the numba AP pipeline: per-class IoU thresholds 0.7 car / 0.5
pedestrian+cyclist, difficulty buckets, 40 recall positions, greedy
score-ordered matching with ignored-gt handling).

Port of ``metatransformer_tpu/data/kitti_eval.py``. Host-side numpy:
evaluation is bookkeeping, not compute; the rotated IoU matrix is
delegated to :mod:`..ops.iou3d` on a device that :func:`evaluate` and
:func:`ap_r40` take (``device=None``: the card, raising where there is
none). The reference's dtypes are kept: the overlap comes back as fp32,
the areas are taken from the arrays as given, the division runs in numpy.
The orderings are numpy's (``np.argsort(-scores)``, ``np.argmax``'s first
index) on the same host arrays, so equal scores fall in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.ops import iou3d

CLASS_IOU_THR = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}

# difficulty gates (eval.py clean_data): max truncation / occlusion,
# min 2D bbox height in px
DIFFICULTY = {
    0: {"trunc": 0.15, "occ": 0, "height": 40.0},  # easy
    1: {"trunc": 0.30, "occ": 1, "height": 25.0},  # moderate
    2: {"trunc": 0.50, "occ": 2, "height": 25.0},  # hard
}


@dataclasses.dataclass
class KittiAnnotation:
    """One frame's ground truth (subset of the KITTI label fields)."""

    boxes: np.ndarray  # [G, 7] (x, y, z, l, w, h, ry) lidar frame
    names: np.ndarray  # [G] str
    truncated: np.ndarray = None  # [G] float
    occluded: np.ndarray = None  # [G] int
    bbox_height: np.ndarray = None  # [G] 2D box height (px)

    def __post_init__(self):
        g = len(self.names)
        if self.truncated is None:
            self.truncated = np.zeros(g)
        if self.occluded is None:
            self.occluded = np.zeros(g, np.int64)
        if self.bbox_height is None:
            self.bbox_height = np.full(g, 50.0)


def _difficulty_mask(ann: KittiAnnotation, difficulty: int) -> np.ndarray:
    d = DIFFICULTY[difficulty]
    return (
        (ann.truncated <= d["trunc"])
        & (ann.occluded <= d["occ"])
        & (ann.bbox_height >= d["height"])
    )


def _iou_matrix(pred_boxes: np.ndarray, gt_boxes: np.ndarray, metric: str,
                device: torch.device):
    if pred_boxes.shape[0] == 0 or gt_boxes.shape[0] == 0:
        return np.zeros((pred_boxes.shape[0], gt_boxes.shape[0]))
    a = torch.as_tensor(np.asarray(pred_boxes, np.float32), device=device)
    b = torch.as_tensor(np.asarray(gt_boxes, np.float32), device=device)
    with torch.no_grad():
        if metric == "3d":
            return iou3d.boxes_iou3d(a, b).cpu().numpy()
        ov = iou3d.rotated_overlap_bev(a, b).cpu().numpy()
    area_a = pred_boxes[:, 3] * pred_boxes[:, 4]
    area_b = gt_boxes[:, 3] * gt_boxes[:, 4]
    return ov / np.maximum(area_a[:, None] + area_b[None] - ov, 1e-6)


def _match_frame(
    pred_boxes, pred_scores, gt_boxes, gt_care, iou_thr, metric, device
):
    """Greedy score-ordered matching -> (tp_flags, matched_scores ordered
    by score, num_valid_gt). don't-care gts absorb predictions without
    counting as FP (eval.py ignored handling)."""
    order = np.argsort(-pred_scores)
    iou = _iou_matrix(pred_boxes, gt_boxes, metric, device)
    taken = np.zeros(gt_boxes.shape[0], bool)
    tp = np.zeros(len(order), bool)
    ignore = np.zeros(len(order), bool)
    for r, pi in enumerate(order):
        if gt_boxes.shape[0] == 0:
            break
        cand = iou[pi] * ~taken
        gi = int(np.argmax(cand))
        if cand[gi] >= iou_thr:
            taken[gi] = True
            if gt_care[gi]:
                tp[r] = True
            else:
                ignore[r] = True
    keep = ~ignore
    return tp[keep], pred_scores[order][keep], int(gt_care.sum())


def ap_r40(
    predictions: Sequence[Dict[str, np.ndarray]],
    annotations: Sequence[KittiAnnotation],
    cls: str,
    difficulty: int = 1,
    metric: str = "3d",
    device: _device.Device = None,
) -> float:
    """AP with 40 recall positions (eval.py get_mAP_R40) for one class.

    predictions: per frame {"boxes" [N,7], "scores" [N], "names" [N]}
    (numpy). The IoU matrices run on ``device`` (None: the card).
    """
    device = _device.resolve(device)
    iou_thr = CLASS_IOU_THR.get(cls, 0.5)
    all_tp, all_scores, total_gt = [], [], 0
    for pred, ann in zip(predictions, annotations):
        pm = np.asarray(pred["names"]) == cls
        gm = np.asarray(ann.names) == cls
        care = _difficulty_mask(ann, difficulty)[gm]
        tp, scores, n_gt = _match_frame(
            np.asarray(pred["boxes"])[pm],
            np.asarray(pred["scores"])[pm],
            np.asarray(ann.boxes)[gm],
            care,
            iou_thr,
            metric,
            device,
        )
        all_tp.append(tp)
        all_scores.append(scores)
        total_gt += n_gt
    if total_gt == 0:
        return 0.0
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(np.arange(len(tp)) + 1, 1)
    # interpolated precision at the 40 recall anchors (1/40 .. 40/40)
    ap = 0.0
    for r in np.linspace(1.0 / 40, 1.0, 40):
        mask = recall >= r
        ap += float(precision[mask].max()) if mask.any() else 0.0
    return ap / 40.0


def evaluate(
    predictions: Sequence[Dict[str, np.ndarray]],
    annotations: Sequence[KittiAnnotation],
    classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
    metrics: Sequence[str] = ("bev", "3d"),
    device: _device.Device = None,
) -> Dict[str, float]:
    """Full result table: AP_R40 per (class, difficulty, metric), the IoU
    matrices on ``device`` (None: the card)."""
    device = _device.resolve(device)
    out: Dict[str, float] = {}
    for cls in classes:
        for diff, tag in ((0, "easy"), (1, "moderate"), (2, "hard")):
            for metric in metrics:
                out[f"{cls}_{metric}_{tag}"] = ap_r40(
                    predictions, annotations, cls, diff, metric, device
                )
    return out

"""Whole-scene segmentation evaluation: voxel sub-cloud chunking, voting,
6-fold aggregation.

Reference: ``PointCloud/examples/segmentation/main.py``:
- ``load_data`` (:64-110) voxel-sorts the full room and splits it into
  parts — part k takes the k-th point of every voxel — so each pass fits
  in memory and every original point is predicted exactly once
  ("multi_voxel" test mode);
- ``test`` (:508+) runs the model per part, scatters logits back to the
  full cloud and accumulates per-cloud + overall confusion matrices;
- ``test_s3dis_6fold.py`` sums the per-area confusion matrices and
  reports the all-area OA/mAcc/mIoU (cfg.allarea_cm.value += ...);
- classification voting (``examples/classification`` eval, PointNeXt
  protocol): average logits over ``num_votes`` random-scale augmented
  passes.

Every part is padded to the first (largest) part's size, so every pass
has one shape; padded tail points are masked out of the scatter.

A copy of ``metatransformer_tpu/utils/seg_eval.py`` (numpy only); the port
keeps its own so that nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from metatransformer_tpu_torch.utils.metrics import ConfusionMatrix


def voxel_parts(
    coord: np.ndarray, voxel_size: float
) -> List[np.ndarray]:
    """Split a full scene into index parts, part k = k-th point per voxel
    (load_data:88-110 'multi_voxel'). Union of parts = all points, no
    duplicates."""
    coord = np.asarray(coord)
    grid = np.floor((coord - coord.min(0)) / voxel_size).astype(np.int64)
    dims = grid.max(0) + 1
    key = (grid[:, 0] * dims[1] + grid[:, 1]) * dims[2] + grid[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    _, starts, counts = np.unique(
        key_sorted, return_index=True, return_counts=True
    )
    parts = []
    k = 0
    while True:
        sel = counts > k
        if not sel.any():
            break
        parts.append(order[starts[sel] + k])
        k += 1
    return parts


def scene_inference(
    forward_fn: Callable[[np.ndarray], np.ndarray],
    coord: np.ndarray,  # [N, 3]
    feat: Optional[np.ndarray],  # [N, C] or None
    voxel_size: float,
    num_classes: int,
) -> np.ndarray:
    """Full-scene logits [N, num_classes] via per-part passes.

    ``forward_fn`` maps (points [1, P, 3(+C)]) -> logits [1, P, num_classes];
    parts are padded (by repeating index 0) to the first part's size so
    every pass has one shape (test:508+ semantics, each point predicted in
    exactly one part)."""
    n = coord.shape[0]
    parts = voxel_parts(coord, voxel_size)
    pad_to = len(parts[0])
    logits = np.zeros((n, num_classes), np.float32)
    for idx in parts:
        m = len(idx)
        padded = np.concatenate([idx, np.zeros(pad_to - m, idx.dtype)])
        sub = coord[padded]
        sub = sub - sub.min(0)  # coord_part -= min (test:560)
        if feat is not None:
            sub = np.concatenate([sub, feat[padded]], axis=-1)
        out = np.asarray(forward_fn(sub[None]))[0]
        logits[idx] = out[:m]
    return logits


def vote_logits(
    forward_fn: Callable[[np.ndarray], np.ndarray],
    points: np.ndarray,  # [B, N, 3]
    num_votes: int = 10,
    scale_range: Tuple[float, float] = (0.8, 1.2),
    seed: int = 0,
) -> np.ndarray:
    """Classification voting: mean logits over random anisotropic-scale
    augmented passes (the PointNeXt/openpoints voted-eval protocol)."""
    rng = np.random.default_rng(seed)
    acc = None
    for v in range(num_votes):
        scale = (
            rng.uniform(*scale_range, size=(1, 1, 3)).astype(np.float32)
            if v else np.ones((1, 1, 3), np.float32)  # first vote: clean
        )
        out = np.asarray(forward_fn(points * scale))
        acc = out if acc is None else acc + out
    return acc / num_votes


# ---------------------------------------------------------------------------
# ShapeNetPart instance-mIoU protocol
# (PointCloud/examples/shapenetpart/main.py:67-96 get_ins_mious +
#  the ins/cls aggregation in its validate loop)
# ---------------------------------------------------------------------------

# category -> its global part ids (16 categories, 50 parts; the standard
# ShapeNetPart layout used by openpoints' cls2parts).
SHAPENETPART_CLS2PARTS: Tuple[Tuple[int, ...], ...] = (
    (0, 1, 2, 3),          # airplane
    (4, 5),                # bag
    (6, 7),                # cap
    (8, 9, 10, 11),        # car
    (12, 13, 14, 15),      # chair
    (16, 17, 18),          # earphone
    (19, 20, 21),          # guitar
    (22, 23),              # knife
    (24, 25, 26, 27),      # lamp
    (28, 29),              # laptop
    (30, 31, 32, 33, 34, 35),  # motorbike
    (36, 37),              # mug
    (38, 39, 40),          # pistol
    (41, 42, 43),          # rocket
    (44, 45, 46),          # skateboard
    (47, 48, 49),          # table
)


def instance_mious(
    pred: np.ndarray,  # [B, N] int part labels
    target: np.ndarray,  # [B, N] int part labels
    cls: np.ndarray,  # [B] int category per shape
    cls2parts: Sequence[Sequence[int]] = SHAPENETPART_CLS2PARTS,
) -> np.ndarray:
    """Per-shape part-mIoU (get_ins_mious semantics, main.py:67-96): for
    each shape, IoU over ONLY its category's parts, with the union==0
    convention IoU=1 (a part absent from both pred and target counts as
    perfect). Returns fractions in [0, 1] (the reference scales by 100 at
    the same point; we scale when printing)."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    cls = np.asarray(cls)
    out = np.zeros(pred.shape[0], np.float64)
    for i in range(pred.shape[0]):
        part_ious = []
        for part in cls2parts[int(cls[i])]:
            p = pred[i] == part
            t = target[i] == part
            u = np.logical_or(p, t).sum()
            if u == 0:
                part_ious.append(1.0)
            else:
                part_ious.append(np.logical_and(p, t).sum() / float(u))
        out[i] = float(np.mean(part_ious))
    return out


def aggregate_part_mious(
    ins_ious: np.ndarray,  # [B] from instance_mious
    cls: np.ndarray,  # [B]
    num_categories: int = 16,
) -> Dict[str, object]:
    """ins-mIoU = mean over shapes; cls-mIoU = mean over categories of the
    per-category shape means (main.py validate: cls_mious[cls] /=
    cls_nums[cls]; categories with no shapes are skipped)."""
    ins_ious = np.asarray(ins_ious, np.float64)
    cls = np.asarray(cls)
    per_cls = []
    for c in range(num_categories):
        sel = cls == c
        if sel.any():
            per_cls.append(float(ins_ious[sel].mean()))
        else:
            per_cls.append(float("nan"))
    valid = [v for v in per_cls if not np.isnan(v)]
    return {
        "ins_miou": float(ins_ious.mean()) if len(ins_ious) else 0.0,
        "cls_miou": float(np.mean(valid)) if valid else 0.0,
        "per_cls_miou": per_cls,
    }


def part_seg_refinement(
    pred: np.ndarray,  # [B, N] int part labels (modified copy returned)
    coord: np.ndarray,  # [B, N, 3]
    cls: np.ndarray,  # [B]
    cls2parts: Sequence[Sequence[int]] = SHAPENETPART_CLS2PARTS,
    n: int = 10,
) -> np.ndarray:
    """kNN majority re-label of tiny (<n points) or out-of-category
    predicted parts (main.py:47-64 part_seg_refinement): each offending
    point takes the most common *other* label among its n+1 nearest
    neighbours."""
    pred = np.asarray(pred).copy()
    coord = np.asarray(coord)
    n_parts = max(max(p) for p in cls2parts) + 1
    for i in range(pred.shape[0]):
        parts = set(cls2parts[int(cls[i])])
        labels, counts = np.unique(pred[i], return_counts=True)
        if len(labels) <= 1:
            continue
        for lab, cnt in zip(labels, counts):
            if cnt >= n and lab in parts:
                continue
            bad = np.where(pred[i] == lab)[0]
            # n+1 nearest neighbours of each offending point
            d2 = ((coord[i][bad, None] - coord[i][None]) ** 2).sum(-1)
            knn = np.argsort(d2, axis=1)[:, : n + 1]
            neigh = pred[i][knn]  # [bad, n+1]
            votes = np.apply_along_axis(
                np.bincount, 1, neigh, minlength=n_parts
            )
            votes[:, lab] = 0  # never re-elect the offending label
            pred[i][bad] = votes.argmax(1)
    return pred


def six_fold_aggregate(
    cms: Sequence[ConfusionMatrix],
) -> Dict[str, object]:
    """Sum per-area confusion matrices -> all-area metrics
    (test_s3dis_6fold.py: cfg.allarea_cm.value += all_cm.value)."""
    total = ConfusionMatrix(cms[0].num_classes)
    for cm in cms:
        total.matrix += cm.matrix
    return {
        "oa": total.overall_accuracy,
        "macc": total.mean_accuracy,
        "miou": total.miou,
        "ious": total.iou,
        "per_area_miou": [cm.miou for cm in cms],
    }

"""Weighted box fusion for 3D detections (test-time / auto-label merge).

Port of ``metatransformer_tpu/ops/box_fusion.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

Reference: ``AutonomousDriving/pcdet/models/model_utils/ensemble.py``
(wbf_online, used by CenterPoint3DAL) wrapping the public
weighted_boxes_fusion_3d: boxes from one or more sources are greedily
clustered by per-class IoU thresholds and each cluster is fused into a
single box whose parameters are the score-weighted average and whose
confidence is the cluster's mean score scaled by
min(n_members, n_sources)/n_sources. Host numpy (post-NMS box counts
are tiny); 3D IoU shared with ``data/waymo_eval.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from metatransformer_tpu_torch.data.waymo_eval import iou3d

# per-class fusion thresholds (ensemble.py:18-19; class order
# vehicle/pedestrian/cyclist)
IOU_THRESH = (0.8, 0.6, 0.7)
SKIP_THRESH = (0.1, 0.01, 0.01)


def weighted_box_fusion(
    boxes_list: Sequence[np.ndarray],  # per source [N_i, 7]
    scores_list: Sequence[np.ndarray],
    labels_list: Sequence[np.ndarray],
    iou_thresh: Sequence[float] = IOU_THRESH,
    skip_thresh: Sequence[float] = SKIP_THRESH,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (boxes [M, 7], scores [M], labels [M]) fused across sources."""
    n_sources = max(len(boxes_list), 1)
    rows = []
    for si, (b, s, l) in enumerate(zip(boxes_list, scores_list, labels_list)):
        for i in range(len(s)):
            cls = int(l[i])
            thr = skip_thresh[cls] if cls < len(skip_thresh) else 0.0
            if s[i] >= thr:
                rows.append((float(s[i]), np.asarray(b[i], np.float64),
                             cls, si))
    rows.sort(key=lambda r: -r[0])

    clusters = []  # each: {"label", "members": [(score, box, source)]}
    for score, box, cls, src in rows:
        thr = iou_thresh[cls] if cls < len(iou_thresh) else 0.5
        placed = False
        for c in clusters:
            if c["label"] != cls:
                continue
            if iou3d(box.astype(np.float32), c["fused"].astype(np.float32)) > thr:
                c["members"].append((score, box, src))
                w = np.asarray([m[0] for m in c["members"]])
                bs = np.stack([m[1] for m in c["members"]])
                fused = (bs[:, :6] * w[:, None]).sum(0) / w.sum()
                # heading: weighted circular mean
                sin = (np.sin(bs[:, 6]) * w).sum()
                cos = (np.cos(bs[:, 6]) * w).sum()
                c["fused"] = np.concatenate([fused, [np.arctan2(sin, cos)]])
                placed = True
                break
        if not placed:
            clusters.append({"label": cls, "fused": box.copy(),
                             "members": [(score, box, src)]})

    out_b, out_s, out_l = [], [], []
    for c in clusters:
        scores = np.asarray([m[0] for m in c["members"]])
        srcs = {m[2] for m in c["members"]}
        conf = scores.mean() * min(len(c["members"]), n_sources) / n_sources
        out_b.append(c["fused"].astype(np.float32))
        out_s.append(np.float32(conf))
        out_l.append(np.int32(c["label"]))
    if not out_b:
        return (np.zeros((0, 7), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int32))
    order = np.argsort(-np.asarray(out_s))
    return (np.stack(out_b)[order], np.asarray(out_s)[order],
            np.asarray(out_l)[order])

"""Box-level self-training for 3D detectors (the SemiSECOND pipeline).

Port of ``metatransformer_tpu/train/detector_ssl.py``.

Reference: ``AutonomousDriving/pcdet/utils/self_training_utils.py`` +
``models/detectors/semi_second.py`` — the teacher detects on unlabeled
scans, its boxes are quality-gated into pseudo ground truth
(``save_pseudo_label_batch``: score threshold + NMS + per-class
filtering), the student trains on those boxes with the ordinary
detection loss, and the teacher tracks the student by EMA
(``mean_teacher`` in semi_second.py).

Pseudo boxes live in fixed-capacity [B, G, 7] arrays with a validity mask
(no ragged per-scene lists). Gating runs on host numpy like the
reference's pseudo-label store: the predict output (tensors on the model's
device) comes to the host once a batch, and the score order is numpy's
``argsort`` on those host arrays, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.train.self_training import fresh_grads, mean_teacher_update


@dataclasses.dataclass(frozen=True)
class PseudoBoxConfig:
    score_thresh: float = 0.6  # THRESH in self_training cfgs
    max_boxes: int = 32  # fixed pseudo-gt capacity per scan
    min_boxes: int = 0


def _on_host(dets: Sequence[Dict[str, Any]]) -> List[Dict[str, np.ndarray]]:
    """Detections as numpy: each key's tensors stacked over the batch on
    their device and copied once (numpy input passes through)."""
    out = [dict() for _ in dets]
    for k in dets[0] if dets else ():
        vals = [d[k] for d in dets]
        if all(isinstance(v, torch.Tensor) for v in vals) and len({v.shape for v in vals}) == 1:
            host = torch.stack(vals).cpu().numpy()
            vals = list(host)
        for o, v in zip(out, vals):
            o[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def gate_pseudo_boxes(
    dets: List[Dict[str, Any]],  # detector predict() output
    cfg: PseudoBoxConfig,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Teacher detections -> (boxes [B, G, 7], labels [B, G],
    valid [B, G]) pseudo ground truth (save_pseudo_label_batch gating:
    keep NMS survivors above the score threshold, capacity-capped by
    score rank)."""
    dets = _on_host(dets)
    b = len(dets)
    g = cfg.max_boxes
    boxes = np.zeros((b, g, 7), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, d in enumerate(dets):
        keep = np.asarray(d["valid"]) & (np.asarray(d["scores"]) >= cfg.score_thresh)
        idx = np.argsort(-np.asarray(d["scores"]))
        idx = idx[keep[idx]][:g]
        n = len(idx)
        boxes[i, :n] = np.asarray(d["boxes"])[idx]
        if "labels" in d:
            labels[i, :n] = np.asarray(d["labels"])[idx]
        valid[i, :n] = True
    return boxes, labels, valid


def make_self_training_step(
    loss_fn: Callable,  # (params, points, gt_boxes, gt_valid) -> (loss, logs)
    optimizer,
    ema_decay: float = 0.999,
):
    """One student update on pseudo boxes + EMA teacher update
    (semi_second.py teacher/student roles). ``loss_fn`` is any
    detector's training loss closed over its config/anchors.

    ``step(student, teacher, opt, points, pboxes, pvalid) -> (student,
    teacher, opt, loss, logs)``: ``opt`` is ``optimizer.init(student)`` (a
    ``train/optim`` spec bound to the student's leaf tensors, which it
    updates in place; ``optimizer`` is kept for the reference's signature),
    the teacher comes back as a new tree. The student's gradients stay on
    its leaves (``.grad``) until the next step."""

    def step(student, teacher, opt, points, pboxes, pvalid):
        fresh_grads(student)
        loss, logs = loss_fn(student, points, pboxes, pvalid)
        loss.backward()
        opt.step()
        teacher = mean_teacher_update(teacher, student, ema_decay)
        return student, teacher, opt, loss.detach(), {k: v.detach() for k, v in logs.items()}

    return step

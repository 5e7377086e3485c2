"""Hungarian matching + DETR-style match costs.

Port of ``metatransformer_tpu/ops/matching.py``. The costs are tensor code
on the device; the assignment runs on the host through scipy's
``linear_sum_assignment`` (a small problem with data-dependent control
flow), with a greedy assignment in torch beside it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def classification_cost(pred_logits: torch.Tensor, gt_labels: torch.Tensor) -> torch.Tensor:
    """-P(class) cost [Q, G]."""
    return -torch.softmax(pred_logits, dim=-1)[:, gt_labels.long()]


def bbox_l1_cost(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """L1 box cost [Q, G]."""
    return (pred_boxes[:, None, :] - gt_boxes[None, :, :]).abs().sum(-1)


def focal_mask_cost(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid-focal mask cost: pred [Q, H*W] logits, gt [G, H*W] {0, 1}."""
    p = torch.sigmoid(pred_masks)
    pos = alpha * ((1 - p) ** gamma) * (-torch.log(p.clamp_min(1e-8)))
    neg = (1 - alpha) * (p**gamma) * (-torch.log((1 - p).clamp_min(1e-8)))
    return pos @ gt_masks.T + neg @ (1 - gt_masks).T


def dice_cost(pred_masks: torch.Tensor, gt_masks: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Dice cost [Q, G]."""
    p = torch.sigmoid(pred_masks)
    inter = 2.0 * (p @ gt_masks.T)
    denom = p.sum(-1)[:, None] + gt_masks.sum(-1)[None, :]
    return 1.0 - (inter + eps) / (denom + eps)


def hungarian_assign(cost) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal assignment on the host (scipy); cost [Q, G] -> (rows, cols)."""
    from scipy.optimize import linear_sum_assignment

    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    return linear_sum_assignment(np.asarray(cost))


def greedy_assign(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeatedly take the cheapest unassigned (query, gt) pair. Not
    optimal; -> (query_idx [G], gt_idx [G]) for G = cost.shape[1]."""
    q, g = cost.shape
    c = cost.float().clone()
    rows = torch.zeros(g, dtype=torch.int32, device=cost.device)
    cols = torch.zeros(g, dtype=torch.int32, device=cost.device)
    for i in range(g):
        flat = torch.argmin(c)
        r, col = flat // g, flat % g
        rows[i], cols[i] = r, col
        c[r, :] = float("inf")
        c[:, col] = float("inf")
    return rows, cols

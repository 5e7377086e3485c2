"""RoI-aware 3D point pooling.

Port of ``metatransformer_tpu/ops/roi_pool3d.py``, which replaces pcdet's
roiaware / roipoint CUDA pooling with a dense membership mask and masked
reductions. The max-pool is ``amax``, which splits the gradient evenly
among tied points, as the reference's ``jnp.max`` does.
"""

from __future__ import annotations

import torch


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points [B, N, 3], boxes [B, R, 7] (x, y, z, dx, dy, dz, heading)
    -> bool [B, R, N] membership (pcdet points_in_boxes_gpu)."""
    rel = points[:, None, :, :] - boxes[:, :, None, :3]  # [B, R, N, 3]
    yaw = boxes[..., 6]
    c, s = torch.cos(-yaw)[..., None], torch.sin(-yaw)[..., None]  # into the box frame
    local_x = rel[..., 0] * c - rel[..., 1] * s
    local_y = rel[..., 0] * s + rel[..., 1] * c
    half = boxes[:, :, None, 3:6] / 2.0
    return ((local_x.abs() <= half[..., 0]) & (local_y.abs() <= half[..., 1])
            & (rel[..., 2].abs() <= half[..., 2]))


def roi_max_pool(points: torch.Tensor, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Max of the in-box point features of each RoI -> [B, R, C]; an empty
    RoI gives zeros, as the CUDA kernel's."""
    mask = points_in_boxes(points, boxes)
    masked = torch.where(mask[..., None], features[:, None, :, :], float("-inf"))
    pooled = masked.amax(2)
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


def roi_avg_pool(points: torch.Tensor, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Mean of the in-box point features of each RoI -> [B, R, C]."""
    mask = points_in_boxes(points, boxes).to(features.dtype)
    summed = torch.einsum("brn,bnc->brc", mask, features)
    return summed / mask.sum(-1, keepdim=True).clamp_min(1.0)

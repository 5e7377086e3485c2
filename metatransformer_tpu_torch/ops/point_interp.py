"""3-NN feature interpolation, chamfer distances and an entropic EMD.

Port of ``metatransformer_tpu/ops/point_interp.py``. All of it was XLA in
the reference (top-k, gathers, reductions over one distance matrix) and is
plain torch here.

EMD note: as in the reference, the earth-mover distance is the cost of a
Sinkhorn-regularised transport plan (fixed iteration count, log domain),
not an auction.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from metatransformer_tpu_torch.ops.point_ops import gather_points, square_dists


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each unknown point: 3 nearest known points.
    unknown [B, N, 3], known [B, M, 3] -> (dist2 [B, N, 3], idx [B, N, 3]).
    With M < 3 the nearest point is repeated."""
    d = square_dists(unknown, known)
    k = min(3, known.shape[1])
    neg, idx = torch.topk(-d, k, dim=-1)
    dist2 = -neg
    if k < 3:
        reps = 3 - k
        dist2 = torch.cat([dist2] + [dist2[..., :1]] * reps, dim=-1)
        idx = torch.cat([idx] + [idx[..., :1]] * reps, dim=-1)
    return dist2, idx


def three_interpolate(
    features: torch.Tensor,  # [B, M, C] features at known points
    idx: torch.Tensor,  # [B, N, 3]
    dist2: torch.Tensor,  # [B, N, 3]
) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation -> [B, N, C]. The
    weights are fp32 and promote bf16 features, as in the reference."""
    w = 1.0 / dist2.clamp_min(1e-8)
    w = w / w.sum(dim=-1, keepdim=True)  # [B, N, 3]
    gathered = gather_points(features, idx)  # [B, N, 3, C]
    return (gathered * w[..., None]).sum(dim=2)


def three_interpolation(
    unknown_xyz: torch.Tensor, known_xyz: torch.Tensor, known_feat: torch.Tensor
) -> torch.Tensor:
    """Features at ``known_xyz`` carried to ``unknown_xyz``."""
    dist2, idx = three_nn(unknown_xyz, known_xyz)
    return three_interpolate(known_feat, idx, dist2)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared chamfer: per-batch mean nearest-neighbor
    distances. -> (d1 [B], d2 [B])."""
    d = square_dists(xyz1, xyz2)
    return d.amin(dim=2).mean(dim=1), d.amin(dim=1).mean(dim=1)


def chamfer_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    d1, d2 = chamfer_distance(xyz1, xyz2)
    return (d1 + d2).mean()


def chamfer_l1_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Chamfer-L1: mean of *euclidean* (not squared) bidirectional
    nearest-neighbor distances, halved: the reconstruction loss of the
    masked point ViT."""
    d = square_dists(xyz1, xyz2)
    d1 = d.amin(dim=2).clamp_min(1e-12).sqrt()
    d2 = d.amin(dim=1).clamp_min(1e-12).sqrt()
    return 0.5 * (d1.mean() + d2.mean())


def emd_loss(
    xyz1: torch.Tensor,  # [B, N, 3]
    xyz2: torch.Tensor,  # [B, N, 3] (equal sizes)
    eps: float = 0.02,
    iters: int = 50,
) -> torch.Tensor:
    """Earth-mover distance via Sinkhorn optimal transport on the distance
    matrix: the mean transport cost per batch element."""
    n = xyz1.shape[1]
    cost = square_dists(xyz1, xyz2).clamp_min(1e-12).sqrt()  # [B, N, N]
    log_k = -cost / eps
    log_a = torch.full((cost.shape[0], n), -math.log(n), dtype=cost.dtype, device=cost.device)
    log_b = log_a
    log_u, log_v = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for _ in range(iters):
        log_u = log_a - torch.logsumexp(log_k + log_v[:, None, :], dim=2)
        log_v = log_b - torch.logsumexp(log_k + log_u[:, :, None], dim=1)
    plan = torch.exp(log_k + log_u[:, :, None] + log_v[:, None, :])
    return (plan * cost).sum(dim=(1, 2)).mean()

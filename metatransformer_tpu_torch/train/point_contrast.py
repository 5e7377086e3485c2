"""PointContrast-style unsupervised pretraining for point backbones.

Port of ``metatransformer_tpu/train/point_contrast.py``.

Reference: ``AutonomousDriving/pcdet/models/detectors/unsupervised_model/``
(PointContrast-pattern pretraining of the pv_rcnn_plus backbone) — two
world-augmented views of the same scene pass through the backbone, and
matched points (same original index) form positive pairs for an InfoNCE
objective (``train/self_training.info_nce``).

The reference draws each view's rotation, flip and scale and the pair
indices with ``jax.random``; here they are arguments (``View``, ``pairs``),
drawn from a ``torch.Generator`` on the points' device where they are None.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from metatransformer_tpu_torch.train.self_training import fresh_grads, info_nce


class View(NamedTuple):
    """One view's draws, one value a cloud: the rotation angle [B], the
    flip of y [B] (bool) and the scale [B]."""

    angle: torch.Tensor
    flip: torch.Tensor
    scale: torch.Tensor


def draw_view(b: int, device, generator: Optional[torch.Generator] = None,
              rot_range: float = 0.785398,
              scale_range: Tuple[float, float] = (0.95, 1.05)) -> View:
    """A view's draws from ``generator`` (on ``device``): the angle uniform
    in [-rot_range, rot_range), a flip with probability 0.5, the scale
    uniform in ``scale_range``."""
    u = torch.rand(3, b, generator=generator, device=device)
    return View(angle=(2 * u[0] - 1) * rot_range, flip=u[1] < 0.5,
                scale=scale_range[0] + u[2] * (scale_range[1] - scale_range[0]))


def augment_view(
    points: torch.Tensor,  # [B, N, 3+C]
    view: Optional[View] = None,
    generator: Optional[torch.Generator] = None,
    rot_range: float = 0.785398,
    scale_range: Tuple[float, float] = (0.95, 1.05),
) -> torch.Tensor:
    """Random world rotation/flip/scale of xyz (the data_augmentor world
    transforms) by ``view``'s draws (None: drawn by :func:`draw_view`)."""
    if view is None:
        view = draw_view(points.shape[0], points.device, generator, rot_range, scale_range)
    ang = view.angle.to(points.device, points.dtype)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    xr = x * c - y * s
    yr = x * s + y * c
    yr = torch.where(view.flip.to(points.device)[:, None], -yr, yr)
    xyz = torch.stack([xr, yr, z], -1) * view.scale.to(points.device, points.dtype)[:, None, None]
    return torch.cat([xyz, points[..., 3:]], -1)


def make_pretrain_step(
    feature_fn: Callable,  # (params, points [B,N,3+C]) -> [B, N, D]
    optimizer,
    num_pairs: int = 256,
    temperature: float = 0.07,
):
    """One PointContrast step: two augmented views, per-point features,
    InfoNCE over `num_pairs` subsampled matched indices.

    ``step(params, opt, points, view_a=None, view_b=None, pairs=None,
    generator=None) -> (params, opt, loss)``: ``opt`` is
    ``optimizer.init(params)``, which updates the leaves in place; ``pairs``
    holds ``min(num_pairs, N)`` distinct point indices (None: a random
    permutation's first, drawn from ``generator``)."""

    def step(params, opt, points, view_a=None, view_b=None, pairs=None, generator=None):
        va = augment_view(points, view_a, generator)
        vb = augment_view(points, view_b, generator)
        n = points.shape[1]
        if pairs is None:
            pairs = torch.randperm(n, generator=generator, device=points.device)[
                :min(num_pairs, n)]
        pairs = pairs.to(points.device)
        fresh_grads(params)
        fa = feature_fn(params, va)  # [B, N, D]
        fb = feature_fn(params, vb)
        loss = torch.stack([info_nce(a[pairs], b[pairs], temperature)
                            for a, b in zip(fa, fb)]).mean()
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return step

"""Activation gates: ReLU and leaky ReLU whose gradient takes its side of 0
from one function without gradient.

:func:`gated` is the value of ``torch.relu`` (slope 0) or
``F.leaky_relu(x, slope)``; its gradient takes slope 1 where
:func:`act_gate` says so, as ``jax.nn``'s gradients do (at exactly 0: 0
for ReLU, 1 for a leaky ReLU, where ``F.leaky_relu``'s own backward takes
the slope). On which side of 0 an input within rounding of it falls is a
choice at a rounding edge: a few of the millions of gates flip between fp32
on two devices or against float64, and each flip moves the gradient of a
whole channel. One of the 262,144 gates of UperNet's ``fpn0`` did so in the
port's fp32 at the ADE20K recipe's smoke step on the CPU and alone moved
the ``fpn0/w`` gradient 3.1e-3 of its largest from float64; PointNeXt's
moved 0.5% of its tree at b = 8. Every family's ReLUs (the dense heads'
conv + GroupNorm blocks, the point zoo, the segmentation backbones, the
sparse and BEV stages of the 3D detectors) go through here, so a check
records and replays ``act_gate`` at this one place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def act_gate(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Where an activation passes ``x`` at slope 1, as ``jax.nn``'s
    gradients do: ``x > 0`` for ReLU, ``x >= 0`` for a leaky ReLU. A bool
    mask; no gradient."""
    with torch.no_grad():
        return x >= 0 if slope else x > 0


class _GatedAct(torch.autograd.Function):
    """``F.leaky_relu(x, slope)`` (``torch.relu`` at slope 0) whose
    backward takes slope 1 where ``gate`` and ``slope`` elsewhere; it keeps
    only the bool mask."""

    @staticmethod
    def forward(ctx, x, gate, slope):
        ctx.save_for_backward(gate)
        ctx.slope = slope
        return torch.relu(x) if slope == 0 else F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        (gate,) = ctx.saved_tensors
        return torch.where(gate, g, g * ctx.slope), None, None


def gated(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``torch.relu`` (``slope`` 0) or ``F.leaky_relu(x, slope)``, the
    gradient through :func:`act_gate`."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.relu(x) if slope == 0 else F.leaky_relu(x, slope)
    return _GatedAct.apply(x, act_gate(x.detach(), slope), slope)


def gated_relu(x: torch.Tensor) -> torch.Tensor:
    """``torch.relu``, the gradient through :func:`act_gate`."""
    return gated(x, 0.0)

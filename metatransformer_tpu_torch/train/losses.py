"""Loss zoo: the reference's criterions as functions on tensors.

Port of ``metatransformer_tpu/train/losses.py``. Covers: CE + label-smoothing
CE (openpoints SmoothCrossEntropy), soft-target CE for mixup, BCE-with-logits
(Audio), sigmoid focal and dice (mmseg_custom), L1 (Graph), MSE and masked
MSE (Time-Series). Every loss is the mean over its elements, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _one_hot(labels: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(labels.long(), n).to(dtype)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """CE against soft targets (mixup/distillation)."""
    return -(target_probs * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def cross_entropy(logits, labels, label_smoothing: float = 0.0) -> torch.Tensor:
    if label_smoothing > 0.0:
        n = logits.shape[-1]
        onehot = _one_hot(labels, n, logits.dtype)
        soft = onehot * (1 - label_smoothing) + label_smoothing / n
        return soft_cross_entropy(logits, soft)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1).mean()


def bce_with_logits(logits, targets) -> torch.Tensor:
    """Audio's BCEWithLogitsLoss over multi-hot targets."""
    return F.binary_cross_entropy_with_logits(logits, targets.to(logits.dtype))


def focal(logits, labels, gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Sigmoid focal loss (mmseg_custom/models/losses/focal_loss.py intent)."""
    onehot = _one_hot(labels, logits.shape[-1], logits.dtype)
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, onehot, reduction="none")
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return (a_t * ((1 - p_t) ** gamma) * ce).mean()


def dice(logits, labels, eps: float = 1.0) -> torch.Tensor:
    """Dice loss over per-class probability maps (mmseg_custom dice_loss)."""
    n = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1).reshape(-1, n)
    onehot = _one_hot(labels, n, logits.dtype).reshape(-1, n)
    inter = (probs * onehot).sum(dim=0)
    denom = probs.sum(dim=0) + onehot.sum(dim=0)
    return 1.0 - ((2 * inter + eps) / (denom + eps)).mean()


def l1(pred, target) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse(pred, target) -> torch.Tensor:
    return (pred - target).square().mean()


def masked_mse(pred, target, mask) -> torch.Tensor:
    """Imputation loss on masked positions only."""
    m = mask.to(pred.dtype)
    return ((pred - target).square() * m).sum() / m.sum().clamp_min(1.0)

"""Semi-/self-supervised training utilities.

Port of ``metatransformer_tpu/train/self_training.py``.

Reference: AutonomousDriving's SSL stack — pseudo-label store + quality
gating (``pcdet/utils/self_training_utils.py:20-232``), memory ensemble
(``memory_ensemble_utils.py``), SESS-style teacher-student consistency
(``tools/ssl_utils/``), and PointContrast pretraining
(``tools/unsupervised_utils/pointcontrast_utils.py``).

The functions take tensors; :func:`memory_ensemble_update` also takes
numpy arrays (the pseudo-label store's host copies) and keeps their dtype.
:func:`fresh_grads` is the port's own: the steps of ``detector_ssl``,
``multi_db`` and ``point_contrast`` differentiate the tree they update.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core.tree import leaves, tree_map


def fresh_grads(tree: Any) -> None:
    """Clear every leaf's gradient and let the floating leaves take one
    (``train/optim``'s optimizers read ``.grad`` and update the leaves in
    place)."""
    for leaf in leaves(tree):
        leaf.grad = None
        if leaf.is_floating_point():
            leaf.requires_grad_(True)


def pseudo_labels(
    logits: torch.Tensor, threshold: float = 0.9
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Confidence-gated hard labels: -> (labels [B], keep [B])."""
    probs = F.softmax(logits, dim=-1)
    conf = probs.amax(-1)
    return probs.argmax(-1), conf >= threshold


def memory_ensemble_update(stored_logits: Any, new_logits: Any, momentum: float = 0.9) -> Any:
    """Memory-ensemble-style smoothing of pseudo labels across rounds
    (``[B, C]`` running pseudo-label logits)."""
    return stored_logits * momentum + new_logits * (1.0 - momentum)


def consistency_loss(
    student_logits: torch.Tensor, teacher_logits: torch.Tensor
) -> torch.Tensor:
    """SESS-style teacher-student consistency: KL(student || sg(teacher))."""
    t = F.softmax(teacher_logits, dim=-1).detach()
    log_s = F.log_softmax(student_logits, dim=-1)
    return -(t * log_s).sum(-1).mean()


def info_nce(
    feats_a: torch.Tensor,  # [N, D] matched point/crop features, view A
    feats_b: torch.Tensor,  # [N, D] same points, view B
    temperature: float = 0.07,
) -> torch.Tensor:
    """PointContrast InfoNCE over matched features of two augmented views."""
    a = feats_a / feats_a.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    b = feats_b / feats_b.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    logits = (a @ b.T) / temperature
    loss_ab = -F.log_softmax(logits, dim=-1).diagonal().mean()
    loss_ba = -F.log_softmax(logits.T, dim=-1).diagonal().mean()
    return 0.5 * (loss_ab + loss_ba)


def mean_teacher_update(teacher: Dict, student: Dict, decay: float = 0.999):
    """EMA teacher update (the SSL teacher is the EMA of the student): a
    new tree, ``t * decay + s * (1 - decay)`` leaf by leaf, off the graph."""
    with torch.no_grad():
        return tree_map(lambda t, s: t * decay + s.detach() * (1.0 - decay), teacher, student)

"""Training step: frozen-encoder fine-tuning, the reference's core recipe.

Port of ``metatransformer_tpu/train/step.py``. The reference freezes the
shared encoder and trains only tokenizer + head. Here the split is the same
and the mechanics are PyTorch's: trainable leaves are leaf tensors with
``requires_grad=True`` that the optimizer updates in place; frozen leaves
have it off, so autograd computes no weight gradient for them (the
activation gradient still flows through all blocks to reach the tokenizer).
Under the BF16 policy a frozen encoder is cast once, outside the step
(``core.encoder.cast_params``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from metatransformer_tpu_torch.core.tree import leaves, unflatten_like
from metatransformer_tpu_torch.train import losses
from metatransformer_tpu_torch.train.optim import TreeOptimizer

# Subtrees held frozen in the canonical recipe.
FROZEN_KEYS = ("encoder",)


def split_params(
    params: Dict[str, Any], frozen_keys=FROZEN_KEYS
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    trainable = {k: v for k, v in params.items() if k not in frozen_keys}
    frozen = {k: v for k, v in params.items() if k in frozen_keys}
    return trainable, frozen


def merge_params(trainable: Dict[str, Any], frozen: Dict[str, Any]) -> Dict[str, Any]:
    return {**trainable, **frozen}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return losses.cross_entropy(logits, labels)


def _accuracy(logits, label) -> torch.Tensor:
    # Accuracy only makes sense when forward returns class logits and the
    # label is an integer id per sample; structured tasks report loss only.
    is_cls = (
        isinstance(logits, torch.Tensor)
        and isinstance(label, torch.Tensor)
        and logits.dim() == label.dim() + 1
        and not label.is_floating_point()
        and label.dtype != torch.bool
    )
    if not is_cls:
        device = logits.device if isinstance(logits, torch.Tensor) else None
        return torch.zeros((), device=device)
    return (logits.argmax(dim=-1) == label).float().mean()


def _to_micro(batch: Any, accum_steps: int) -> List[Any]:
    """The batch as ``accum_steps`` micro-batches: every leaf of the tree
    split along axis 0 (``None`` leaves stay ``None``), as the reference
    maps over the whole batch pytree."""

    def split(t):
        if t.dim() == 0 or t.shape[0] % accum_steps:
            raise ValueError(
                f"batch axis {tuple(t.shape)} not divisible by accum_steps={accum_steps}"
            )
        return t.reshape((accum_steps, -1) + tuple(t.shape[1:])).unbind(0)

    parts = [split(t) for t in leaves(batch)]
    return [unflatten_like(batch, [p[i] for p in parts]) for i in range(accum_steps)]


def make_train_step(
    forward: Callable[[Dict[str, Any], torch.Tensor, Optional[torch.Generator]], torch.Tensor],
    optimizer: TreeOptimizer,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = cross_entropy_loss,
    accum_steps: int = 1,
):
    """Build ``train_step(trainable, frozen, batch, generator) -> metrics``.

    ``forward(params, inputs, generator) -> logits``; ``optimizer`` is bound
    to the leaves of ``trainable`` (``spec.init(trainable)``) and updates
    them in place. ``metrics`` holds ``loss`` and ``acc`` as 0-dim tensors
    on the batch's device: nothing in the step waits for the device.

    ``accum_steps > 1`` is gradient accumulation (the reference's
    ``accum_iter``): the batch's leading axis is split into ``accum_steps``
    micro-batches that run forward and backward in turn, so peak activation
    memory is per micro-batch while the optimizer sees the full-batch mean
    gradient in one update. Requires ``B % accum_steps == 0``; all
    micro-batches draw from the one ``generator``.
    """
    inv = 1.0 / accum_steps

    def train_step(trainable, frozen, batch, generator=None):
        micro = [batch] if accum_steps == 1 else _to_micro(batch, accum_steps)
        params = merge_params(trainable, frozen)
        optimizer.zero_grad(set_to_none=True)
        loss_sum = acc_sum = None
        for mb in micro:
            logits = forward(params, mb["input"], generator)
            loss = loss_fn(logits, mb.get("label"))
            # each micro-batch adds 1/accum of its gradient: the mean
            (loss * inv if accum_steps > 1 else loss).backward()
            acc = _accuracy(
                logits.detach() if isinstance(logits, torch.Tensor) else logits,
                mb.get("label"),
            )
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            acc_sum = acc if acc_sum is None else acc_sum + acc
        optimizer.step()
        if accum_steps > 1:
            loss_sum, acc_sum = loss_sum * inv, acc_sum * inv
        return {"loss": loss_sum, "acc": acc_sum}

    return train_step

"""Exponential moving average of params (Video's ModelEma,
``run_class_finetuning.py:678-685`` / timm ModelEma semantics).

Port of ``metatransformer_tpu/train/ema.py``. The average is a detached copy
of the tree and is updated in place."""

from __future__ import annotations

from typing import Any

import torch


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init(params: Any) -> Any:
    """A copy: the optimizer updates the parameters in place, and an aliased
    average would follow them."""
    return _map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def update(ema_params: Any, params: Any, decay: float = 0.9999) -> Any:
    """``e <- e * decay + p * (1 - decay)`` in place; returns ``ema_params``."""
    _map(
        lambda e, p: e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay),
        ema_params,
        params,
    )
    return ema_params

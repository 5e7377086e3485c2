"""LR schedules: the reference's scheduler families as plain functions
``step -> learning rate``.

Port of ``metatransformer_tpu/train/schedules.py``, which builds them from
optax. optax is not available to this package, so the optax semantics are
written out: ``linear_schedule`` clips the step to its span;
``cosine_decay_schedule`` clips the step to ``decay_steps`` and decays to
``alpha * init``; ``join_schedules`` switches at ``step >= boundary`` and
hands the next schedule ``step - boundary``; ``piecewise_constant_schedule``
applies a scale from ``step >= boundary`` on. A schedule takes the number of
optimizer updates already made (0 for the first) and returns a float.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def sched(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine_decay(init: float, decay_steps: int, alpha: float) -> Schedule:
    def sched(count):
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return sched


def cosine_with_warmup(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    min_lr: float = 1e-6,
    warmup_init_lr: float = 1e-6,
) -> Schedule:
    alpha = min_lr / base_lr
    if warmup_steps > 0:
        warmup = _linear(warmup_init_lr, base_lr, warmup_steps)
        cosine = _cosine_decay(base_lr, max(total_steps - warmup_steps, 1), alpha)
        return lambda count: (
            warmup(count) if count < warmup_steps else cosine(count - warmup_steps)
        )
    return _cosine_decay(base_lr, total_steps, alpha)


def multistep(base_lr: float, milestones: Sequence[int], gamma: float = 0.5) -> Schedule:
    """MultiStepLR: lr *= gamma at each milestone step."""
    marks = sorted(int(m) for m in milestones)
    return lambda count: base_lr * gamma ** sum(count >= m for m in marks)


def step_decay(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch StepLR (X-Ray train.py:139)."""
    return lambda count: base_lr * (gamma ** (count // step_size))


def poly(
    base_lr: float, total_steps: int, power: float = 1.0, min_lr: float = 0.0
) -> Schedule:
    """mmseg poly policy: lr = base * (1 - t/T)^power."""

    def sched(count):
        frac = 1.0 - min(count, total_steps) / total_steps
        return max(base_lr * (frac**power), min_lr)

    return sched


def one_cycle(
    base_lr: float,
    total_steps: int,
    pct_start: float = 0.4,
    div_factor: float = 10.0,
    final_div: float = 1e4,
) -> Schedule:
    """fastai/pcdet OneCycle: warm up to base_lr then cosine to
    base_lr/final_div (``learning_schedules_fastai.py`` OneCycle)."""
    up = int(total_steps * pct_start)
    down = max(total_steps - up, 1)
    start = base_lr / div_factor
    end = base_lr / final_div

    def sched(count):
        if count < up:
            up_frac = count / max(up, 1)
            return start + (base_lr - start) * 0.5 * (1 - math.cos(math.pi * up_frac))
        down_frac = min((count - up) / down, 1.0)
        return end + (base_lr - end) * 0.5 * (1 + math.cos(math.pi * down_frac))

    return sched


def type1_halving(base_lr: float, steps_per_epoch: int) -> Schedule:
    """Time-Series ``adjust_learning_rate`` 'type1': lr halves each epoch."""
    return lambda count: base_lr * (0.5 ** (count // max(steps_per_epoch, 1)))


def linear_scaled_lr(base_lr: float, batch_size: int, base_batch: int = 256) -> float:
    """Video's linear LR scaling x bs/256 (run_class_finetuning.py:694-700)."""
    return base_lr * batch_size / base_batch

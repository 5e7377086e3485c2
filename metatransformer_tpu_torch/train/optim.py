"""Optimizer factory: AdamW / Adam / SGD / LAMB / LARS / AdaBelief / RAdam +
gradient clipping + layer-wise LR decay over a parameter tree.

Port of ``metatransformer_tpu/train/optim.py``, which chains optax
transforms. optax is not available to this package, so the update rules are
written out here with optax's semantics:

* ``adamw``: every leaf is decayed (no mask); the direction is
  ``m_hat / (sqrt(v_hat) + eps) + wd * p`` with eps 1e-8 outside the root,
  then times ``-lr``. ``adam`` is the same without the decay term.
* ``sgd``: Nesterov momentum as ``optax.trace``: ``t = g + mu * t``, update
  ``g + mu * t``.
* ``lamb``: the Adam direction with eps 1e-6, plus ``wd * p``, scaled by the
  trust ratio ``|p| / |u|`` per leaf (1 where either norm is 0).
* ``lars``: ``u = g + wd * p`` scaled by ``0.001 * |p| / |u|`` per leaf,
  then by ``-lr``, then plain momentum ``t = u + mu * t`` (the trace holds
  the scaled update, as ``optax.lars`` chains it).
* ``adabelief``: the second moment tracks ``(g - m)^2`` plus 1e-16, and eps
  1e-16 outside the root.
* ``radam``: the Adam direction rectified by ``r`` once the variance is
  tractable (``rho >= 5``), the bias-corrected first moment before that.
* ``grad_clip``: ``clip_by_global_norm``: gradients are scaled by
  ``max_norm / max(norm, max_norm)``, with no epsilon added to the norm.
* a learning-rate schedule is called with the number of updates already
  made, so the first update uses ``lr(0)``.
* layer decay multiplies the finished update, after the optimizer.

Layer decay on the stacked encoder: every encoder leaf carries a leading
depth axis and the factor is a ``[depth]`` vector broadcast over the
update. One tensor has one learning rate in a ``torch.optim`` param group,
so param groups cannot express this; :class:`TreeOptimizer` keeps a
broadcastable ``lr_scale`` per leaf instead, and the stacked leaves stay
whole (the checkpoint layout depends on them).

:func:`build` / :func:`make_optimizer` return an :class:`OptimizerSpec`,
the counterpart of an optax ``GradientTransformation``: a recipe without
parameters. ``spec.init(trainable)`` binds it to a tree of leaf tensors and
returns the :class:`TreeOptimizer` that updates them in place. Parameters
and state are fp32 under both precision policies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metatransformer_tpu_torch.core.tree import leaves_with_path, unflatten_like

_PORTED = ("adamw", "adam", "sgd", "lamb", "lars", "adabelief", "radam")
# optimizers with optax's ScaleByAdamState-like state (count, mu, nu)
_ADAM_LIKE = ("adamw", "adam", "lamb", "adabelief", "radam")
_EPS = {"adamw": 1e-8, "adam": 1e-8, "lamb": 1e-6, "adabelief": 1e-16, "radam": 1e-8}
_ADABELIEF_EPS_ROOT = 1e-16
_RADAM_THRESHOLD = 5.0
_LARS_TRUST = 0.001

TOKENIZER_KEYS = ("tokenizer", "pos_embed", "prefix_tokens", "cls_token", "cls_pos")


def layer_decay_factors(depth: int, decay_rate: float):
    """Per-layer LR factors, timm/mmcv convention: encoder block i gets
    ``decay_rate**(depth - i)``, the embedding/tokenizer gets
    ``decay_rate**(depth + 1)``, the head gets 1.0.

    Returns (embed_factor, [depth] encoder factors, head_factor=1.0).
    """
    embed = decay_rate ** (depth + 1)
    layers = torch.tensor(
        [decay_rate ** (depth - i) for i in range(depth)], dtype=torch.float32
    )
    return float(embed), layers, 1.0


def scale_by_layer_decay(
    decay_rate: float,
    depth: int,
    encoder_key: str = "encoder",
    tokenizer_keys: Sequence[str] = TOKENIZER_KEYS,
) -> Callable[[Tuple[str, ...], torch.Tensor], Any]:
    """``(path, leaf) -> lr_scale``: a ``[depth, 1, ...]`` tensor for stacked
    encoder leaves, the deepest (smallest) factor for tokenizer/embedding
    subtrees, 1.0 for heads and everything else."""
    embed_f, layer_f, _ = layer_decay_factors(depth, decay_rate)

    def scale(path, leaf):
        top = path[0] if path else None
        if top == encoder_key:
            shape = (depth,) + (1,) * (leaf.dim() - 1)
            return layer_f.reshape(shape).to(device=leaf.device, dtype=leaf.dtype)
        if top in tokenizer_keys:
            return embed_f
        return 1.0

    return scale


class TreeOptimizer(torch.optim.Optimizer):
    """An :class:`OptimizerSpec` bound to a tree of leaf tensors.

    ``step()`` reads each leaf's ``.grad`` (a missing gradient counts as
    zeros, as it does in the reference, where weight decay still applies)
    and updates the leaf in place. ``count`` is the number of updates made.
    """

    def __init__(self, spec: "OptimizerSpec", trainable: Dict[str, Any]):
        self.spec = spec
        self.tree = trainable
        flat = leaves_with_path(trainable)
        leaves = [leaf for _, leaf in flat]
        super().__init__(leaves, {})
        self.leaves = leaves
        self.count = 0
        scale_fn = spec.lr_scale_fn
        self.lr_scales = [
            1.0 if scale_fn is None else scale_fn(p, leaf) for p, leaf in flat
        ]
        # per-leaf moments: the Adam-like ones have mu and nu, sgd and lars
        # keep their trace in mu
        self.mu = [torch.zeros_like(leaf, dtype=torch.float32) for leaf in leaves]
        self.nu = (
            [torch.zeros_like(leaf, dtype=torch.float32) for leaf in leaves]
            if spec.name in _ADAM_LIKE
            else []
        )

    def learning_rate(self) -> float:
        lr = self.spec.lr
        return float(lr(self.count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TreeOptimizer.step takes no closure")
        spec = self.spec
        grads = [
            torch.zeros_like(p) if p.grad is None else p.grad for p in self.leaves
        ]
        if spec.grad_clip:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            factor = spec.grad_clip / torch.clamp(norm, min=spec.grad_clip)
            grads = [g * factor.to(g.dtype) for g in grads]
        lr = self.learning_rate()
        self.count += 1
        if spec.name == "sgd":
            for p, g, t, s in zip(self.leaves, grads, self.mu, self.lr_scales):
                t.mul_(spec.momentum).add_(g)
                update = (g + spec.momentum * t) * (-lr)
                p.add_((update * s).to(p.dtype))
            return None
        if spec.name == "lars":
            for p, g, t, s in zip(self.leaves, grads, self.mu, self.lr_scales):
                u = g.float() + spec.weight_decay * p
                u = u * _trust_ratio(p, u, _LARS_TRUST)
                t.mul_(spec.momentum).add_(u * (-lr))
                p.add_((t * s).to(p.dtype))
            return None
        b1, b2 = spec.betas
        c1, c2 = 1.0 - b1**self.count, 1.0 - b2**self.count
        eps = _EPS[spec.name]
        rectify = None
        if spec.name == "radam":
            # in fp32, as a jitted optax step computes it: rho is a small
            # difference of two terms near 2 / (1 - b2), so its rounding
            # moves r by up to 0.6% at the first rectified steps
            f32 = np.float32
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            b2t = f32(b2) ** f32(self.count)
            rho = f32(rho_inf) - f32(2 * self.count) * b2t / (f32(1.0) - b2t)
            if rho >= _RADAM_THRESHOLD:
                rectify = float(np.sqrt(
                    (rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
                    / (f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho)))
        for p, g, m, v, s in zip(self.leaves, grads, self.mu, self.nu, self.lr_scales):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            if spec.name == "adabelief":
                d = g - m
                v.mul_(b2).addcmul_(d, d, value=1.0 - b2).add_(_ADABELIEF_EPS_ROOT)
            else:
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            if spec.name == "radam" and rectify is None:
                update = m / c1
            else:
                update = (m / c1) / ((v / c2).sqrt_().add_(eps))
                if rectify is not None:
                    update.mul_(rectify)
            if spec.name in ("adamw", "lamb"):
                update.add_(p, alpha=spec.weight_decay)
            if spec.name == "lamb":
                update.mul_(_trust_ratio(p, update, 1.0))
            update.mul_(-lr)
            p.add_((update * s).to(p.dtype))
        return None

    # -- state carried across packages and checkpoints ----------------------

    def state_leaves(self) -> List[Any]:
        """The state as the flat list of leaves that
        ``jax.tree_util.tree_leaves`` gives for the reference's optax state
        of the same recipe: the Adam-like ones ``[count, *mu, *nu]``, sgd
        ``[*trace]``, then the schedule's own count if the learning rate is a
        schedule; lars puts the schedule's count first (``[count, *trace]``),
        as its chain scales by the rate before the trace."""
        leaves: List[Any] = []
        schedule = [np.int32(self.count)] if callable(self.spec.lr) else []
        if self.spec.name in _ADAM_LIKE:
            leaves.append(np.int32(self.count))
        if self.spec.name == "lars":
            leaves += schedule
        leaves += list(self.mu) + list(self.nu)
        if self.spec.name != "lars":
            leaves += schedule
        return leaves

    def load_state_leaves(self, leaves: Sequence[Any]) -> None:
        """Inverse of :meth:`state_leaves` (numpy arrays or tensors)."""
        leaves = list(leaves)
        n = len(self.leaves)
        adam = self.spec.name in _ADAM_LIKE
        schedule = callable(self.spec.lr)
        want = (1 + 2 * n if adam else n) + (1 if schedule else 0)
        if len(leaves) != want:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, expected {want}")
        if adam or (schedule and self.spec.name == "lars"):
            self.count = int(np.asarray(_to_host(leaves.pop(0))))
        if schedule and self.spec.name != "lars":
            self.count = int(np.asarray(_to_host(leaves.pop())))
        for dst, src in zip(list(self.mu) + list(self.nu), leaves):
            src = torch.tensor(_to_host(src))
            if src.shape != dst.shape:
                raise ValueError(f"state leaf {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def _trust_ratio(p: torch.Tensor, u: torch.Tensor, coefficient: float) -> torch.Tensor:
    """``coefficient * |p| / |u|`` (Frobenius norms of the whole leaf), 1
    where either norm is 0: ``optax.scale_by_trust_ratio``."""
    pn, un = p.float().norm(), u.norm()
    ratio = coefficient * pn / un
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


def _to_host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def state_from_optax(opt: TreeOptimizer, count, mu: Dict[str, Any], nu: Dict[str, Any]) -> None:
    """Load an optax Adam-like state (``count``, ``mu`` and ``nu`` as numpy
    trees shaped like the trainable tree: ``ScaleByAdamState``, or
    ``ScaleByBeliefState`` for adabelief) into ``opt``, so both packages can
    go on from one mid-training state. For sgd and lars ``mu`` is the trace
    and ``nu`` is empty."""
    opt.count = int(np.asarray(count))
    for dst_list, tree in ((opt.mu, mu), (opt.nu, nu)):
        for dst, (_, src) in zip(dst_list, leaves_with_path(tree)):
            dst.copy_(torch.tensor(np.asarray(src)))


def state_to_optax(opt: TreeOptimizer):
    """``(count, mu, nu)`` of ``opt`` as numpy, trees shaped like the
    trainable tree (``nu`` empty for sgd and lars): the inverse of
    :func:`state_from_optax`."""
    to_tree = lambda leaves: unflatten_like(opt.tree, [_to_host(t) for t in leaves])
    return np.int32(opt.count), to_tree(opt.mu), to_tree(opt.nu) if opt.nu else {}


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer recipe without parameters; ``init`` binds it to a tree."""

    name: str = "adamw"
    lr: Union[float, Callable[[int], float]] = 1e-3
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.9
    grad_clip: Optional[float] = None
    lr_scale_fn: Optional[Callable] = None

    def init(self, trainable: Dict[str, Any]) -> TreeOptimizer:
        return TreeOptimizer(self, trainable)


def make_optimizer(
    name: str = "adamw",
    lr: Union[float, Callable[[int], float]] = 1e-3,
    weight_decay: float = 0.05,
    betas=(0.9, 0.999),
    momentum: float = 0.9,
    grad_clip: Optional[float] = None,
) -> OptimizerSpec:
    """The reference's optimizer zoo, by name."""
    name = name.lower()
    if name not in _PORTED:
        raise ValueError(f"unknown optimizer {name!r}")
    return OptimizerSpec(
        name=name, lr=lr, weight_decay=weight_decay, betas=tuple(betas),
        momentum=momentum, grad_clip=grad_clip or None,
    )


def build(
    name: str,
    lr,
    weight_decay: float = 0.05,
    layer_decay: Optional[float] = None,
    encoder_depth: int = 12,
    grad_clip: Optional[float] = None,
    **kw,
) -> OptimizerSpec:
    """One-stop factory: optimizer (+ optional grad clip + layer decay)."""
    spec = make_optimizer(name, lr, weight_decay, grad_clip=grad_clip, **kw)
    if layer_decay is not None and layer_decay < 1.0:
        spec = dataclasses.replace(
            spec, lr_scale_fn=scale_by_layer_decay(layer_decay, encoder_depth)
        )
    return spec

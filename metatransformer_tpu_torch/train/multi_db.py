"""Multi-dataset fusion (MDF) + self-training orchestration.

Port of ``metatransformer_tpu/train/multi_db.py``.

Reference machinery this replaces:

* ``AutonomousDriving/tools/train_multi_db.py`` /
  ``train_multi_db_merge_loss.py`` — paired per-dataset dataloaders and a
  step that merges both datasets' losses into one optimizer update.
* ``pcdet/utils/self_training_utils.py:20-232`` — a pseudo-label store
  filled by the (teacher) model with confidence gating, refreshed every
  few epochs, optionally smoothed by the memory ensemble
  (``memory_ensemble_utils.py``).

The merged step runs both datasets' batches through one forward with a
``dataset_id`` (per-dataset params are gathered, models/mdf.py) and one
backward. The optimizer is a ``train/optim`` spec bound to the parameter
tree (``opt = optimizer.init(params)``), which it updates in place. The
reference splits a PRNG key per dataset (and per role in the
teacher-student step); here the two draws are one argument, ``rng``,
handed to the loss or forward function as they are, and drawn from
generators on the parameters' device where it is None. The pseudo-label
store is host-side numpy keyed by sample id (it is IO/state, not
compute), saved as npz in the reference's format.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core.tree import leaves
from metatransformer_tpu_torch.train import self_training as ssl


def paired_batches(
    loader_a: Iterable, loader_b: Iterable, steps: int
) -> Iterator[Tuple[Any, Any]]:
    """Zip two dataset loaders for `steps` steps, restarting whichever
    runs out (train_multi_db.py's alternating source loaders)."""
    it_a, it_b = iter(loader_a), iter(loader_b)
    for _ in range(steps):
        try:
            a = next(it_a)
        except StopIteration:
            it_a = iter(loader_a)
            a = next(it_a)
        try:
            b = next(it_b)
        except StopIteration:
            it_b = iter(loader_b)
            b = next(it_b)
        yield a, b


def _two_draws(params, rng):
    """``rng`` as given, or two generators on the parameters' device seeded
    from torch's default generator."""
    if rng is not None:
        return rng
    dev = leaves(params)[0].device
    seeds = torch.randint(0, 2**62, (2,)).tolist()
    return tuple(torch.Generator(device=dev).manual_seed(s) for s in seeds)


def make_merged_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer,
    weight_a: float = 1.0,
    weight_b: float = 1.0,
):
    """One optimizer update from both datasets' losses
    (train_multi_db_merge_loss.train_multi_db_model).

    ``loss_fn(params, batch, dataset_id, rng) -> scalar``; the returned
    step: ``step(params, opt, batch_a, batch_b, rng=None) -> (params, opt,
    metrics)``, ``rng`` a pair (dataset 0's draw, dataset 1's). The
    gradients stay on the leaves (``.grad``) until the next step.
    """

    def step(params, opt, batch_a, batch_b, rng=None):
        ka, kb = _two_draws(params, rng)
        ssl.fresh_grads(params)
        la = loss_fn(params, batch_a, 0, ka)
        lb = loss_fn(params, batch_b, 1, kb)
        loss = weight_a * la + weight_b * lb
        loss.backward()
        opt.step()
        return params, opt, {"loss": loss.detach(), "loss_a": la.detach(),
                             "loss_b": lb.detach()}

    return step


# ---------------------------------------------------------------------------
# pseudo-label store (self_training_utils.PSEUDO_LABELS equivalent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PseudoLabelStore:
    """Host-side pseudo-label store with confidence gating + refresh.

    Keyed by integer sample id. Each entry holds the (possibly memory-
    ensembled) class logits and the gated hard label (-1 = ignored, the
    reference's low-confidence ignore bucket).
    """

    num_classes: int
    threshold: float = 0.9
    momentum: float = 0.9  # memory-ensemble smoothing
    logits: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def update_batch(
        self, ids: np.ndarray, logits: np.ndarray, ensemble: bool = True
    ) -> Tuple[int, int]:
        """save_pseudo_label_batch: gate by confidence, smooth across
        rounds via the memory ensemble (float32, as the reference's).
        -> (num_kept, num_ignored)."""
        kept = ignored = 0
        for i, sid in enumerate(np.asarray(ids).tolist()):
            new = np.asarray(logits[i], np.float32)
            if ensemble and sid in self.logits:
                new = ssl.memory_ensemble_update(
                    torch.from_numpy(self.logits[sid]), torch.from_numpy(new), self.momentum,
                ).numpy()
            self.logits[sid] = new
            if self.label_of(sid) >= 0:
                kept += 1
            else:
                ignored += 1
        return kept, ignored

    def label_of(self, sid: int) -> int:
        l = self.logits.get(sid)
        if l is None:
            return -1
        p = np.exp(l - l.max())
        p = p / p.sum()
        return int(p.argmax()) if float(p.max()) >= self.threshold else -1

    def labels_for(self, ids: np.ndarray) -> np.ndarray:
        """-> hard labels [N] (-1 where below the confidence gate)."""
        return np.asarray([self.label_of(int(s)) for s in np.asarray(ids)],
                          np.int32)

    def save(self, path: str) -> None:
        ids = np.asarray(sorted(self.logits), np.int64)
        arr = np.stack([self.logits[int(i)] for i in ids]) if len(ids) else (
            np.zeros((0, self.num_classes), np.float32)
        )
        np.savez(path, ids=ids, logits=arr,
                 threshold=self.threshold, momentum=self.momentum)

    @classmethod
    def load(cls, path: str, num_classes: int) -> "PseudoLabelStore":
        z = np.load(path)
        store = cls(num_classes=num_classes,
                    threshold=float(z["threshold"]),
                    momentum=float(z["momentum"]))
        for sid, lg in zip(z["ids"].tolist(), z["logits"]):
            store.logits[int(sid)] = np.asarray(lg, np.float32)
        return store


def fill_pseudo_labels(
    store: PseudoLabelStore,
    predict_fn: Callable[[Any], Any],  # batch -> logits [B, C]
    loader: Iterable[Tuple[np.ndarray, Any]],  # yields (ids, batch)
    ensemble: bool = True,
) -> Tuple[int, int]:
    """save_pseudo_label_epoch: run the teacher over the unlabeled set and
    (re)fill the store. -> totals (kept, ignored)."""
    kept = ignored = 0
    for ids, batch in loader:
        with torch.no_grad():
            logits = predict_fn(batch)
        logits = logits.cpu().numpy() if isinstance(logits, torch.Tensor) else np.asarray(logits)
        k, g = store.update_batch(ids, logits, ensemble=ensemble)
        kept += k
        ignored += g
    return kept, ignored


# ---------------------------------------------------------------------------
# teacher-student step (SESS / mean-teacher, tools/ssl_utils)
# ---------------------------------------------------------------------------

def make_teacher_student_step(
    forward_fn: Callable[..., torch.Tensor],  # (params, batch, rng) -> logits
    optimizer,
    consistency_weight: float = 1.0,
    ema_decay: float = 0.999,
):
    """Student trains on gated pseudo labels + consistency to the EMA
    teacher; the teacher follows the student by EMA.

    step(student, teacher, opt, batch, pseudo_labels [B] (-1 = ignore),
    rng=None) -> (student, teacher, opt, metrics); ``rng`` a pair (the
    student's draw, the teacher's).
    """

    def step(student, teacher, opt, batch, labels, rng=None):
        ks, kt = _two_draws(student, rng)
        with torch.no_grad():
            t_logits = forward_fn(teacher, batch, kt)
        ssl.fresh_grads(student)
        s_logits = forward_fn(student, batch, ks)
        labels = labels.long()
        keep = (labels >= 0).float()
        safe = labels.clamp_min(0)
        ce = -F.log_softmax(s_logits, -1).gather(-1, safe[:, None])[:, 0]
        sup = (ce * keep).sum() / keep.sum().clamp_min(1.0)
        cons = ssl.consistency_loss(s_logits, t_logits)
        loss = sup + consistency_weight * cons
        loss.backward()
        opt.step()
        teacher = ssl.mean_teacher_update(teacher, student, ema_decay)
        return student, teacher, opt, {
            "loss": loss.detach(), "supervised": sup.detach(), "consistency": cons.detach(),
        }

    return step

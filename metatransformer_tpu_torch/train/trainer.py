"""The unified Trainer: one engine replacing the reference's five.

Port of ``metatransformer_tpu/train/trainer.py`` (epoch loops of the same
shape: train epoch -> validate -> checkpoint / best / EMA). The parameters
live on one device; each batch (nested dicts of numpy arrays or tensors, as
the reference's pytrees) is moved there.
The step runs eagerly, so ``jit_step`` has no counterpart. Metrics stay on
the device and are read on the host only every ``log_every`` steps and at
the end of an epoch, so steps queue up without waiting for one another.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.train import ema as ema_lib
from metatransformer_tpu_torch.train import step as step_lib
from metatransformer_tpu_torch.train.optim import OptimizerSpec
from metatransformer_tpu_torch.utils import checkpoint as ckpt_lib
from metatransformer_tpu_torch.utils.logger import setup_logger


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 100
    val_freq: int = 1
    ckpt_dir: Optional[str] = None
    max_keep: int = 5
    use_ema: bool = False
    ema_decay: float = 0.9999
    early_stop_patience: Optional[int] = None
    best_mode: str = "max"  # "max" (acc) | "min" (loss/MAE)
    log_every: int = 50
    # gradient accumulation (reference accum_iter / update_freq): the batch
    # splits into accum_steps micro-batches inside ONE optimizer step:
    # full-batch mean gradient, per-micro-batch memory.
    accum_steps: int = 1
    # async_ckpt: serialize/IO epoch checkpoints in a background thread
    # (the device snapshot stays synchronous: parameters update in place).
    async_ckpt: bool = False
    # handle_preemption: SIGTERM/SIGINT -> finish the current step, save a
    # resumable checkpoint, return from fit cleanly (auto_resume redoes the
    # interrupted epoch on restart).
    handle_preemption: bool = False


def batch_to_device(tree: Any, device: torch.device) -> Any:
    """A batch (nested dicts of numpy arrays or tensors, ``None`` leaves
    kept) with every array leaf a tensor on ``device``. Copies run
    asynchronously only from pinned host memory."""
    if isinstance(tree, dict):
        return {k: batch_to_device(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    t = torch.as_tensor(tree)
    return t.to(device, non_blocking=t.is_pinned())


def _to_device_tree(tree: Any, device: torch.device, trainable: bool) -> Any:
    """A copy of the tree on ``device``; floating leaves of a trainable tree
    become fp32-or-as-given leaf tensors that take a gradient."""
    if isinstance(tree, dict):
        return {k: _to_device_tree(v, device, trainable) for k, v in tree.items()}
    t = torch.as_tensor(tree).detach().to(device)
    if trainable:
        t = t.clone()
        if t.is_floating_point():
            t.requires_grad_(True)
    return t


class Trainer:
    """forward(params, inputs, generator)->logits + an optimizer spec -> epochs.

    ``train_data`` / ``val_data`` are callables returning an iterable of
    batch dicts ({"input": ..., "label": ...}) per epoch: any host loader
    plugs in. ``device=None`` means the card
    (:func:`core.device.default_device`).
    """

    def __init__(
        self,
        forward: Callable,
        optimizer: OptimizerSpec,
        params: Dict[str, Any],
        cfg: TrainerConfig = TrainerConfig(),
        loss_fn=step_lib.cross_entropy_loss,
        frozen_keys=step_lib.FROZEN_KEYS,
        val_metric: Optional[Callable] = None,
        device: _device.Device = None,
    ):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.logger = setup_logger()
        trainable, frozen = step_lib.split_params(params, frozen_keys)
        self.trainable = _to_device_tree(trainable, self.device, trainable=True)
        self.frozen = _to_device_tree(frozen, self.device, trainable=False)
        self.optimizer = optimizer.init(self.trainable)
        self.forward = forward
        self._step = step_lib.make_train_step(
            forward, self.optimizer, loss_fn, accum_steps=cfg.accum_steps
        )
        self.ema_params = ema_lib.init(self.trainable) if cfg.use_ema else None
        self.val_metric = val_metric
        self.early = (
            ckpt_lib.EarlyStopping(cfg.early_stop_patience, mode=cfg.best_mode)
            if cfg.early_stop_patience
            else None
        )
        self.epoch = 0
        self.global_step = 0
        self._async_ckpt = ckpt_lib.AsyncCheckpointer() if cfg.async_ckpt else None
        self._preempt: Optional[ckpt_lib.GracefulPreemption] = None

    @property
    def params(self) -> Dict[str, Any]:
        return step_lib.merge_params(self.trainable, self.frozen)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return batch_to_device(batch, self.device)

    def train_epoch(
        self, batches: Iterable[Dict[str, Any]], generator: Optional[torch.Generator] = None
    ):
        losses, accs, n = [], [], 0
        t0 = time.perf_counter()
        for batch in batches:
            if self._preempt is not None and self._preempt.triggered:
                break  # step boundary: params/optimizer state are consistent
            metrics = self._step(
                self.trainable, self.frozen, self._to_device(batch), generator
            )
            if self.cfg.use_ema:
                ema_lib.update(self.ema_params, self.trainable, self.cfg.ema_decay)
            self.global_step += 1
            n += 1
            if n % self.cfg.log_every == 0:  # the only host read inside the loop
                self.logger.info(
                    "epoch %d step %d loss %.4f acc %.4f",
                    self.epoch, n, float(metrics["loss"]), float(metrics["acc"]),
                )
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
        mean = lambda xs: float(torch.stack(xs).float().mean()) if xs else 0.0
        stats = {"loss": mean(losses), "acc": mean(accs), "steps": n}
        stats["time_s"] = time.perf_counter() - t0  # after the reads above: device done
        return stats

    @torch.no_grad()
    def validate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        correct, total, preds, labels = 0, 0, [], []
        tr = self.ema_params if self.cfg.use_ema else self.trainable
        params = step_lib.merge_params(tr, self.frozen)
        for batch in batches:
            x = batch_to_device(batch["input"], self.device)
            p = self.forward(params, x, None).float().cpu().numpy()
            y = np.asarray(
                batch["label"].cpu() if isinstance(batch["label"], torch.Tensor)
                else batch["label"]
            )
            preds.append(p)
            labels.append(y)
            correct += int((p.argmax(-1) == y).sum())
            total += len(y)
        out = {"acc": correct / max(total, 1)}
        if self.val_metric is not None:
            out.update(self.val_metric(np.concatenate(preds), np.concatenate(labels)))
        return out

    def fit(
        self,
        train_data: Callable[[], Iterable],
        val_data: Optional[Callable[[], Iterable]] = None,
        generator: Optional[torch.Generator] = None,
        resume: bool = False,
    ) -> Dict[str, float]:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if resume and self.cfg.ckpt_dir:
            resumed = ckpt_lib.auto_resume(self.cfg.ckpt_dir, self.device)
            if resumed:
                self._load_state(*resumed)

        best_val = None
        log: Dict[str, float] = {}
        cm = ckpt_lib.GracefulPreemption() if self.cfg.handle_preemption else None
        if cm is not None:
            self._preempt = cm.__enter__()
        try:
            log = self._fit_loop(train_data, val_data, generator, best_val, log)
        finally:
            if cm is not None:
                cm.__exit__(None, None, None)
                self._preempt = None
            if self._async_ckpt is not None:
                self._async_ckpt.wait()
        return log

    def _load_state(self, state: Dict[str, Any], epoch: int) -> None:
        """Full resume: parameters, optimizer moments, EMA, global step
        (pcdet checkpoint_state / openpoints resume_checkpoint parity)."""

        def copy_into(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    copy_into(dst[k], src[k])
            else:
                with torch.no_grad():
                    dst.copy_(src)

        copy_into(self.trainable, state["trainable"])
        if "opt_state" in state:
            self.optimizer.load_state_leaves(state["opt_state"])
        if self.cfg.use_ema and "ema" in state:
            copy_into(self.ema_params, state["ema"])
        if "global_step" in state:
            self.global_step = int(state["global_step"])
        self.epoch = epoch + 1
        self.logger.info("resumed from epoch %d", epoch)

    def _ckpt_state(self) -> Dict[str, Any]:
        state = {
            "trainable": self.trainable,
            "opt_state": self.optimizer.state_leaves(),
            "global_step": np.int64(self.global_step),
        }
        if self.cfg.use_ema:
            state["ema"] = self.ema_params
        return state

    def _save_epoch(self, epoch: int, is_best: bool) -> None:
        saver = self._async_ckpt if self._async_ckpt is not None else ckpt_lib
        saver.save_rotating(
            self.cfg.ckpt_dir, self._ckpt_state(), epoch,
            is_best=is_best, max_keep=self.cfg.max_keep,
        )

    def _fit_loop(self, train_data, val_data, generator, best_val, log):
        for epoch in range(self.epoch, self.cfg.epochs):
            self.epoch = epoch
            train_stats = self.train_epoch(train_data(), generator)
            if self._preempt is not None and self._preempt.triggered:
                # mid-epoch state goes to a dedicated ckpt_preempt.npz
                # (always, including epoch 0) so the clean end-of-epoch
                # rotation files are never overwritten; auto_resume
                # restarts the interrupted epoch with optimizer moments
                # and step counter intact
                self.logger.info(
                    "preempted during epoch %d: saving resumable state", epoch
                )
                if self.cfg.ckpt_dir:
                    if self._async_ckpt is not None:
                        self._async_ckpt.wait()
                    ckpt_lib.save_preempt(
                        self.cfg.ckpt_dir, self._ckpt_state(), resume_epoch=epoch
                    )
                break
            log = dict(train_stats)
            is_best = False
            if val_data is not None and (epoch + 1) % self.cfg.val_freq == 0:
                val_stats = self.validate(val_data())
                log.update({f"val_{k}": v for k, v in val_stats.items()})
                key = "val_acc" if "val_acc" in log else "val_loss"
                value = log[key]
                if self.early is not None:
                    is_best = self.early(value)
                    if self.early.should_stop:
                        self.logger.info("early stopping at epoch %d", epoch)
                        break
                else:
                    better = best_val is None or (
                        value > best_val
                        if self.cfg.best_mode == "max"
                        else value < best_val
                    )
                    if better:
                        best_val, is_best = value, True
            self.logger.info("epoch %d: %s", epoch, log)
            if self.cfg.ckpt_dir:
                self._save_epoch(epoch, is_best)
        return log

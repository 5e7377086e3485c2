"""Logging + experiment dirs: openpoints-style rank-aware logger and
time+host-tagged experiment directory generator
(``openpoints/utils/logger.py:36,104,140``); W&B/TensorBoard writers are
optional shims (both are opt-in in the reference too).

The port's own copy of ``metatransformer_tpu/utils/logger.py``."""

from __future__ import annotations

import logging
import os
import socket
import sys
import time
from typing import Optional


def setup_logger(
    name: str = "metatransformer_tpu_torch",
    log_file: Optional[str] = None,
    rank: int = 0,
    level: int = logging.INFO,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level if rank == 0 else logging.WARNING)
    fmt = logging.Formatter(
        f"[%(asctime)s %(levelname)s r{rank}] %(message)s", "%H:%M:%S"
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and rank == 0:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def generate_exp_directory(root: str, exp_name: str, tags=()) -> str:
    """<root>/<exp_name>/<tags>-<time>-<host> (logger.py:104 semantics)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    host = socket.gethostname().split(".")[0]
    leaf = "-".join([*tags, stamp, host]) if tags else f"{stamp}-{host}"
    path = os.path.join(root, exp_name, leaf)
    os.makedirs(path, exist_ok=True)
    for sub in ("checkpoint", "log"):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    return path


class Wandb:
    """Opt-in W&B shim: no-ops unless wandb is importable AND enabled."""

    def __init__(self, enabled: bool = False, **init_kw):
        self.run = None
        if enabled:
            try:
                import wandb

                self.run = wandb.init(**init_kw)
            except Exception:
                self.run = None

    def log(self, metrics: dict, step: Optional[int] = None):
        if self.run is not None:
            self.run.log(metrics, step=step)


class Tensorboard:
    """Opt-in TB shim over ``torch.utils.tensorboard``; a no-op where the
    tensorboard package is missing."""

    def __init__(self, log_dir: Optional[str] = None):
        self.writer = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except Exception:
                self.writer = None

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

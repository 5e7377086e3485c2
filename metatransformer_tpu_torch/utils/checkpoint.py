"""Checkpoint save / resume / best tracking.

Port of ``metatransformer_tpu/utils/checkpoint.py``: one npz-based store of
flattened trees with max-keep rotation, best / latest copies, auto-resume
from the newest loadable file, async writes, a pre-emption flag, weight
averaging and early stopping. The ``.npz`` layout (``a/b/0`` key paths) is
the reference's, so a checkpoint written by either package loads in the
other. Tensors are written as numpy arrays (bf16 leaves widen exactly to
fp32); :func:`load` returns tensors on ``device`` (None: the card).

The reference's orbax pair (``save_orbax`` / ``load_orbax``) has no
counterpart: ``orbax.checkpoint`` imports JAX, which this package never
does (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import glob
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core.tree import leaves_with_path, tree_map


def _leaf_to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {"/".join(map(str, path)): _leaf_to_numpy(leaf)
            for path, leaf in leaves_with_path(tree)}


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _host_snapshot(state: Any) -> Any:
    """The tree with every tensor copied to host numpy (a consistent
    snapshot: later in-place updates of the tensors do not reach it)."""
    return tree_map(lambda leaf: np.array(_leaf_to_numpy(leaf)), state)


def save(path: str, state: Dict[str, Any]) -> None:
    """state: arbitrary tree dict (params / opt_state / epoch / ema).

    Atomic: writes to a temp file in the same directory then
    ``os.replace``s into place, so a kill mid-write (pre-emption, the
    AsyncCheckpointer daemon thread dying with the process) can never
    leave a truncated npz at the final path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(state))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str, device: _device.Device = None) -> Dict[str, Any]:
    device = _device.resolve(device)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: torch.tensor(data[k], device=device) for k in data.files}
    return _unflatten(flat)


def save_rotating(
    ckpt_dir: str,
    state: Dict[str, Any],
    epoch: int,
    is_best: bool = False,
    max_keep: int = 5,
) -> str:
    """Epoch checkpoint with max-keep rotation + best/latest copies
    (pcdet train_utils.py:134-164 + openpoints ckpt_util semantics)."""
    path = os.path.join(ckpt_dir, f"ckpt_epoch_{epoch:04d}.npz")
    state = dict(state, epoch=np.int64(epoch))
    save(path, state)
    save(os.path.join(ckpt_dir, "ckpt_latest.npz"), state)
    if is_best:
        save(os.path.join(ckpt_dir, "ckpt_best.npz"), state)
    kept = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_epoch_*.npz")))
    for old in kept[:-max_keep]:
        os.remove(old)
    return path


class AsyncCheckpointer:
    """Non-blocking checkpoint writes.

    The device->host snapshot happens synchronously: the optimizer updates
    the parameters in place, so the copy cannot be deferred past the next
    step. Serialization + disk IO (the bulk of the save cost for npz) run
    in a background thread, overlapping the next train epoch. One save in
    flight at a time; errors surface on the next call or ``wait()``.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save_rotating(self, ckpt_dir: str, state, epoch: int,
                      is_best: bool = False, max_keep: int = 5) -> None:
        self.wait()
        host_state = _host_snapshot(state)  # consistent snapshot, sync

        def work():
            try:
                save_rotating(ckpt_dir, host_state, epoch,
                              is_best=is_best, max_keep=max_keep)
            except BaseException as exc:  # re-raised on wait()
                self._exc = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


class GracefulPreemption:
    """SIGTERM/SIGINT -> a flag the trainer polls at step boundaries.

    Pattern: install as a context manager around the train loop, poll
    ``triggered`` each step, save a resumable checkpoint and exit cleanly;
    ``auto_resume`` picks it up on restart. Handlers are restored on exit;
    a second signal falls through to the previous handler (double-Ctrl-C
    still kills).
    """

    def __init__(self, signals=None):
        import signal as _signal

        self._signal = _signal
        self.signals = tuple(signals) if signals else (
            _signal.SIGTERM, _signal.SIGINT,
        )
        self.triggered = False
        self._prev: Dict[int, Any] = {}

    def _handler(self, signum, frame):
        if self.triggered:  # second signal: defer to the original handler
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                raise KeyboardInterrupt
        self.triggered = True

    def __enter__(self) -> "GracefulPreemption":
        for s in self.signals:
            self._prev[s] = self._signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            self._signal.signal(s, prev)
        self._prev.clear()


def average_checkpoints(paths, device: _device.Device = None) -> Dict[str, Any]:
    """Uniform parameter average over saved checkpoints (the AST weight-
    averaging eval and fairseq's average_checkpoints). Float leaves are
    averaged; integer leaves (epoch counters, step ids) are taken from the
    LAST checkpoint."""
    paths = list(paths)
    if not paths:
        raise ValueError("average_checkpoints needs at least one path")
    states = [load(p, device) for p in paths]

    def avg(*leaves):
        if not leaves[0].is_floating_point():
            return leaves[-1]
        return torch.stack(leaves).mean(dim=0)

    return tree_map(avg, *states)


def average_epoch_range(
    ckpt_dir: str, start: int, end: int, device: _device.Device = None
) -> Dict[str, Any]:
    """Average ckpt_epoch_{start..end} (inclusive) from a rotation dir."""
    paths = [
        os.path.join(ckpt_dir, f"ckpt_epoch_{e:04d}.npz")
        for e in range(start, end + 1)
    ]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        raise FileNotFoundError(
            f"no ckpt_epoch_*.npz in [{start}, {end}] under {ckpt_dir}"
        )
    return average_checkpoints(paths, device)


def save_preempt(ckpt_dir: str, state: Dict[str, Any], resume_epoch: int) -> str:
    """Mid-epoch pre-emption checkpoint under a dedicated name.

    Never overwrites the clean end-of-epoch rotation files. ``epoch`` is
    stored as ``resume_epoch - 1`` so ``auto_resume`` (which restarts at
    ``epoch + 1``) redoes the interrupted epoch; ``resume_epoch`` is also
    stored explicitly."""
    path = os.path.join(ckpt_dir, "ckpt_preempt.npz")
    state = dict(
        state,
        epoch=np.int64(resume_epoch - 1),
        resume_epoch=np.int64(resume_epoch),
    )
    save(path, state)
    return path


def auto_resume(
    ckpt_dir: str, device: _device.Device = None
) -> Optional[Tuple[Dict[str, Any], int]]:
    """Load the newest loadable checkpoint: (state, epoch) or None.

    Preference order: the newest (by mtime) of ckpt_preempt.npz /
    ckpt_latest.npz, then epoch checkpoints newest-first. A corrupt or
    truncated file falls through to the next candidate instead of
    crashing the restart."""
    device = _device.resolve(device)
    named = [
        os.path.join(ckpt_dir, "ckpt_preempt.npz"),
        os.path.join(ckpt_dir, "ckpt_latest.npz"),
    ]
    candidates = sorted(
        (p for p in named if os.path.exists(p)),
        key=os.path.getmtime,
        reverse=True,
    )
    candidates += sorted(
        glob.glob(os.path.join(ckpt_dir, "ckpt_epoch_*.npz")), reverse=True
    )
    for path in candidates:
        try:
            state = load(path, device)
        except Exception:  # truncated/corrupt: fall back to older ckpt
            continue
        return state, int(state.get("epoch", 0))
    return None


class EarlyStopping:
    """Time-Series ``utils/tools.py:27`` semantics: stop after `patience`
    validations without improvement; tracks best state."""

    def __init__(self, patience: int = 7, delta: float = 0.0, mode: str = "min"):
        self.patience = patience
        self.delta = delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, value: float) -> bool:
        """Returns True if this value is a new best."""
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.delta)
            or (self.mode == "max" and value > self.best + self.delta)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return improved

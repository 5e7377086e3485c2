"""Time-series / IMU tokenizer: value + positional + calendar embeddings.

Port of ``metatransformer_tpu/tokenizers/time_series.py``: the circular
Conv1d value embedding (k=3, no bias) as an unfold (roll left / right,
concat) and one [B, L, 3C] x [3C, D] matmul, the sinusoidal positional
table, the calendar embedding (fixed-sinusoid or learned tables, or the
linear "timeF" features), and the PatchTST patch embedding. IMU windows
use the same tokenizer with ``c_in = 6``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device

# Calendar vocabulary sizes (month, day, weekday, hour, minute-of-quarter).
MINUTE_SIZE, HOUR_SIZE, WEEKDAY_SIZE, DAY_SIZE, MONTH_SIZE = 4, 24, 7, 32, 13
# timeF input feature count per sampling freq.
FREQ_MAP = {"h": 4, "t": 5, "s": 6, "m": 1, "a": 1, "w": 2, "d": 3, "b": 3}


@dataclasses.dataclass(frozen=True)
class TimeSeriesConfig:
    c_in: int = 1
    dim: int = 768
    embed_type: str = "fixed"  # "fixed" | "learned" | "timeF"
    freq: str = "h"
    use_pos: bool = True  # False = DataEmbedding_wo_pos


def sinusoid_table(n: int, d: int) -> np.ndarray:
    """The transformer sin/cos table of the positional and fixed calendar
    embeddings (even dims sin, odd dims cos), fp32 math as the reference's."""
    pe = np.zeros((n, d), np.float32)
    position = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@functools.lru_cache(maxsize=16)
def _sinusoid_cached(n: int, d: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sinusoid_table(n, d))[None].to(device)


def positional_embed(dim: int, length: int, device) -> torch.Tensor:
    """[1, length, dim] sinusoid table on ``device``, built once per (dim,
    length, device) and kept. Callers must not write to it."""
    return _sinusoid_cached(length, dim, torch.device(device))


def init(
    cfg: TimeSeriesConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """Kaiming-normal value weights (fan_in 3C) drawn on the CPU; fixed
    sinusoid or N(0, 0.02) calendar tables, or N(0, d_inp**-1) timeF."""
    device = _device.resolve(device)
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    params: Dict[str, torch.Tensor] = {
        "value_w": randn(3 * cfg.c_in, cfg.dim) * math.sqrt(2.0 / (3 * cfg.c_in)),
    }
    if cfg.embed_type == "timeF":
        d_inp = FREQ_MAP[cfg.freq]
        params["timef_w"] = randn(d_inp, cfg.dim) * d_inp**-0.5
    else:
        sizes = {"month": MONTH_SIZE, "day": DAY_SIZE, "weekday": WEEKDAY_SIZE,
                 "hour": HOUR_SIZE}
        if cfg.freq == "t":
            sizes["minute"] = MINUTE_SIZE
        for name, size in sizes.items():
            if cfg.embed_type == "fixed":
                params[f"{name}_emb"] = torch.from_numpy(sinusoid_table(size, cfg.dim))
            else:
                params[f"{name}_emb"] = randn(size, cfg.dim) * 0.02
    return {k: v.to(device) for k, v in params.items()}


def value_embed(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Circular-conv1d(k=3) value embedding as unfold + matmul.

    x: [B, L, C] -> [B, L, D]. Window t sees (x[t-1 mod L], x[t],
    x[t+1 mod L]), in (k, c) order.
    """
    windows = torch.cat([x.roll(1, dims=1), x, x.roll(-1, dims=1)], dim=-1)
    return windows @ params["value_w"]


def temporal_embed(
    params: Dict[str, torch.Tensor], x_mark: torch.Tensor, cfg: TimeSeriesConfig
) -> torch.Tensor:
    """Calendar marks -> [B, L, D].

    Fixed / learned: int marks [B, L, >=4], columns (month, day, weekday,
    hour[, minute]). timeF: float features.
    """
    if cfg.embed_type == "timeF":
        return x_mark.float() @ params["timef_w"]
    marks = x_mark.long()
    out = (
        params["month_emb"][marks[..., 0]]
        + params["day_emb"][marks[..., 1]]
        + params["weekday_emb"][marks[..., 2]]
        + params["hour_emb"][marks[..., 3]]
    )
    if cfg.freq == "t":
        out = out + params["minute_emb"][marks[..., 4]]
    return out


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: TimeSeriesConfig,
    x_mark: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DataEmbedding / DataEmbedding_wo_pos forward. x: [B, L, C] -> [B, L, D]."""
    out = value_embed(params, x.float())
    if x_mark is not None:
        out = out + temporal_embed(params, x_mark, cfg)
    if cfg.use_pos:
        out = out + positional_embed(cfg.dim, x.shape[1], out.device).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# PatchTST-style patch embedding


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    dim: int
    patch_len: int
    stride: int
    padding: int  # replication-pad amount at sequence end


def patch_init(
    cfg: PatchConfig, generator: torch.Generator, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    device = _device.resolve(device)
    w = torch.randn(cfg.patch_len, cfg.dim, generator=generator) * cfg.patch_len**-0.5
    return {"w": w.to(device)}


def patch_apply(
    params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: PatchConfig
) -> Tuple[torch.Tensor, int]:
    """x: [B, n_vars, L] -> ([B*n_vars, n_patches, D], n_vars)."""
    b, n_vars, _ = x.shape
    xp = torch.cat([x, x[..., -1:].expand(b, n_vars, cfg.padding)], dim=-1)  # replication pad
    patches = xp.unfold(-1, cfg.patch_len, cfg.stride)  # [B, n_vars, n_patches, patch_len]
    n_patches = patches.shape[2]
    out = patches.reshape(b * n_vars, n_patches, cfg.patch_len) @ params["w"]
    return out + positional_embed(cfg.dim, n_patches, out.device).to(out.dtype), n_vars


def convert_torch_conv1d(
    weight: np.ndarray, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """torch circular Conv1d weight [D, C, 3] -> our [3C, D] unfold weight."""
    device = _device.resolve(device)
    d = weight.shape[0]
    w = np.transpose(np.asarray(weight, np.float32), (2, 1, 0)).reshape(-1, d)
    return {"value_w": torch.tensor(w, device=device)}

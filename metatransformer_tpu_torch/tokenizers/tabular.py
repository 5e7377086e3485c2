"""Tabular tokenizer: per-column categorical embeddings (TabTransformer).

Port of ``metatransformer_tpu/tokenizers/tabular.py``: one embedding vector
per (column, category) pair, all columns in one flat table indexed with
per-column offsets, so a row of categories is a single gather. Continuous
columns are normalized and bypass the encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class TabularTokenizerConfig:
    vocab_sizes: Tuple[int, ...] = ()  # categories per column
    n_continuous: int = 0
    dim: int = 768

    def __post_init__(self):
        object.__setattr__(self, "vocab_sizes", tuple(self.vocab_sizes))

    @property
    def n_categorical(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int32)


def init(
    cfg: TabularTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """N(0, 0.02) table drawn on the CPU."""
    device = _device.resolve(device)
    embed = torch.randn(cfg.total_vocab, cfg.dim, generator=generator) * 0.02
    return {"embed": embed.to(device)}


def apply(
    params: Dict[str, torch.Tensor],
    categorical: torch.Tensor,  # int [B, n_categorical]
    cfg: TabularTokenizerConfig,
) -> torch.Tensor:
    """[B, n_cat] category ids -> [B, n_cat, D] tokens."""
    offsets = torch.from_numpy(cfg.offsets).to(categorical.device)
    return params["embed"][categorical.long() + offsets]


def normalize_continuous(
    continuous: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
) -> torch.Tensor:
    return (continuous - mean) / torch.clamp_min(std, 1e-6)

"""Hyper-spectral tokenizer: linear band-patch embedding.

Port of ``metatransformer_tpu/tokenizers/hyper.py``: a linear embedding of
flattened (patch^2 x near_band) spectral neighbourhoods, a cls token
prepended and the positional table's first n + 1 rows added (the intent of
the reference's broken forward, as the JAX package implements it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class HyperTokenizerConfig:
    img_size: int = 224  # spatial patch side, reference default
    near_band: int = 1
    num_tokens: int = 16  # = reference patch_size (pos table is [p+1, D])
    dim: int = 768

    @property
    def patch_dim(self) -> int:
        return self.img_size * self.img_size * self.near_band


def init(
    cfg: HyperTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """Normal(0, patch_dim**-0.5) weights, zero bias, N(0, 1) positions,
    drawn on the CPU."""
    device = _device.resolve(device)
    w = torch.randn(cfg.patch_dim, cfg.dim, generator=generator) * cfg.patch_dim**-0.5
    pos = torch.randn(1, cfg.num_tokens + 1, cfg.dim, generator=generator)
    return {
        "w": w.to(device),
        "b": torch.zeros(cfg.dim, dtype=torch.float32, device=device),
        "pos_embed": pos.to(device),
    }


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: HyperTokenizerConfig,
    cls_token: torch.Tensor,
) -> torch.Tensor:
    """x: [B, n, patch_dim] band patches -> [B, n+1, D] with cls + pos."""
    tokens = x.float() @ params["w"] + params["b"]
    b, n, _ = tokens.shape
    cls = cls_token.to(tokens.dtype).expand(b, 1, cfg.dim)
    tokens = torch.cat([cls, tokens], dim=1)
    return tokens + params["pos_embed"][:, : n + 1].to(tokens.dtype)

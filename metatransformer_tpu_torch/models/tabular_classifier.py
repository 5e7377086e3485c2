"""Tabular classifier (TabTransformer-on-Meta-Transformer).

Port of ``metatransformer_tpu/models/tabular_classifier.py``: categorical
tokens -> frozen encoder -> flatten -> concat normalized continuous
columns -> MLP head (no LayerNorm).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.tokenizers import tabular as tab_tok


@dataclasses.dataclass(frozen=True)
class TabularClassifierConfig:
    tokenizer: tab_tok.TabularTokenizerConfig = tab_tok.TabularTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 2
    head_mlps: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "head_mlps", tuple(self.head_mlps))

    @property
    def head(self) -> cls_head.ClsHeadConfig:
        in_dim = self.tokenizer.n_categorical * self.encoder.dim + self.tokenizer.n_continuous
        return cls_head.ClsHeadConfig(
            in_dim=in_dim, num_classes=self.num_classes, mlps=self.head_mlps, use_norm=False)


def init(
    cfg: TabularClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    n_cont = cfg.tokenizer.n_continuous
    return {
        "tokenizer": tab_tok.init(cfg.tokenizer, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
        "head": cls_head.init(cfg.head, generator, device),
        "cont_mean": torch.zeros(n_cont, device=device),
        "cont_std": torch.ones(n_cont, device=device),
    }


def forward(
    params: Dict[str, Any],
    categorical: torch.Tensor,  # int [B, n_cat]
    cfg: TabularClassifierConfig,
    continuous: Optional[torch.Tensor] = None,  # [B, n_cont]
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    tokens = tab_tok.apply(params["tokenizer"], categorical, cfg.tokenizer)
    h = enc.encode(params["encoder"], tokens, cfg.encoder, precision=precision)
    feats = h.reshape(h.shape[0], -1)
    if cfg.tokenizer.n_continuous:
        cont = tab_tok.normalize_continuous(continuous, params["cont_mean"], params["cont_std"])
        feats = torch.cat([feats, cont.to(feats.dtype)], dim=-1)
    return cls_head.apply(params["head"], feats, cfg.head)

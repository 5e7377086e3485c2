"""Generic Meta-Transformer sequence classifier.

Port of ``metatransformer_tpu/models/classifier.py``: tokenize, prepend
[cls] (+[dist]), add the positional embedding, run the encoder, final
LayerNorm, pool, head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head

TokenizeFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    encoder: enc.EncoderConfig
    head: cls_head.ClsHeadConfig
    seq_len: int  # token count from the tokenizer (pre-cls)
    num_prefix_tokens: int = 1  # cls (+dist) tokens; 0 = none
    pos_embed: str = "learned"  # "learned" | "none"
    pos_each_block: bool = False
    pool: str = "cls"  # "cls" | "mean" | "cls_dist_avg" | "cls,max" | "cls,max,avg"
    final_norm: bool = True  # LayerNorm after the encoder stack
    ln_eps: float = 1e-6


def init_wrapper(
    cfg: ClassifierConfig,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> Dict[str, Any]:
    """Init everything except tokenizer + encoder (owned by their modules)."""
    t = cfg.seq_len + cfg.num_prefix_tokens
    d = cfg.encoder.dim
    params: Dict[str, Any] = {}
    if cfg.num_prefix_tokens:
        prefix = torch.randn(1, cfg.num_prefix_tokens, d, generator=generator) * 0.02
        params["prefix_tokens"] = prefix.to(device)
    if cfg.pos_embed == "learned":
        params["pos_embed"] = (torch.randn(1, t, d, generator=generator) * 0.02).to(device)
    if cfg.final_norm:
        params["norm_scale"] = torch.ones(d, device=device)
        params["norm_bias"] = torch.zeros(d, device=device)
    params["head"] = cls_head.init(cfg.head, generator, device)
    return params


def pool(x: torch.Tensor, cfg: ClassifierConfig) -> torch.Tensor:
    """[B, T, D] encoded sequence -> [B, F] pooled features."""
    body = x[:, cfg.num_prefix_tokens :, :]
    feats = []
    for kind in cfg.pool.split(","):
        if kind == "cls":
            feats.append(x[:, 0, :])
        elif kind == "cls_dist_avg":
            feats.append((x[:, 0, :] + x[:, 1, :]) / 2.0)
        elif kind in ("mean", "avg"):
            feats.append(body.mean(dim=1))
        elif kind == "max":
            feats.append(body.amax(dim=1))
        else:
            raise ValueError(f"unknown pool kind {kind!r}")
    return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]


def forward(
    params: Dict[str, Any],
    raw: torch.Tensor,
    cfg: ClassifierConfig,
    tokenize: TokenizeFn,
    precision: enc.Precision = enc.FP32,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    pos_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Raw modality input -> logits.

    ``params`` must hold keys: "tokenizer", "encoder", plus the wrapper
    params from :func:`init_wrapper`. ``pos_override`` lets data-dependent
    positional embeddings replace the learned table.
    """
    tokens = tokenize(params["tokenizer"], raw)
    b = tokens.shape[0]
    if cfg.num_prefix_tokens:
        prefix = params["prefix_tokens"].to(tokens.dtype).expand(
            b, cfg.num_prefix_tokens, cfg.encoder.dim
        )
        tokens = torch.cat([prefix, tokens], dim=1)

    pos = pos_override
    if pos is None and cfg.pos_embed == "learned":
        pos = params["pos_embed"]

    x = enc.encode(
        params["encoder"],
        tokens,
        cfg.encoder,
        pos=pos,
        pos_each_block=cfg.pos_each_block,
        precision=precision,
    )
    if cfg.final_norm:
        x = enc.layer_norm(x, params["norm_scale"], params["norm_bias"], cfg.ln_eps)
    feats = pool(x, cfg)
    return cls_head.apply(params["head"], feats, cfg.head, train=train, generator=generator)

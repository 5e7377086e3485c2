"""Hyper-spectral classifier, band patches -> logits.

Port of ``metatransformer_tpu/models/hyper_classifier.py``: linear
patch embedding + cls + positions, the frozen encoder, LN + Linear head on
the cls token. ``mode="caf"`` is SpectralFormer's cross-layer adaptive
fusion: before block i > 1 the stream is mixed with the input of block
i - 2 through a learned per-token [T, T, 2] weight (``skipcat_w``,
identity-initialised, so CAF equals ViT at init), and the blocks run one
by one through :func:`core.encoder.block`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.tokenizers import hyper as hyper_tok


@dataclasses.dataclass(frozen=True)
class HyperClassifierConfig:
    tokenizer: hyper_tok.HyperTokenizerConfig = hyper_tok.HyperTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 16  # Indian Pines
    ln_eps: float = 1e-6
    mode: str = "vit"  # "vit" (encoder loop) | "caf" (SpectralFormer CAF)

    @property
    def head(self) -> cls_head.ClsHeadConfig:
        return cls_head.ClsHeadConfig(in_dim=self.encoder.dim, num_classes=self.num_classes)


def init(
    cfg: HyperClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    params: Dict[str, Any] = {
        "tokenizer": hyper_tok.init(cfg.tokenizer, generator, device),
        "cls_token": torch.randn(1, 1, cfg.encoder.dim, generator=generator).to(device),
        "encoder": enc.init(cfg.encoder, generator, device),
        "head": cls_head.init(cfg.head, generator, device),
    }
    if cfg.mode == "caf":
        n_skip = max(cfg.encoder.depth - 2, 0)
        t = cfg.tokenizer.num_tokens + 1
        w = torch.zeros(n_skip, t, t, 2)
        w[..., 0] = torch.eye(t)  # identity mix at init
        params["skipcat_w"] = w.to(device)
        params["skipcat_b"] = torch.zeros(n_skip, t, device=device)
    return params


def _caf_encode(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: HyperClassifierConfig,
    precision: enc.Precision,
) -> torch.Tensor:
    """CAF stack: block i's input is fused with block (i-2)'s input stream,
    taken before its own fusion."""
    x = tokens.to(precision.compute_dtype)
    ecfg = cfg.encoder
    layers = {k: v.unbind(0) for k, v in enc.cast_params(params["encoder"], precision).items()}
    outs = []
    for i in range(ecfg.depth):
        outs.append(x)
        if i > 1:
            # the reference's einsum "uvk,bvdk->bud" over the stacked pair, as
            # one product over the 2T mixed tokens: [T, 2T] @ [B, 2T, D]
            w = params["skipcat_w"][i - 2].to(x.dtype)
            b = params["skipcat_b"][i - 2].to(x.dtype)
            mix = torch.cat([w[..., 0], w[..., 1]], dim=1)
            x = torch.matmul(mix, torch.cat([x, outs[i - 2]], dim=1)) + b[:, None]
        x = enc.block(x, {k: v[i] for k, v in layers.items()}, ecfg, None, precision)
    return x


def forward(
    params: Dict[str, Any],
    x: torch.Tensor,  # [B, n_tokens, patch_dim] band patches
    cfg: HyperClassifierConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    tokens = hyper_tok.apply(params["tokenizer"], x, cfg.tokenizer, params["cls_token"])
    if cfg.mode == "caf":
        h = _caf_encode(params, tokens, cfg, precision)
    else:
        h = enc.encode(params["encoder"], tokens, cfg.encoder, precision=precision)
    return cls_head.apply(params["head"], h[:, 0, :], cfg.head)

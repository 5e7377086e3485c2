"""MaskFormer-style query-based segmentation head (compact, single scale).

Port of ``metatransformer_tpu/heads/maskformer.py``: N learned object
queries attend the pixel features through a transformer decoder (the
time-series model's decoder layer, bidirectional); each query gives class
logits and a mask embedding whose dot product with the per-pixel
embeddings is its mask. Full fp32 precision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core.tree import tree_map
from metatransformer_tpu_torch.models.time_series import (
    DecoderConfig,
    _decoder_layer,
    _decoder_layer_shapes,
)


@dataclasses.dataclass(frozen=True)
class MaskFormerConfig:
    in_dim: int = 768
    num_queries: int = 100
    num_classes: int = 150  # +1 implicit "no object"
    decoder: DecoderConfig = DecoderConfig(dim=256, d_ff=1024, num_heads=8, depth=6)
    mask_dim: int = 256


def init(cfg: MaskFormerConfig, generator: torch.Generator,
         device: _device.Device = None) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU; None: the card)."""
    device = _device.resolve(device)
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    d = cfg.decoder.dim
    dec = {}
    for name, shape in _decoder_layer_shapes(cfg.decoder).items():
        full = (cfg.decoder.depth,) + shape
        if name.endswith("_w"):
            dec[name] = randn(*full) * shape[0] ** -0.5
        elif "scale" in name:
            dec[name] = torch.ones(full)
        else:
            dec[name] = torch.zeros(full)
    params = {
        "queries": randn(cfg.num_queries, d) * 0.02,
        "input_proj_w": randn(cfg.in_dim, d) * cfg.in_dim**-0.5,
        "input_proj_b": torch.zeros(d),
        "decoder": dec,
        "cls_w": randn(d, cfg.num_classes + 1) * d**-0.5,
        "cls_b": torch.zeros(cfg.num_classes + 1),
        "mask_embed_w": randn(d, cfg.mask_dim) * d**-0.5,
        "mask_embed_b": torch.zeros(cfg.mask_dim),
        "pixel_embed_w": randn(cfg.in_dim, cfg.mask_dim) * cfg.in_dim**-0.5,
        "pixel_embed_b": torch.zeros(cfg.mask_dim),
    }
    return tree_map(lambda t: t.to(device), params)


def apply(
    params: Dict[str, Any],
    pixel_features: torch.Tensor,  # [B, H, W, in_dim] (e.g. ViT-Adapter f2)
    cfg: MaskFormerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (class_logits [B, Q, num_classes+1], mask_logits [B, Q, H, W])."""
    b, h, w, _ = pixel_features.shape
    tokens = pixel_features.reshape(b, h * w, -1)
    mem = tokens @ params["input_proj_w"] + params["input_proj_b"]
    q = params["queries"][None].expand(b, -1, -1)
    layers = {k: v.unbind(0) for k, v in params["decoder"].items()}
    for i in range(cfg.decoder.depth):
        # object queries attend each other bidirectionally (not causal)
        q = _decoder_layer(q, mem, {k: v[i] for k, v in layers.items()}, cfg.decoder,
                           causal=False)
    cls_logits = q @ params["cls_w"] + params["cls_b"]
    mask_embed = q @ params["mask_embed_w"] + params["mask_embed_b"]
    pixel_embed = tokens @ params["pixel_embed_w"] + params["pixel_embed_b"]
    masks = torch.einsum("bqc,bpc->bqp", mask_embed, pixel_embed)
    return cls_logits, masks.reshape(b, cfg.num_queries, h, w)


def semantic_inference(cls_logits: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """Per-pixel semantic map: sum over queries of P(class | q) *
    sigmoid(mask_q) -> [B, H, W, num_classes]."""
    probs = torch.softmax(cls_logits, -1)[..., :-1]  # drop no-object
    return torch.einsum("bqc,bqhw->bhwc", probs, torch.sigmoid(mask_logits))

"""Semantic segmentation models on the ViT-Adapter backbone.

Port of ``metatransformer_tpu/models/segmentor.py``: the UperNet segmentor
(backbone pyramid -> decode head -> bilinear resize to the input ->
per-pixel CE with ignore label 255), multi-scale + flip test-time
augmentation, and the Mask2Former segmentor (per-layer class and mask
predictions; the last layer's semantic map at inference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import mask2former as m2f
from metatransformer_tpu_torch.heads import upernet
from metatransformer_tpu_torch.models import vit_adapter


@dataclasses.dataclass(frozen=True)
class SegmentorConfig:
    backbone: vit_adapter.ViTAdapterConfig = vit_adapter.ViTAdapterConfig()
    num_classes: int = 150

    @property
    def head(self) -> upernet.UperNetConfig:
        return upernet.UperNetConfig(in_dim=self.backbone.encoder.dim,
                                     num_classes=self.num_classes)


def init(cfg: SegmentorConfig, generator: torch.Generator,
         device: _device.Device = None) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU; None: the card)."""
    device = _device.resolve(device)
    return {
        "backbone": vit_adapter.init(cfg.backbone, generator, device),
        "head": upernet.init(cfg.head, generator, device),
    }


def forward(
    params: Dict[str, Any],
    images: torch.Tensor,  # [B, H, W, 3]
    cfg: SegmentorConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """-> per-pixel logits [B, H, W, num_classes]."""
    feats = vit_adapter.apply(params["backbone"], images, cfg.backbone, precision)
    logits4 = upernet.apply(params["head"], feats, cfg.head)
    return vit_adapter.resize(logits4, images.shape[1:3])


def seg_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel CE with an ignore label (the mmseg convention)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    c = logits.shape[-1]
    ce = F.cross_entropy(logits.reshape(-1, c).float(), safe.reshape(-1), reduction="none")
    return (ce * valid.reshape(-1)).sum() / valid.sum().clamp_min(1)


def tta_inference(
    params: Dict[str, Any],
    images: torch.Tensor,  # [B, H, W, 3]
    cfg: SegmentorConfig,
    scales=(0.75, 1.0, 1.25),
    flip: bool = True,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """Multi-scale + horizontal-flip test-time augmentation: each scale
    (snapped to a patch multiple) and its flip over W through
    :func:`forward`, logits resized back and un-flipped, softmax
    probabilities averaged -> [B, H, W, num_classes]."""
    h, w = images.shape[1:3]
    ps = cfg.backbone.patch_size
    probs, n = None, 0
    for s in scales:
        sh = max(ps, int(round(h * s / ps)) * ps)
        sw = max(ps, int(round(w * s / ps)) * ps)
        scaled = vit_adapter.resize(images, (sh, sw))
        variants = [scaled] + ([scaled.flip(2)] if flip else [])
        for vi, v in enumerate(variants):
            logits = forward(params, v, cfg, precision)
            if vi == 1:
                logits = logits.flip(2)
            p = torch.softmax(vit_adapter.resize(logits, (h, w)), -1)
            probs = p if probs is None else probs + p
            n += 1
    return probs / n


# ---------------------------------------------------------------------------
# Mask2Former segmentor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mask2FormerSegmentorConfig:
    backbone: vit_adapter.ViTAdapterConfig = vit_adapter.ViTAdapterConfig()
    num_classes: int = 150
    head_channels: int = 256
    num_queries: int = 100
    num_decoder_layers: int = 9
    num_encoder_layers: int = 6
    num_heads: int = 8

    @property
    def head(self) -> m2f.Mask2FormerConfig:
        d, c = self.backbone.encoder.dim, self.head_channels
        return m2f.Mask2FormerConfig(
            num_classes=self.num_classes,
            num_queries=self.num_queries,
            feat_channels=c,
            out_channels=c,
            num_decoder_layers=self.num_decoder_layers,
            num_heads=self.num_heads,
            ffn_dim=8 * c,
            pixel_decoder=m2f.PixelDecoderConfig(
                in_channels=(d, d, d, d), feat_channels=c, out_channels=c,
                num_encoder_layers=self.num_encoder_layers, num_heads=self.num_heads,
                ffn_dim=4 * c,
            ),
        )


def init_mask2former(cfg: Mask2FormerSegmentorConfig, generator: torch.Generator,
                     device: _device.Device = None) -> Dict[str, Any]:
    device = _device.resolve(device)
    return {
        "backbone": vit_adapter.init(cfg.backbone, generator, device),
        "head": m2f.init(cfg.head, generator, device),
    }


def forward_mask2former(
    params: Dict[str, Any],
    images: torch.Tensor,  # [B, H, W, 3]
    cfg: Mask2FormerSegmentorConfig,
    precision: enc.Precision = enc.FP32,
):
    """-> (all_cls [L+1, B, Q, C+1], all_masks [L+1, B, Q, H/4, W/4])."""
    feats = vit_adapter.apply(params["backbone"], images, cfg.backbone, precision)
    return m2f.apply(params["head"], feats, cfg.head, precision.mm)


def mask2former_semantic(all_cls, all_masks, out_hw) -> torch.Tensor:
    """The last layer's semantic map resized to ``out_hw`` -> [B, H, W, C]."""
    return vit_adapter.resize(m2f.semantic_inference(all_cls[-1], all_masks[-1]), out_hw)

"""DETR-style 2D detection head.

Port of ``metatransformer_tpu/heads/detr.py``: learned object queries
decode against the flattened feature map through the time-series family's
decoder layer (self-attention without a causal mask, cross-attention, FFN;
post-norm); each query emits class logits and a normalised (cx, cy, w, h)
box, matched to the ground truth by Hungarian matching over class, L1 and
GIoU costs (``ops/matching.py``). Every product runs in full fp32, the
reference's default ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.time_series import (
    DecoderConfig,
    _decoder_layer,
    _decoder_layer_shapes,
)
from metatransformer_tpu_torch.models.vit_adapter import _to


@dataclasses.dataclass(frozen=True)
class DETRHeadConfig:
    in_dim: int = 768
    num_queries: int = 100
    num_classes: int = 80  # COCO
    decoder: DecoderConfig = DecoderConfig(dim=256, d_ff=1024, num_heads=8, depth=6)


def init(cfg: DETRHeadConfig, generator: torch.Generator,
         device: _device.Device = None) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU; None: the card); the
    decoder's layers stacked on a leading depth axis."""
    device = _device.resolve(device)
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    d = cfg.decoder.dim
    dec = {}
    for name, shape in _decoder_layer_shapes(cfg.decoder).items():
        full = (cfg.decoder.depth,) + shape
        if name.endswith("_w"):
            dec[name] = randn(*full) * (shape[0] ** -0.5)
        elif "scale" in name:
            dec[name] = torch.ones(full)
        else:
            dec[name] = torch.zeros(full)
    return _to({
        "queries": randn(cfg.num_queries, d) * 0.02,
        "input_proj_w": randn(cfg.in_dim, d) * cfg.in_dim**-0.5,
        "input_proj_b": torch.zeros(d),
        "decoder": dec,
        "cls_w": randn(d, cfg.num_classes + 1) * d**-0.5,
        "cls_b": torch.zeros(cfg.num_classes + 1),
        "box_w0": randn(d, d) * d**-0.5,
        "box_b0": torch.zeros(d),
        "box_w1": randn(d, 4) * d**-0.5,
        "box_b1": torch.zeros(4),
    }, device)


def apply(params: Dict[str, Any], features: torch.Tensor,
          cfg: DETRHeadConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """features [B, H, W, in_dim] -> (class_logits [B, Q, C+1], boxes
    [B, Q, 4] as sigmoid cxcywh)."""
    b, h, w, _ = features.shape
    mem = features.reshape(b, h * w, -1) @ params["input_proj_w"] + params["input_proj_b"]
    q = params["queries"][None].expand(b, cfg.num_queries, cfg.decoder.dim)
    for j in range(cfg.decoder.depth):
        q = _decoder_layer(q, mem, {k: v[j] for k, v in params["decoder"].items()},
                           cfg.decoder, causal=False)
    cls_logits = q @ params["cls_w"] + params["cls_b"]
    hbox = torch.relu(q @ params["box_w0"] + params["box_b0"])
    return cls_logits, torch.sigmoid(hbox @ params["box_w1"] + params["box_b1"])


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def generalized_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """GIoU [N, M] of xyxy boxes (the GIoU match cost and loss)."""
    a = boxes_a[:, None]
    b = boxes_b[None, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    iou = inter / union.clamp_min(1e-8)
    # the smallest enclosing box
    lt_c = torch.minimum(a[..., :2], b[..., :2])
    rb_c = torch.maximum(a[..., 2:], b[..., 2:])
    wh_c = (rb_c - lt_c).clamp_min(0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c.clamp_min(1e-8)

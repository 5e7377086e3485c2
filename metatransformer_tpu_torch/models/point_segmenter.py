"""Point-cloud semantic segmentation (the S3DIS / ShapeNetPart path).

Port of ``metatransformer_tpu/models/point_segmenter.py``: encode the group
tokens as the point classifier does, carry the token features back to every
input point with 3-NN inverse-distance interpolation
(:mod:`metatransformer_tpu_torch.ops.point_interp`), concat the raw xyz,
per-point MLP head -> per-point class logits.

At the recipe's 2048 points a cloud is 512 groups, T = 513: over the fused
sublayers' gate, so the encoder's attention runs the flash kernel. The
interpolation and the head are fp32 under both policies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models import point_classifier
from metatransformer_tpu_torch.models.image_classifier import ImageClassifier
from metatransformer_tpu_torch.ops import point_interp
from metatransformer_tpu_torch.tokenizers import point as point_tok


@dataclasses.dataclass(frozen=True)
class PointSegmenterConfig:
    tokenizer: point_tok.PointTokenizerConfig = point_tok.PointTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 13  # S3DIS
    head_hidden: int = 256
    ln_eps: float = 1e-6


def init(
    cfg: PointSegmenterConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    params = point_classifier.init_backbone(cfg.tokenizer, cfg.encoder, generator, device)
    head_in = cfg.encoder.dim + 3  # interpolated token features + raw xyz
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    params.update({
        "head_w0": (randn(head_in, cfg.head_hidden) * head_in**-0.5).to(device),
        "head_b0": zeros(cfg.head_hidden),
        "head_w1": (randn(cfg.head_hidden, cfg.num_classes) * cfg.head_hidden**-0.5).to(device),
        "head_b1": zeros(cfg.num_classes),
    })
    return params


def forward(
    params: Dict[str, Any],
    points: torch.Tensor,  # [B, N, 3]
    cfg: PointSegmenterConfig,
    features: Optional[torch.Tensor] = None,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """-> per-point logits [B, N, num_classes] (fp32)."""
    center_p, x = point_classifier.encode_groups(
        params, points, cfg.tokenizer, cfg.encoder, cfg.ln_eps, features, precision
    )
    token_feats = x[:, 1:, :]  # drop cls
    # propagate group features back to every input point (3-NN interp)
    per_point = point_interp.three_interpolation(points, center_p, token_feats)
    h = torch.cat([per_point, points.to(per_point.dtype)], dim=-1)
    h = torch.relu(h @ params["head_w0"] + params["head_b0"])
    return h @ params["head_w1"] + params["head_b1"]


class PointSegmenter(ImageClassifier):
    """Serving wrapper, constructed like :class:`ImageClassifier` from a
    :class:`PointSegmenterConfig` and its parameters.
    [B, N, 3] float clouds -> [B, N, num_classes] per-point logits."""

    @torch.no_grad()
    def forward(
        self, points: torch.Tensor, features: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return forward(self.params(), points, self.cfg, features, self.precision)

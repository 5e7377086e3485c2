"""Video classifier (VideoMAE-V2-on-Meta-Transformer), clip -> logits.

Port of ``metatransformer_tpu/models/video_classifier.py``: tubelet embed,
sinusoidal or learned positional embedding, joint space-time attention
blocks, mean pool over tokens + ``fc_norm``, linear head. At the VideoMAE
geometry a clip is 1568 tokens, which the encoder sends through
:mod:`metatransformer_tpu_torch.ops.flash_attention`.

:class:`VideoClassifier` is the serving wrapper: it holds the parameters on
one device, already cast for its precision policy, and maps a batch of
clips to logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.models.image_classifier import ImageClassifier
from metatransformer_tpu_torch.tokenizers import video as video_tok


@dataclasses.dataclass(frozen=True)
class VideoClassifierConfig:
    tokenizer: video_tok.VideoTokenizerConfig = video_tok.VideoTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 400  # Kinetics-400
    pos_embed: str = "sincos"  # "sincos" | "learned"
    ln_eps: float = 1e-6

    @property
    def head(self) -> cls_head.ClsHeadConfig:
        return cls_head.ClsHeadConfig(
            in_dim=self.encoder.dim, num_classes=self.num_classes
        )


def init(
    cfg: VideoClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    d = cfg.encoder.dim
    params: Dict[str, Any] = {
        "tokenizer": video_tok.init(cfg.tokenizer, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
        # fc_norm (mean-pooling norm), VideoMAE use_mean_pooling=True
        "fc_norm_scale": torch.ones(d, dtype=torch.float32, device=device),
        "fc_norm_bias": torch.zeros(d, dtype=torch.float32, device=device),
        "head": cls_head.init(cfg.head, generator, device),
    }
    if cfg.pos_embed == "learned":
        pos = torch.randn(1, cfg.tokenizer.num_patches, d, generator=generator) * 0.02
        params["pos_embed"] = pos.to(device)
    return params


def forward(
    params: Dict[str, Any],
    clips: torch.Tensor,  # [B, T, H, W, C]
    cfg: VideoClassifierConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    tokens = video_tok.apply(params["tokenizer"], clips, cfg.tokenizer)
    if cfg.pos_embed == "learned":
        pos = params["pos_embed"]
    else:
        pos = video_tok.sincos_pos_embed_on(
            cfg.encoder.dim, cfg.tokenizer.num_patches, tokens.device
        )
    tokens = tokens + pos.to(tokens.dtype)
    x = enc.encode(params["encoder"], tokens, cfg.encoder, precision=precision)
    feats = x.mean(dim=1)
    feats = enc.layer_norm(
        feats, params["fc_norm_scale"], params["fc_norm_bias"], cfg.ln_eps
    )
    return cls_head.apply(params["head"], feats, cfg.head)


class VideoClassifier(ImageClassifier):
    """Serving wrapper, constructed like :class:`ImageClassifier` from a
    :class:`VideoClassifierConfig` and its parameters: they are held as
    buffers on one device (None: the card), cast once for ``precision``.
    [B, T, H, W, C] clips (uint8 or float) -> [B, num_classes] logits."""

    @torch.no_grad()
    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), clips, self.cfg, self.precision)

"""Multimodal fusion classifier: the published Meta-Transformer usage
pattern as a model.

Port of ``metatransformer_tpu/models/multimodal_classifier.py``:
per-modality ``Data2Seq`` tokenizers (the reference README's video, audio
and time series by default), ``pipeline.fuse_and_encode`` over the
concatenated sequence, mean pool and a linear head. At the default
geometry one sample is 1568 + 1212 + 96 = 2876 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from metatransformer_tpu_torch import pipeline
from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc


@dataclasses.dataclass(frozen=True)
class MultimodalClassifierConfig:
    # the README demo's trio by default; any pipeline.MODALITIES subset works
    modalities: Tuple[str, ...] = ("video", "audio", "time-series")
    # per-modality tokenizer configs (None entries: the facade's defaults at
    # the encoder width)
    tokenizers: Tuple[Optional[Any], ...] = (None, None, None)
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 1000

    def facades(self) -> Dict[str, pipeline.Data2Seq]:
        toks = self.tokenizers or (None,) * len(self.modalities)
        return {
            m: pipeline.Data2Seq(m, dim=self.encoder.dim, config=tc)
            for m, tc in zip(self.modalities, toks)
        }


def init(
    cfg: MultimodalClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    tok = {m: f.init(generator, device) for m, f in cfg.facades().items()}
    w = torch.empty(cfg.encoder.dim, cfg.num_classes)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return {
        "tok": tok,
        "encoder": enc.init(cfg.encoder, generator, device),
        "head": {"w": (w * 0.02).to(device), "b": torch.zeros(cfg.num_classes, device=device)},
    }


def forward(
    params: Dict[str, Any],
    inputs: Dict[str, torch.Tensor],
    cfg: MultimodalClassifierConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """inputs: modality -> raw batch (each [B, ...] in its raw schema; audio
    is the [B, frames, mel] spectrogram). Returns [B, num_classes] logits."""
    facades = cfg.facades()
    groups = [facades[m](params["tok"][m], inputs[m]) for m in cfg.modalities]
    feats = pipeline.fuse_and_encode(params["encoder"], groups, cfg.encoder, precision=precision)
    return feats.float().mean(dim=1) @ params["head"]["w"] + params["head"]["b"]

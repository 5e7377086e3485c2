"""Multi-modality serving: the published Meta-Transformer usage pattern.

Port of ``metatransformer_tpu/pipeline.py``: per-modality ``Data2Seq``
tokenizers over the reference's 12 modalities (text, image, point cloud,
audio, video, infrared, hyper-spectral, x-ray, tabular, graph,
time-series, IMU), a fuse-then-encode step that concatenates their token
sequences along the sequence axis and runs the one shared encoder, and
bucketed encoding: ragged sequences padded to a short ladder of lengths
with keep-masks, so a server sees few distinct shapes.

Everything runs eagerly on the device the inputs lie on. Under the BF16
policy buckets of 64-256 tokens run the fused sublayer kernels and
buckets of 512 and up the flash-attention kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.tokenizers import (
    audio as audio_tok,
    graph as graph_tok,
    hyper as hyper_tok,
    image as image_tok,
    point as point_tok,
    tabular as tab_tok,
    text as text_tok,
    time_series as ts_tok,
    video as video_tok,
)

# modality name -> (tokenizer module, config class); image-like modalities
# share the image tokenizer, IMU the time-series one.
MODALITIES: Dict[str, Tuple[Any, Any]] = {
    "image": (image_tok, image_tok.ImageTokenizerConfig),
    "infrared": (image_tok, image_tok.ImageTokenizerConfig),
    "x-ray": (image_tok, image_tok.ImageTokenizerConfig),
    "video": (video_tok, video_tok.VideoTokenizerConfig),
    "audio": (audio_tok, audio_tok.AudioTokenizerConfig),
    "time-series": (ts_tok, ts_tok.TimeSeriesConfig),
    "imu": (ts_tok, ts_tok.TimeSeriesConfig),
    "tabular": (tab_tok, tab_tok.TabularTokenizerConfig),
    "hyper": (hyper_tok, hyper_tok.HyperTokenizerConfig),
    "graph": (graph_tok, graph_tok.GraphTokenizerConfig),
    "text": (text_tok, text_tok.TextTokenizerConfig),
    "point": (point_tok, point_tok.PointTokenizerConfig),
}

BUCKETS = (64, 128, 256, 512, 1024, 1600, 2048, 3072)


@dataclasses.dataclass
class Data2Seq:
    """Counterpart of the reference's ``Data2Seq(modality, dim)``.

    ``init(generator, device)`` makes the tokenizer's parameters; calling
    the instance tokenizes a raw batch to [B, T, dim]. Modalities whose
    tokenizers take more inputs (a graph's generator, the hyper cls token)
    accept them as keywords.
    """

    modality: str
    dim: int = 768
    config: Optional[Any] = None

    def __post_init__(self):
        if self.modality not in MODALITIES:
            raise ValueError(f"unknown modality {self.modality!r}; known: {sorted(MODALITIES)}")
        mod, cfg_cls = MODALITIES[self.modality]
        self._mod = mod
        if self.config is None:
            if self.modality == "text":
                self.config = cfg_cls(target_dim=self.dim)
            elif self.modality == "point":
                self.config = cfg_cls(embed_dim=self.dim)
            else:
                self.config = cfg_cls(dim=self.dim)

    def init(
        self, generator: torch.Generator, device: _device.Device = None
    ) -> Dict[str, torch.Tensor]:
        """Seeded parameters on ``device`` (None: the card)."""
        return self._mod.init(self.config, generator, device)

    def _apply(self, params, raw, **kw) -> torch.Tensor:
        mod = self.modality
        if mod == "point":
            _, tokens = self._mod.apply(params, raw, self.config, **kw)
            return tokens
        if mod == "graph":
            if not isinstance(raw, dict):
                raise TypeError(
                    "Data2Seq('graph') takes a padded batch dict, as the reference does; "
                    "pad raw graphs into one first with "
                    "metatransformer_tpu_torch.data.graph_collate.collate")
            tokens, _ = self._mod.apply(params, raw, self.config, **kw)
            return tokens
        if mod == "hyper":
            cls = kw.pop("cls_token", None)
            if cls is None:
                cls = torch.zeros(1, 1, self.dim, device=raw.device)
            return self._mod.apply(params, raw, self.config, cls, **kw)
        return self._mod.apply(params, raw, self.config, **kw)

    def __call__(self, params, raw, **kw) -> torch.Tensor:
        return self._apply(params, raw, **kw)


def fuse_and_encode(
    encoder_params: Dict[str, torch.Tensor],
    token_groups: Sequence[torch.Tensor],
    cfg: enc.EncoderConfig,
    masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """Concatenate token sequences along axis 1 and run the shared encoder:
    the reference's ``torch.concat([video, audio, ts], dim=1)`` fusion. A
    group without a mask keeps every token."""
    tokens = torch.cat(list(token_groups), dim=1)
    mask = None
    if masks is not None and any(m is not None for m in masks):
        mask = torch.cat([
            torch.ones(toks.shape[:2], dtype=torch.bool, device=toks.device) if m is None
            else m.bool()
            for toks, m in zip(token_groups, masks)
        ], dim=1)
    return enc.encode(encoder_params, tokens, cfg, mask=mask, precision=precision)


def bucket_length(t: int, buckets: Sequence[int] = BUCKETS) -> int:
    """The bucket (padded length) for a sequence of ``t`` tokens."""
    for b in buckets:
        if t <= b:
            return b
    raise ValueError(f"sequence length {t} exceeds largest bucket {buckets[-1]}")


def pad_to_bucket(
    tokens: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    buckets: Sequence[int] = BUCKETS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad [B, T, D] tokens (+ [B, T] keep-mask) with zeros to the bucket
    length; returns (tokens, keep_mask)."""
    b, t, _ = tokens.shape
    tb = bucket_length(t, buckets)
    if mask is None:
        mask = torch.ones(b, t, dtype=torch.bool, device=tokens.device)
    if tb > t:
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, tb - t))
        mask = torch.nn.functional.pad(mask, (0, tb - t))
    return tokens, mask


def encode_bucketed(
    encoder_params: Dict[str, torch.Tensor],
    tokens: torch.Tensor,
    mask: torch.Tensor,
    cfg: enc.EncoderConfig,
    precision: enc.Precision = enc.BF16,
) -> torch.Tensor:
    """Masked shared encoding of one bucket."""
    return enc.encode(encoder_params, tokens, cfg, mask=mask, precision=precision)


def encode_bucketed_pooled(
    encoder_params: Dict[str, torch.Tensor],
    tokens: torch.Tensor,
    mask: torch.Tensor,
    cfg: enc.EncoderConfig,
    precision: enc.Precision = enc.BF16,
) -> torch.Tensor:
    """:func:`encode_bucketed` followed by the mean over kept tokens in fp32:
    [B, T, D] -> [B, D], so a pooled answer leaves the device as B * D
    floats."""
    feats = enc.encode(encoder_params, tokens, cfg, mask=mask, precision=precision).float()
    m = mask.float()[..., None]
    return (feats * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)

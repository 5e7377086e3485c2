"""Audio classifier (AST-on-Meta-Transformer), waveform -> logits.

Port of ``metatransformer_tpu/models/audio_classifier.py``. As the
reference's forward (which computes cls / dist tokens and never uses
them), the effective model is ``patch_embed -> +pos -> frozen encoder ->
LN -> (x[:, 0] + x[:, 1]) / 2 -> head``: it averages the first two patch
tokens (``pool="first2_avg"``); ``pool="cls_dist_avg_fixed"`` prepends the
two prefix tokens it evidently intended. At 1024 frames x 128 mel bins a
clip is 1212 tokens, which the encoder sends through flash attention.
:func:`forward_waveform` computes the fbank features on the waveform's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.ops import fbank as fbank_op
from metatransformer_tpu_torch.tokenizers import audio as audio_tok


@dataclasses.dataclass(frozen=True)
class AudioClassifierConfig:
    tokenizer: audio_tok.AudioTokenizerConfig = audio_tok.AudioTokenizerConfig()
    fbank: fbank_op.FbankConfig = fbank_op.FbankConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 35  # Speech Commands V2
    pool: str = "first2_avg"  # reference-exact; or "cls_dist_avg_fixed"
    ln_eps: float = 1e-6  # timm v.norm

    @property
    def head(self) -> cls_head.ClsHeadConfig:
        return cls_head.ClsHeadConfig(in_dim=self.encoder.dim, num_classes=self.num_classes)


def adapt_pos_embed(
    pos_embed: torch.Tensor,  # [1, n_prefix + f0*t0, D]
    old_grid: tuple,  # (f0, t0): AudioSet AST (12, 101)
    new_grid: tuple,  # (f1, t1) for the target fstride / tstride geometry
    n_prefix: int = 2,  # cls + dist tokens
) -> torch.Tensor:
    """Adapt a pretrained AST positional embedding to a new time-frequency
    patch grid: a smaller grid takes a center cut of the source grid, a
    larger one interpolates bilinearly (half-pixel centers), the time axis
    first, then frequency. Returns [1, n_prefix + f1*t1, D]."""
    f0, t0 = old_grid
    f1, t1 = new_grid
    prefix = pos_embed[:, :n_prefix]
    d = pos_embed.shape[-1]
    grid = pos_embed[:, n_prefix:].reshape(1, f0, t0, d).permute(0, 3, 1, 2)  # [1, D, F, T]
    if t1 < t0:
        start = t0 // 2 - t1 // 2
        grid = grid[..., start : start + t1]
    elif t1 > t0:
        grid = F.interpolate(grid, size=(f0, t1), mode="bilinear", align_corners=False)
    if f1 < f0:
        start = f0 // 2 - f1 // 2
        grid = grid[:, :, start : start + f1]
    elif f1 > f0:
        grid = F.interpolate(grid, size=(f1, t1), mode="bilinear", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, f1 * t1, d)
    return torch.cat([prefix, grid], dim=1)


def init(
    cfg: AudioClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    d = cfg.encoder.dim
    pos = torch.randn(1, cfg.tokenizer.num_patches, d, generator=generator) * 0.02
    params: Dict[str, Any] = {
        "tokenizer": audio_tok.init(cfg.tokenizer, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
        "pos_embed": pos.to(device),
        "norm_scale": torch.ones(d, device=device),
        "norm_bias": torch.zeros(d, device=device),
        "head": cls_head.init(cfg.head, generator, device),
    }
    if cfg.pool == "cls_dist_avg_fixed":
        params["prefix_tokens"] = torch.zeros(1, 2, d, device=device)
    return params


def forward_spectrogram(
    params: Dict[str, Any],
    spectrogram: torch.Tensor,  # [B, T, F]
    cfg: AudioClassifierConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    tokens = audio_tok.apply(params["tokenizer"], spectrogram, cfg.tokenizer)
    tokens = tokens + params["pos_embed"].to(tokens.dtype)
    if cfg.pool == "cls_dist_avg_fixed":
        b = tokens.shape[0]
        prefix = params["prefix_tokens"].to(tokens.dtype).expand(b, 2, cfg.encoder.dim)
        tokens = torch.cat([prefix, tokens], dim=1)
    x = enc.encode(params["encoder"], tokens, cfg.encoder, precision=precision)
    x = enc.layer_norm(x, params["norm_scale"], params["norm_bias"], cfg.ln_eps)
    feats = (x[:, 0, :] + x[:, 1, :]) / 2.0
    return cls_head.apply(params["head"], feats, cfg.head)


# Uniform model API alias: every model has ``forward``.
forward = forward_spectrogram


def forward_waveform(
    params: Dict[str, Any],
    waveform: torch.Tensor,  # [B, num_samples]
    cfg: AudioClassifierConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """Raw waveform -> logits: mean removal, fbank and the forward, all on
    the waveform's device."""
    wav = waveform.float()
    wav = wav - wav.mean(dim=-1, keepdim=True)
    return forward_spectrogram(params, fbank_op.fbank(wav, cfg.fbank), cfg, precision)

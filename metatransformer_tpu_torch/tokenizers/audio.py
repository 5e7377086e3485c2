"""Audio (AST) tokenizer: overlapping strided conv over the spectrogram.

Port of ``metatransformer_tpu/tokenizers/audio.py``: a 1-channel 16 x 16
convolution with (fstride, tstride) = (10, 10) over the [freq, time]
log-mel spectrogram, giving overlapping patches (12 x 101 = 1212 tokens
at 128 mel bins and 1024 frames). The weight keeps the reference's HWIO
layout [ph, pw, 1, D], so JAX parameters carry across unchanged; the
product is one fp32 matmul over the unfolded patches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class AudioTokenizerConfig:
    num_mel_bins: int = 128  # frequency dim (F)
    num_frames: int = 1024  # time dim (T)
    patch_size: int = 16
    fstride: int = 10
    tstride: int = 10
    dim: int = 768

    @property
    def f_patches(self) -> int:
        return (self.num_mel_bins - self.patch_size) // self.fstride + 1

    @property
    def t_patches(self) -> int:
        return (self.num_frames - self.patch_size) // self.tstride + 1

    @property
    def num_patches(self) -> int:
        return self.f_patches * self.t_patches


def init(
    cfg: AudioTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """Normal(0, patch**-1) HWIO weights drawn on the CPU, zero bias."""
    device = _device.resolve(device)
    scale = (cfg.patch_size * cfg.patch_size) ** -0.5
    w = torch.randn(cfg.patch_size, cfg.patch_size, 1, cfg.dim, generator=generator) * scale
    return {
        "w": w.to(device),
        "b": torch.zeros(cfg.dim, dtype=torch.float32, device=device),
    }


def apply(
    params: Dict[str, torch.Tensor],
    spectrogram: torch.Tensor,
    cfg: AudioTokenizerConfig,
) -> torch.Tensor:
    """[B, T, F] log-mel spectrogram -> [B, f_patches*t_patches, D] (fp32).

    As AST's forward: the input is viewed as a 1-channel [F, T] image and
    patches flatten frequency-major.
    """
    x = spectrogram.float().transpose(1, 2)  # [B, F, T]
    p = cfg.patch_size
    # [B, F', T', ph, pw]: the overlapping windows as strided views
    win = x.unfold(1, p, cfg.fstride).unfold(2, p, cfg.tstride)
    b, fp, tp = win.shape[:3]
    w = params["w"].reshape(p * p, cfg.dim)  # HWIO with one input channel
    return win.reshape(b, fp * tp, p * p) @ w + params["b"]


def convert_torch_conv(
    weight: np.ndarray, bias: np.ndarray, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """torch Conv2d [D, 1, ph, pw] -> HWIO [ph, pw, 1, D]."""
    device = _device.resolve(device)
    w = np.transpose(np.asarray(weight, np.float32), (2, 3, 1, 0))
    return {
        "w": torch.tensor(np.ascontiguousarray(w), device=device),
        "b": torch.tensor(np.asarray(bias, np.float32), device=device),
    }


def init_from_rgb_patch(
    rgb_w: np.ndarray, rgb_b: np.ndarray, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """AST's ImageNet-init trick: channel-sum an RGB patch projection.
    rgb_w: torch layout [D, 3, ph, pw]."""
    summed = np.asarray(rgb_w, np.float32).sum(axis=1, keepdims=True)
    return convert_torch_conv(summed, rgb_b, device)

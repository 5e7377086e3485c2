"""Video tokenizer: 3D tubelet patch embedding.

Port of ``metatransformer_tpu/tokenizers/video.py``. A stride == kernel
Conv3d is a block reshape followed by one matmul. Clips are
[B, T, H, W, C] (channels last); a tubelet flattens in (kt, ph, pw, c)
order, and :func:`convert_torch_conv3d` transposes torch's
[D, C, kt, kh, kw] weights to match. The working geometry is VideoMAE's:
tubelet 2, patch 16 over 16 frames of 224 x 224 -> [B, 8*14*14 = 1568, 768].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class VideoTokenizerConfig:
    num_frames: int = 16
    img_size: int = 224
    patch_size: int = 16
    tubelet_size: int = 2
    in_channels: int = 3
    dim: int = 768

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def t_patches(self) -> int:
        return self.num_frames // self.tubelet_size

    @property
    def num_patches(self) -> int:
        return self.t_patches * self.grid * self.grid

    @property
    def patch_dim(self) -> int:
        return self.tubelet_size * self.patch_size * self.patch_size * self.in_channels


def init(
    cfg: VideoTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """Normal(0, patch_dim**-0.5) weights drawn on the CPU, zero bias."""
    device = _device.resolve(device)
    w = torch.randn(cfg.patch_dim, cfg.dim, generator=generator) * cfg.patch_dim**-0.5
    return {
        "w": w.to(device),
        "b": torch.zeros(cfg.dim, dtype=torch.float32, device=device),
    }


def tubelets(clips: torch.Tensor, tubelet: int, patch: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, (T/tt)*(H/p)*(W/p), tt*p*p*C]."""
    b, t, h, w, c = clips.shape
    tt, gh, gw = t // tubelet, h // patch, w // patch
    x = clips.reshape(b, tt, tubelet, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # [B, tt, gh, gw, tub, p, p, C]
    return x.reshape(b, tt * gh * gw, tubelet * patch * patch * c)


def apply(
    params: Dict[str, torch.Tensor],
    clips: torch.Tensor,
    cfg: VideoTokenizerConfig,
) -> torch.Tensor:
    """Raw [B, T, H, W, C] clip -> [B, N, D] tokens (fp32).

    uint8 frames are scaled to [0, 1] on the device they lie on, so pixels
    cross the host-to-device link at 1 byte each.
    """
    if clips.dtype == torch.uint8:
        clips = clips.to(torch.float32) * (1.0 / 255.0)
    x = tubelets(clips, cfg.tubelet_size, cfg.patch_size)
    return x @ params["w"] + params["b"]


def convert_torch_conv3d(
    weight: np.ndarray, bias: np.ndarray, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """torch Conv3d [D, C, kt, kh, kw] (+[D]) -> our [kt*kh*kw*C, D] weights."""
    device = _device.resolve(device)
    d = weight.shape[0]
    w = np.transpose(np.asarray(weight, np.float32), (2, 3, 4, 1, 0)).reshape(-1, d)
    return {
        "w": torch.tensor(w, device=device),
        "b": torch.tensor(np.asarray(bias, np.float32), device=device),
    }


def sincos_pos_embed(dim: int, length: int) -> np.ndarray:
    """VideoMAE's fixed sinusoid table, [1, length, dim] fp32 (float64 math)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    omega = 1.0 / (10000 ** (2 * (np.arange(dim, dtype=np.float64)[None] // 2) / dim))
    table = pos * omega
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table[None].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _sincos_cached(dim: int, length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sincos_pos_embed(dim, length)).to(device)


def sincos_pos_embed_on(dim: int, length: int, device) -> torch.Tensor:
    """The table of :func:`sincos_pos_embed` as a tensor on ``device``, built
    once per (dim, length, device) and kept: the reference folds it into its
    compiled program, an eager forward would pay numpy on every call.
    Callers must not write to it."""
    return _sincos_cached(dim, length, torch.device(device))

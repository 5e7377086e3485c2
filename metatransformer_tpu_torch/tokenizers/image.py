"""Image / Infrared / X-Ray tokenizer: 2D patch embedding.

Port of ``metatransformer_tpu/tokenizers/image.py``. A stride == kernel
convolution is a block reshape followed by one matmul. Images are NHWC and
patches flatten in (ph, pw, c) order; :func:`convert_torch_conv`
transposes torch's [D, C, ph, pw] conv weights to match.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class ImageTokenizerConfig:
    img_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    dim: int = 768

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels


def init(
    cfg: ImageTokenizerConfig,
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


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], flatten order (ph, pw, c)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, p, p, C]
    return x.reshape(b, gh * gw, patch * patch * c)


def apply(
    params: Dict[str, torch.Tensor],
    images: torch.Tensor,
    cfg: ImageTokenizerConfig,
) -> torch.Tensor:
    """Raw [B, H, W, C] image -> [B, T, D] tokens (fp32).

    uint8 inputs are scaled to [0, 1] on the device they lie on, so pixels
    cross the host-to-device link at 1 byte each.
    """
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * (1.0 / 255.0)
    x = patchify(images, cfg.patch_size)
    return x @ params["w"] + params["b"]


def convert_torch_conv(
    weight: np.ndarray, bias: np.ndarray, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """torch Conv2d [D, C, ph, pw] (+[D]) -> our [ph*pw*C, D] matmul weights."""
    device = _device.resolve(device)
    d = weight.shape[0]
    w = np.transpose(np.asarray(weight, np.float32), (2, 3, 1, 0)).reshape(-1, d)
    return {
        "w": torch.tensor(w, device=device),
        "b": torch.tensor(np.asarray(bias, np.float32), device=device),
    }

"""Multi-scale deformable attention (MSDeformAttn), in PyTorch.

Port of ``metatransformer_tpu/ops/ms_deform_attn.py``. The reference is XLA
code, not a Pallas kernel: the bilinear gather of every level and point is
``F.grid_sample`` (``align_corners=False``, zero padding) on coordinates
``2c - 1``, and the weighted sum over levels and points is an einsum.
Parameters keep the reference's names and ``[in, out]`` linear layout.

``mm`` is the port's matmul precision convention
(:func:`..core.encoder.linear_at`): "highest" is full fp32, "default" rounds the
operands of the four projections to bf16 and accumulates in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C], coords [B, N, 2] in normalized [0, 1] (x, y) ->
    [B, N, C]; align_corners=False, zero padding."""
    grid = (2.0 * coords - 1.0)[:, :, None, :].to(img.dtype)  # [B, N, 1, 2]
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)  # [B, C, N, 1]
    return out[..., 0].transpose(1, 2)


def ms_deform_attn_core(
    value: torch.Tensor,  # [B, S, H, Dh]
    spatial_shapes: Sequence[Tuple[int, int]],  # [(H_l, W_l), ...]
    sampling_locations: torch.Tensor,  # [B, Lq, H, L, P, 2] in [0, 1]
    attention_weights: torch.Tensor,  # [B, Lq, H, L, P]
) -> torch.Tensor:
    """-> [B, Lq, H*Dh]: each level sampled, weighted and summed."""
    b, s, h, dh = value.shape
    _, lq, _, _, p, _ = sampling_locations.shape
    offsets = np.concatenate([[0], np.cumsum([hh * ww for hh, ww in spatial_shapes])]).tolist()
    out = value.new_zeros((b, lq, h, dh))
    for li, (hl, wl) in enumerate(spatial_shapes):
        vl = value[:, offsets[li]: offsets[li + 1]]  # [B, Hl*Wl, H, Dh]
        vl = vl.permute(0, 2, 1, 3).reshape(b * h, hl, wl, dh)
        loc = sampling_locations[:, :, :, li]  # [B, Lq, H, P, 2]
        loc = loc.permute(0, 2, 1, 3, 4).reshape(b * h, lq * p, 2)
        sampled = bilinear_sample(vl, loc).reshape(b, h, lq, p, dh)
        wgt = attention_weights[:, :, :, li].permute(0, 2, 1, 3)  # [B, H, Lq, P]
        out = out + torch.einsum("bhqpd,bhqp->bqhd", sampled, wgt)
    return out.reshape(b, lq, h * dh)


@dataclasses.dataclass(frozen=True)
class MSDeformAttnConfig:
    dim: int = 768
    num_heads: int = 12  # the adapter's deform_num_heads (12 for B16)
    num_levels: int = 4
    num_points: int = 4
    ratio: float = 1.0  # value-channel ratio (ViT-Adapter uses 0.5)

    @property
    def head_dim(self) -> int:
        return int(self.dim * self.ratio) // self.num_heads

    @property
    def value_dim(self) -> int:
        return int(self.dim * self.ratio)


def init(
    cfg: MSDeformAttnConfig, generator: torch.Generator, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """The reference's init: zero sampling-offset and attention weights, the
    offset bias on a ring of directions (``_reset_parameters``), normal value
    and output projections. Drawn on the CPU, then moved to ``device``."""
    device = _device.resolve(device)
    d, h, l, p = cfg.dim, cfg.num_heads, cfg.num_levels, cfg.num_points  # noqa: E741
    thetas = np.arange(h) * (2.0 * np.pi / h)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # [H, 2]
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, l, p, 1))
    for i in range(p):
        grid[:, :, i, :] *= i + 1
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    params = {
        "sampling_offsets_w": torch.zeros(d, h * l * p * 2),
        "sampling_offsets_b": torch.tensor(grid.reshape(-1), dtype=torch.float32),
        "attn_w": torch.zeros(d, h * l * p),
        "attn_b": torch.zeros(h * l * p),
        "value_w": randn(d, cfg.value_dim) * d**-0.5,
        "value_b": torch.zeros(cfg.value_dim),
        "out_w": randn(cfg.value_dim, d) * cfg.value_dim**-0.5,
        "out_b": torch.zeros(d),
    }
    return {k: v.to(device) for k, v in params.items()}


def _proj(x, params, name, mm):
    return enc.linear_at(x, params[f"{name}_w"], params[f"{name}_b"], mm)


def apply(
    params: Dict[str, torch.Tensor],
    query: torch.Tensor,  # [B, Lq, D]
    reference_points: torch.Tensor,  # [B, Lq, L, 2] normalized centers
    value_tokens: torch.Tensor,  # [B, S, D] flattened multi-scale features
    spatial_shapes: Sequence[Tuple[int, int]],
    cfg: MSDeformAttnConfig,
    mm: str = "highest",
) -> torch.Tensor:
    """MSDeformAttn.forward -> [B, Lq, D]."""
    b, lq, _ = query.shape
    s = value_tokens.shape[1]
    h, l, p = cfg.num_heads, cfg.num_levels, cfg.num_points  # noqa: E741
    value = _proj(value_tokens, params, "value", mm).reshape(b, s, h, cfg.head_dim)
    offsets = _proj(query, params, "sampling_offsets", mm).reshape(b, lq, h, l, p, 2)
    attn = _proj(query, params, "attn", mm).reshape(b, lq, h, l * p)
    attn = torch.softmax(attn, dim=-1).reshape(b, lq, h, l, p)
    wh = torch.tensor([[wl, hl] for hl, wl in spatial_shapes], dtype=torch.float32,
                      device=query.device)
    loc = reference_points[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
    out = ms_deform_attn_core(value, spatial_shapes, loc, attn)
    return _proj(out, params, "out", mm)

"""Voxelisation and the mean / pillar VFEs.

Port of ``metatransformer_tpu/ops/voxelize.py``, which replaces pcdet's
spconv ``VoxelGenerator`` and its mean / pillar VFEs with dense,
fixed-shape scatters over per-point voxel ids.

The pillar max is ``scatter_reduce(..., "amax", include_self=False)``: after
the ReLU many features are exactly 0, so ties are the rule, and ``amax``
splits the gradient evenly among tied points, as the reference's
``jax.ops.segment_max`` does (``torch.max(dim)`` would send it all to one).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    # point cloud range: (x0, y0, z0, x1, y1, z1)
    pc_range: Tuple[float, ...] = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    voxel_size: Tuple[float, ...] = (0.16, 0.16, 4.0)  # pillar default

    @property
    def grid_size(self) -> Tuple[int, int, int]:  # (nx, ny, nz)
        r = self.pc_range
        return (
            int(round((r[3] - r[0]) / self.voxel_size[0])),
            int(round((r[4] - r[1]) / self.voxel_size[1])),
            int(round((r[5] - r[2]) / self.voxel_size[2])),
        )


def _f32(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def voxel_ids(points: torch.Tensor, cfg: VoxelConfig):
    """points [B, N, 3+] -> (linear voxel id [B, N], valid [B, N]).
    Out-of-range points get id 0 and valid False."""
    nx, ny, nz = cfg.grid_size
    r, vs = _f32(cfg.pc_range, points), _f32(cfg.voxel_size, points)
    coords = torch.floor((points[..., :3] - r[:3]) / vs).long()
    hi = torch.tensor([nx, ny, nz], device=points.device)
    valid = ((coords >= 0) & (coords < hi)).all(-1)
    cx, cy, cz = coords.unbind(-1)
    lin = (cz * ny + cy) * nx + cx
    return torch.where(valid, lin, 0), valid


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    """[B, N, C] summed into [B, num, C] at ids [B, N]."""
    out = values.new_zeros(values.shape[0], num, values.shape[-1])
    return out.scatter_add(1, ids[..., None].expand_as(values), values)


def _segment_mean(values: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, num: int):
    s = _segment_sum(values * w[..., None], ids, num)
    c = _segment_sum(w[..., None], ids, num)
    return s / c.clamp_min(1.0)


def scatter_mean_vfe(points: torch.Tensor, cfg: VoxelConfig,
                     points_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MeanVFE: the dense voxel grid of mean features -> [B, nz, ny, nx, 3+C]."""
    nx, ny, nz = cfg.grid_size
    ids, valid = voxel_ids(points, cfg)
    if points_mask is not None:
        valid = valid & points_mask
    grid = _segment_mean(points, ids, valid.to(points.dtype), nx * ny * nz)
    return grid.reshape(points.shape[0], nz, ny, nx, points.shape[-1])


@dataclasses.dataclass(frozen=True)
class PillarVFEConfig:
    voxel: VoxelConfig = VoxelConfig()
    in_features: int = 4  # xyz + intensity
    channels: int = 64
    with_distance: bool = False

    @property
    def point_feat_dim(self) -> int:
        # raw + (xyz - pillar_mean) + (xy - pillar_center) [+ |xyz|]
        return self.in_features + 3 + 2 + (1 if self.with_distance else 0)


def pillar_vfe_init(cfg: PillarVFEConfig, generator: torch.Generator,
                    device: _device.Device = None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters (drawn on the CPU, moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    d = cfg.point_feat_dim
    return {
        "w": (torch.randn(d, cfg.channels, generator=generator) * d**-0.5).to(device),
        "norm_scale": torch.ones(cfg.channels, device=device),
        "norm_bias": torch.zeros(cfg.channels, device=device),
    }


def pillar_vfe_apply(params: Dict[str, torch.Tensor], points: torch.Tensor,
                     cfg: PillarVFEConfig,
                     points_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PillarVFE (``vfe/pillar_vfe.py``, dense form): points augmented
    with pillar-relative offsets, linear + batch norm + ReLU, max into the
    BEV grid -> [B, ny, nx, channels]."""
    vcfg = cfg.voxel
    nx, ny, _ = vcfg.grid_size
    v = nx * ny
    b = points.shape[0]
    r, vs = _f32(vcfg.pc_range, points), _f32(vcfg.voxel_size, points)

    coords = torch.floor((points[..., :2] - r[:2]) / vs[:2]).long()
    hi = torch.tensor([nx, ny], device=points.device)
    valid = ((coords >= 0) & (coords < hi)).all(-1) & (
        (points[..., 2] >= r[2]) & (points[..., 2] < r[5]))
    if points_mask is not None:
        valid = valid & points_mask
    ids = torch.where(valid, coords[..., 1] * nx + coords[..., 0], 0)
    w = valid.to(points.dtype)

    mean_xyz = _segment_mean(points[..., :3], ids, w, v)  # [B, V, 3]
    point_mean = mean_xyz.gather(1, ids[..., None].expand(-1, -1, 3))
    centers = (coords.to(points.dtype) + 0.5) * vs[:2] + r[:2]
    feats = [points, points[..., :3] - point_mean, points[..., :2] - centers]
    if cfg.with_distance:
        feats.append(torch.linalg.vector_norm(points[..., :3], dim=-1, keepdim=True))
    f = torch.cat(feats, -1) @ params["w"]
    # BatchNorm1d over the valid points (batch statistics)
    cnt = w.sum().clamp_min(1.0)
    fm = (f * w[..., None]).sum((0, 1)) / cnt
    fv = ((f - fm).square() * w[..., None]).sum((0, 1)) / cnt
    f = (f - fm) * torch.rsqrt(fv + 1e-3)
    f = torch.relu(f * params["norm_scale"] + params["norm_bias"])
    f = torch.where(valid[..., None], f, float("-inf"))
    grid = f.new_zeros(b, v, cfg.channels).scatter_reduce(
        1, ids[..., None].expand_as(f), f, "amax", include_self=False)
    grid = torch.where(torch.isfinite(grid), grid, 0.0)
    return grid.reshape(b, ny, nx, cfg.channels)

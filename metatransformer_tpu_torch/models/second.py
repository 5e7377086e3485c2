"""SECOND: the sparse-voxel 3D detector (pcdet's VoxelBackBone8x family).

Port of ``metatransformer_tpu/models/second.py``: MeanVFE ->
VoxelBackBone8x (sparse convs) -> HeightCompression -> BaseBEVBackbone ->
AnchorHeadSingle. The voxelisation and every sparse conv are
:mod:`..ops.sparse_conv`; the BEV backbone, anchor head, losses and NMS are
PointPillars' (:mod:`.detector3d`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d
from metatransformer_tpu_torch.models.detector3d import (  # noqa: F401 (re-export)
    AnchorConfig,
    detection_loss,
    predict,
)
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import sparse_conv as sp

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SECONDConfig:
    # KITTI geometry (tools/cfgs/kitti_models/second.yaml)
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    pc_range: Tuple[float, ...] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    spatial_shape: Tuple[int, int, int] = (41, 1600, 1408)  # (D, H=ny, W=nx)
    max_voxels: int = 16000
    point_features: int = 4  # xyz + intensity
    # VoxelBackBone8x channel plan
    widths: Tuple[int, ...] = (16, 16, 32, 64, 64, 128)
    bev_channels: Tuple[int, ...] = (128, 256)
    bev_strides: Tuple[int, ...] = (1, 2)
    up_channels: int = 256
    anchors: AnchorConfig = AnchorConfig()
    num_classes: int = 1
    dir_bins: int = 2

    @property
    def box_code(self) -> int:
        return 7

    @property
    def bev_hw(self) -> Tuple[int, int]:
        # 3 stride-2 sparse stages: spatial stride 8, then BEV block 0's stride
        return (self.spatial_shape[1] // 8 // self.bev_strides[0],
                self.spatial_shape[2] // 8 // self.bev_strides[0])


def _subm_init(randn, cin, cout, k=(3, 3, 3)):
    fan = int(np.prod(k)) * cin
    return {"w": randn(*k, cin, cout) * np.sqrt(2.0 / fan),
            "bn_scale": torch.ones(cout), "bn_bias": torch.zeros(cout)}


_CONVS = ("conv_input", "conv1", "conv2_down", "conv2_a", "conv2_b", "conv3_down", "conv3_a",
          "conv3_b", "conv4_down", "conv4_a", "conv4_b")


def _out_depth(cfg: SECONDConfig) -> int:
    d = cfg.spatial_shape[0]
    d = (d + 2 - 3) // 2 + 1  # conv2, depth pad 1     (41 -> 21)
    d = (d + 2 - 3) // 2 + 1  # conv3, depth pad 1     (21 -> 11)
    d = (d - 3) // 2 + 1      # conv4, depth pad 0     (11 -> 5)
    return (d - 3) // 2 + 1   # conv_out (3,1,1) pad 0 ( 5 -> 2)


def init_cpu(cfg: SECONDConfig, generator: torch.Generator) -> Params:
    """:func:`init`'s tree, on the CPU."""
    randn = detector3d._randn(generator)
    w = cfg.widths
    ins = (cfg.point_features, w[0], w[1], w[2], w[2], w[2], w[3], w[3], w[3], w[4], w[4])
    outs = (w[0], w[1], w[2], w[2], w[2], w[3], w[3], w[3], w[4], w[4], w[4])
    params: Params = {name: _subm_init(randn, ci, co) for name, ci, co in zip(_CONVS, ins, outs)}
    params["conv_out"] = _subm_init(randn, w[4], w[5], k=(3, 1, 1))
    # HeightCompression folds the depth into channels: 2 at KITTI depth
    cin = w[5] * _out_depth(cfg)
    for i, cout in enumerate(cfg.bev_channels):
        params[f"block{i}"] = detector3d._bev_block_init(randn, cin, cout, 5)
        params[f"up{i}"] = detector3d._up_init(randn, cout, cfg.up_channels)
        cin = cout
    params.update(detector3d._head_init(randn, cfg.up_channels * len(cfg.bev_channels), cfg))
    return params


def init(cfg: SECONDConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    return _to(init_cpu(cfg, generator), device)


def _block(st, p, rulebook=None):
    return sp.batch_norm_relu(sp.subm_conv3d(st, p["w"], rulebook), p["bn_scale"], p["bn_bias"])


def _down(st, p, stride, padding):
    st = sp.sparse_conv3d(st, p["w"], stride, padding)
    return sp.batch_norm_relu(st, p["bn_scale"], p["bn_bias"])


def voxel_backbone_8x_ms(params: Params, st: sp.SparseTensor
                         ) -> Tuple[sp.SparseTensor, Dict[str, sp.SparseTensor]]:
    """VoxelBackBone8x, also returning the stage outputs the reference
    exposes as ``multi_scale_3d_features`` (x_conv1 ... x_conv4 at strides
    1, 2, 4, 8), which the two-stage RoI heads read."""
    ms: Dict[str, sp.SparseTensor] = {}
    rb = sp.build_lookup(st)  # indice_key 'subm1': the stem and conv1
    st = _block(st, params["conv_input"], rb)
    st = _block(st, params["conv1"], rb)
    ms["x_conv1"] = st
    for stage, padding in ((2, (1, 1, 1)), (3, (1, 1, 1)), (4, (0, 1, 1))):
        st = _down(st, params[f"conv{stage}_down"], (2, 2, 2), padding)
        rb = sp.build_lookup(st)
        st = _block(st, params[f"conv{stage}_a"], rb)
        st = _block(st, params[f"conv{stage}_b"], rb)
        ms[f"x_conv{stage}"] = st
    st = _down(st, params["conv_out"], (2, 1, 1), (0, 0, 0))
    return st, ms


def voxel_backbone_8x(params: Params, st: sp.SparseTensor) -> sp.SparseTensor:
    """VoxelBackBone8x: stem + 4 stages, spatial stride 8, depth 41 -> 2."""
    return voxel_backbone_8x_ms(params, st)[0]


def height_compression(st: sp.SparseTensor) -> torch.Tensor:
    """SparseConvTensor.dense + depth folded into channels -> NHWC
    [B, H, W, D*C]."""
    dense = sp.to_dense(st)  # [B, D, H, W, C]
    b, d, h, w, c = dense.shape
    return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)


def voxelize(points: torch.Tensor, cfg: SECONDConfig,
             points_mask: Optional[torch.Tensor] = None) -> sp.SparseTensor:
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    return sp.voxelize_points(points, points_mask, cfg.voxel_size, cfg.pc_range,
                              cfg.spatial_shape, cfg.max_voxels)


def forward(params: Params, points: torch.Tensor, cfg: SECONDConfig,
            points_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """points [B, P, point_features] -> the anchor head's predictions (the
    contract of :func:`.detector3d.forward`)."""
    st = voxel_backbone_8x(params, voxelize(points, cfg, points_mask))
    feat = detector3d.bev_backbone(params, height_compression(st), cfg)
    return detector3d.anchor_head(params, feat, cfg)


def generate_anchors(cfg: SECONDConfig) -> np.ndarray:
    """The dense anchor grid at the BEV stride -> [A, 7] (x, y, z, l, w, h,
    r); every class at the first class's z centre, as the reference."""
    fy, fx = cfg.bev_hw
    return detector3d._anchor_grid(fx, fy, cfg.pc_range, cfg.anchors, per_class_z=False)

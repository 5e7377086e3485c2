"""MDF-wired 3D detectors: per-dataset norm affines and domain attention
inside the SECOND and CenterPoint backbones.

Port of ``metatransformer_tpu/models/mdf_detectors.py`` (3DTrans: UniNorm in
``spconv_backbone_unibn.py`` and ``base_bev_backbone.py``, the domain
attention of ``mdf_models/dense_cr.py``, ``build_network_multi_db``): every
norm affine of the base detector is stacked a dataset on a leading axis
(:func:`stack_norm_affines`) and gathered by the dataset id
(:func:`select_dataset`), a Python int or a 0-d tensor; the convs are
shared. Each step's batch comes from one dataset, so the batch statistics
are that dataset's. Domain attention recalibrates each BEV block's up
before the concat; the BEV backbone is :func:`.detector3d.bev_backbone`
(3x3 convs on the patch GEMM, as every BEV backbone of the port).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import centerpoint as cp
from metatransformer_tpu_torch.models import detector3d, mdf, second
from metatransformer_tpu_torch.models.mdf import DatasetId
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import sparse_conv as sp

Params = Dict[str, Any]
_STACKED_KEYS = ("bn_scale", "bn_bias", "gn_scale", "gn_bias")


def stack_norm_affines(params: Any, num_datasets: int) -> Any:
    """Every norm affine [C] -> a copy a dataset [D, C] (UniNorm: shared
    conv weights, a dataset's own norm parameters)."""
    if isinstance(params, dict):
        return {k: (v[None].repeat(num_datasets, *([1] * v.dim())) if k in _STACKED_KEYS
                    else stack_norm_affines(v, num_datasets)) for k, v in params.items()}
    if isinstance(params, list):
        return [stack_norm_affines(v, num_datasets) for v in params]
    return params


def select_dataset(params: Any, dataset_id: DatasetId) -> Any:
    """One dataset's affines gathered -> the plain tree the base detector's
    forward takes; the gradient reaches the gathered rows."""
    if isinstance(params, dict):
        return {k: (v[dataset_id] if k in _STACKED_KEYS else select_dataset(v, dataset_id))
                for k, v in params.items()}
    if isinstance(params, list):
        return [select_dataset(v, dataset_id) for v in params]
    return params


def _with_attention(params: Params, cfg):
    """The ``up_hook`` of :func:`.detector3d.bev_backbone` that applies
    block i's domain attention (None without it)."""
    if not cfg.domain_attention:
        return None
    dattn = cfg.dattn()
    return lambda i, u: mdf.domain_attention_apply(params[f"dattn{i}"], u, dattn)


def _attention_init(params: Params, cfg, generator: torch.Generator) -> None:
    if cfg.domain_attention:
        for i in range(len(cfg.base.bev_channels)):
            params[f"dattn{i}"] = mdf.domain_attention_init(cfg.dattn(), generator)


# --- MDF SECOND -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MDFSECONDConfig:
    base: second.SECONDConfig = second.SECONDConfig()
    num_datasets: int = 2
    domain_attention: bool = True
    reduction: int = 8

    def dattn(self) -> mdf.DomainAttentionConfig:
        return mdf.DomainAttentionConfig(self.base.up_channels, self.num_datasets, self.reduction)


def init(cfg: MDFSECONDConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    params = stack_norm_affines(second.init_cpu(cfg.base, generator), cfg.num_datasets)
    _attention_init(params, cfg, generator)
    return _to(params, device)


def forward(params: Params, points: torch.Tensor, cfg: MDFSECONDConfig, dataset_id: DatasetId,
            points_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """:func:`.second.forward`'s contract, plus the dataset switch."""
    sel = select_dataset(params, dataset_id)
    st = second.voxel_backbone_8x(sel, second.voxelize(points, cfg.base, points_mask))
    feat = detector3d.bev_backbone(sel, second.height_compression(st), cfg.base,
                                   _with_attention(params, cfg))
    return detector3d.anchor_head(sel, feat, cfg.base)


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, anchors: torch.Tensor, cfg: MDFSECONDConfig,
                  dataset_id: DatasetId, points_mask: Optional[torch.Tensor] = None):
    preds = forward(params, points, cfg, dataset_id, points_mask)
    return second.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg.base)


# --- MDF CenterPoint (the same wiring over the residual sparse backbone) ------


@dataclasses.dataclass(frozen=True)
class MDFCenterPointConfig:
    base: cp.CenterPointConfig = cp.CenterPointConfig()
    num_datasets: int = 2
    domain_attention: bool = True
    reduction: int = 8

    def dattn(self) -> mdf.DomainAttentionConfig:
        return mdf.DomainAttentionConfig(self.base.up_channels, self.num_datasets, self.reduction)


def init_centerpoint(cfg: MDFCenterPointConfig, generator: torch.Generator,
                     device: _device.Device = None) -> Params:
    device = _device.resolve(device)
    params = stack_norm_affines(cp.init(cfg.base, generator, "cpu"), cfg.num_datasets)
    _attention_init(params, cfg, generator)
    return _to(params, device)


def forward_centerpoint(params: Params, points: torch.Tensor, cfg: MDFCenterPointConfig,
                        dataset_id: DatasetId, points_mask: Optional[torch.Tensor] = None):
    base = cfg.base
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    sel = select_dataset(params, dataset_id)
    st = sp.voxelize_points(points, points_mask, base.voxel_size, base.pc_range,
                               base.spatial_shape, base.max_voxels)
    bev = second.height_compression(cp.voxel_res_backbone_8x(sel, st))
    feat = detector3d.bev_backbone(sel, bev, base, _with_attention(params, cfg))
    return cp.center_head(sel, feat, base)


def training_loss_centerpoint(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                              gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                              cfg: MDFCenterPointConfig, dataset_id: DatasetId,
                              points_mask: Optional[torch.Tensor] = None):
    preds = forward_centerpoint(params, points, cfg, dataset_id, points_mask)
    return cp.detection_loss(preds, gt_boxes, gt_labels, gt_valid, cfg.base)

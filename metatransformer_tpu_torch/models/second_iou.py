"""SECOND-IoU: SECOND + a rotated-RoI IoU confidence head.

Port of ``metatransformer_tpu/models/second_iou.py`` (pcdet's
``detectors/second_net_iou.py`` with ``roi_heads/second_head.py``): stage 1
is SECOND; stage 2 samples a rotated G x G window of the BEV feature map a
RoI by bilinear interpolation at rotated grid points (the reference's
affine_grid + grid_sample), runs shared FCs and predicts each box's IoU
with its ground truth (BCE on the soft IoU labels). At inference the IoU
prediction scores the stage-1 proposals; the head refines confidence, not
geometry.

As in the reference, the bilinear window clips its far corner (x1, y1) to
the map's edge but keeps the weights of the unclipped corner, so at the
border the four weights need not sum to 1. The proposal and target
machinery is Voxel R-CNN's (:mod:`.voxel_rcnn`), with this config's
``fg_per``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, second
from metatransformer_tpu_torch.models import voxel_rcnn as vr
from metatransformer_tpu_torch.models.vit_adapter import _to

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SECONDIoUConfig:
    stage1: second.SECONDConfig = second.SECONDConfig(bev_channels=(64, 128), up_channels=128)
    num_rois: int = 128
    fg_per: int = 64
    grid_size: int = 7  # ROI_GRID_POOL.GRID_SIZE
    shared_fc: Tuple[int, ...] = (256, 256)
    iou_fc: Tuple[int, ...] = (256, 256)
    reg_fg_thresh: float = 0.55
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    proposal_nms_thresh: float = 0.8
    proposal_pre: int = 1024

    @property
    def bev_channels_out(self) -> int:
        return self.stage1.up_channels * len(self.stage1.bev_channels)


def init(cfg: SECONDIoUConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    params: Params = {"stage1": second.init_cpu(cfg.stage1, generator)}
    randn = detector3d._randn(generator)
    cin = vr._fc_stack(randn, params, "shared", cfg.bev_channels_out * cfg.grid_size**2,
                       cfg.shared_fc)
    cin = vr._fc_stack(randn, params, "iou", cin, cfg.iou_fc)
    params["iou_pred"] = vr._lin_init(randn, cin, 1, std=0.01)
    return _to(params, device)


def rotated_roi_grid_sample(feat: torch.Tensor, rois: torch.Tensor,
                            cfg: SECONDIoUConfig) -> torch.Tensor:
    """Each RoI's rotated G x G window of the BEV map ``feat`` [B, H, W, C]
    (H = y, W = x), bilinearly sampled -> [B, R, G*G, C]."""
    s1 = cfg.stage1
    g = cfg.grid_size
    b, r, _ = rois.shape
    lin = (torch.arange(g, dtype=torch.float32, device=rois.device) + 0.5) / g - 0.5
    gx, gy = torch.meshgrid(lin, lin, indexing="ij")
    local = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).to(rois.dtype)  # [G*G, 2]
    pts = local * rois[..., None, 3:5]  # [B, R, G*G, 2]
    c, s = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    wx = pts[..., 0] * c - pts[..., 1] * s + rois[..., None, 0]
    wy = pts[..., 0] * s + pts[..., 1] * c + rois[..., None, 1]
    stride = s1.spatial_shape[2] // feat.shape[2]
    fx = (wx - s1.pc_range[0]) / s1.voxel_size[0] / stride - 0.5
    fy = (wy - s1.pc_range[1]) / s1.voxel_size[1] / stride - 0.5
    h, w = feat.shape[1:3]
    x0 = torch.floor(fx).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = torch.floor(fy).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    flat = feat.reshape(b, h * w, -1)

    def at(yy, xx):
        return detector3d._gather_rows(flat, (yy * w + xx).reshape(b, -1)).reshape(
            b, r, g * g, -1)

    x0f, x1f, y0f, y1f = (t.to(fx.dtype) for t in (x0, x1, y0, y1))
    wa, wb = (x1f - fx) * (y1f - fy), (x1f - fx) * (fy - y0f)
    wc, wd = (fx - x0f) * (y1f - fy), (fx - x0f) * (fy - y0f)
    return (at(y0, x0) * wa[..., None] + at(y1, x0) * wb[..., None]
            + at(y0, x1) * wc[..., None] + at(y1, x1) * wd[..., None])


def iou_head(params: Params, pooled: torch.Tensor, cfg: SECONDIoUConfig) -> torch.Tensor:
    """pooled [B, R, G*G, C] -> IoU logits [B, R]."""
    b, r = pooled.shape[:2]
    x = vr._mlp(pooled.reshape(b * r, -1), params,
                [f"shared{i}" for i in range(len(cfg.shared_fc))])
    x = vr._mlp(x, params, [f"iou{i}" for i in range(len(cfg.iou_fc))])
    out = x @ params["iou_pred"]["w"] + params["iou_pred"]["b"]
    return out[:, 0].reshape(b, r)


def as_voxel_rcnn(cfg: SECONDIoUConfig) -> vr.VoxelRCNNConfig:
    """The Voxel R-CNN config the proposals and RoI targets run under, as
    the reference builds it: stage 1, the proposal NMS, ``num_rois`` and
    ``fg_per`` from ``cfg``, the other target constants Voxel R-CNN's."""
    return vr.VoxelRCNNConfig(stage1=cfg.stage1, proposal_nms_thresh=cfg.proposal_nms_thresh,
                              proposal_pre=cfg.proposal_pre, num_rois=cfg.num_rois,
                              fg_per=cfg.fg_per)


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, anchors: torch.Tensor, cfg: SECONDIoUConfig,
                  points_mask: Optional[torch.Tensor] = None):
    """loss_rpn + the IoU head's BCE on the soft labels (second_net_iou
    get_training_loss + second_head.get_box_iou_layer_loss)."""
    vcfg = as_voxel_rcnn(cfg)
    preds, _, bev = vr.forward_stage1(params, points, vcfg, points_mask)
    rpn_loss, rpn_logs = second.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg.stage1)
    rois, _, roi_valid = vr.propose(vr._detached(preds), anchors, vcfg)
    targets = vr.sample_rois_for_rcnn(rois, roi_valid, gt_boxes, gt_valid, vcfg)
    pooled = rotated_roi_grid_sample(bev.detach(), targets["rois"], cfg)
    p = torch.sigmoid(iou_head(params, pooled, cfg)).clamp(1e-7, 1 - 1e-7)
    t = targets["cls_labels"]  # soft IoU labels
    iou_loss = (-(t * torch.log(p) + (1 - t) * torch.log(1 - p))).mean()
    return rpn_loss + iou_loss, {**{f"rpn_{k}": v for k, v in rpn_logs.items()},
                                 "iou": iou_loss}


def predict(params: Params, points: torch.Tensor, anchors: torch.Tensor, cfg: SECONDIoUConfig,
            score_thr: float = 0.1, iou_thr: float = 0.1, max_out: int = 128,
            points_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """The proposals scored by the IoU head, then the final rotated NMS; one
    dict a sample of tensors on the model's device."""
    with torch.no_grad():
        vcfg = as_voxel_rcnn(cfg)
        preds, _, bev = vr.forward_stage1(params, points, vcfg, points_mask)
        rois, _, roi_valid = vr.propose(preds, anchors, vcfg)
        iou_logits = iou_head(params, rotated_roi_grid_sample(bev, rois, cfg), cfg)
        return vr.final_nms(rois, iou_logits, roi_valid, score_thr, iou_thr, max_out)

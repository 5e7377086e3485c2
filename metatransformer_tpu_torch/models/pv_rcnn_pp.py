"""PV-RCNN++: proposal-centric keypoints and VectorPool aggregation.

Port of ``metatransformer_tpu/models/pv_rcnn_pp.py`` (pcdet's
``detectors/pv_rcnn_plusplus.py``): the proposals come first; then

- sectorized proposal-centric sampling (``voxel_set_abstraction.py``
  sample_points_with_roi + sector_fps): the points within a proposal's half
  diagonal plus ``spc_radius`` of their nearest proposal, split into
  ``num_sectors`` azimuth sectors, each sampled by furthest-point sampling
  with an even budget (:func:`..ops.point_ops.masked_fps`, the FPS kernel
  on the card, one launch a sector). The reference allocates the budget in
  proportion to the sectors' counts, which a static shape cannot; an empty
  sector falls back to the kept set, and an empty kept set to all points;
- VectorPool aggregation (``pointnet2_stack`` VectorPoolAggregationModule,
  'voxel_avg_pool'): the first ``nsample`` points by index inside the cube
  of half side ``radius`` around each centre are averaged in each of the
  n^3 sub-voxels (with their offsets), each sub-voxel applies its own
  linear map, and a post MLP takes the concat. Centres are taken in chunks
  of 512, as the reference's ``lax.map``, so no [B, M, N] tensor is built;
- the RoI head pools each RoI's G^3 grid over the weighted keypoints with
  a VectorPool too.

The point head, the BEV features and the proposal, target and loss
machinery are PV-RCNN's and Voxel R-CNN's. Two decisions at rounding edges
sit in named functions without gradient, so a caller can record and replay
them: :func:`spc_keep` (the nearest proposal, from expanded-form distances
that cancel in fp32, and the azimuth sector) and :func:`vector_pool_members`
(the cube test and each member's sub-voxel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, second
from metatransformer_tpu_torch.models import pv_rcnn as pv
from metatransformer_tpu_torch.models import voxel_rcnn as vr
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import point_ops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VectorPoolConfig:
    nvox: int = 2  # sub-voxels per axis (2x2x2 or 3x3x3)
    radius: float = 1.2  # MAX_NEIGHBOR_DISTANCE
    nsample: int = 32
    agg: int = 32  # each sub-voxel's channels (NUM_CHANNELS_OF_LOCAL_AGGREGATION)
    post: int = 64  # the post MLP's width
    stride: int = 1  # the voxel source's downsample factor


@dataclasses.dataclass(frozen=True)
class PVRCNNPPConfig:
    stage1: second.SECONDConfig = second.SECONDConfig(bev_channels=(128, 256), up_channels=256)
    num_keypoints: int = 4096
    num_sectors: int = 6
    spc_radius: float = 1.6  # SAMPLE_RADIUS_WITH_ROI
    out_features: int = 128
    vp_layers: Tuple[Tuple[str, VectorPoolConfig], ...] = (
        ("raw_points", VectorPoolConfig(2, 0.4, 32, 16, 32)),
        ("x_conv3", VectorPoolConfig(2, 1.2, 32, 32, 64, stride=4)),
        ("x_conv4", VectorPoolConfig(2, 2.4, 32, 32, 64, stride=8)),
    )
    use_bev: bool = True
    point_cls_fc: Tuple[int, ...] = (256, 256)
    num_rois: int = 128
    fg_per: int = 64
    grid_size: int = 6
    roi_vp: VectorPoolConfig = VectorPoolConfig(2, 0.8, 16, 16, 32)
    shared_fc: Tuple[int, ...] = (256, 256)
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    rcnn_cls_weight: float = 1.0
    rcnn_reg_weight: float = 1.0
    rcnn_corner_weight: float = 1.0
    point_cls_weight: float = 1.0
    proposal_nms_thresh: float = 0.8
    proposal_pre: int = 1024
    gt_extra_width: float = 0.2

    def source_channels(self, src: str) -> int:
        w = self.stage1.widths
        return {"raw_points": 1, "x_conv3": w[3], "x_conv4": w[4]}[src]

    @property
    def bev_channels_out(self) -> int:
        return self.stage1.up_channels * len(self.stage1.bev_channels)

    @property
    def vsa_channels(self) -> int:
        c = sum(vp.post for _, vp in self.vp_layers)
        return c + (self.bev_channels_out if self.use_bev else 0)


def _vp_init(randn, cin: int, vp: VectorPoolConfig) -> Params:
    v = vp.nvox**3
    # the position-specific linear map of each sub-voxel (the grouped conv)
    return {"local_w": randn(v, cin + 3, vp.agg) * np.sqrt(2.0 / (cin + 3)),
            "post": vr._lin_init(randn, v * vp.agg, vp.post)}


def init(cfg: PVRCNNPPConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    params: Params = {"stage1": second.init_cpu(cfg.stage1, generator)}
    randn = detector3d._randn(generator)
    for src, vp in cfg.vp_layers:
        params[f"vp_{src}"] = _vp_init(randn, cfg.source_channels(src), vp)
    params["fusion"] = vr._lin_init(randn, cfg.vsa_channels, cfg.out_features)
    c = vr._fc_stack(randn, params, "pt", cfg.vsa_channels, cfg.point_cls_fc)
    params["pt_pred"] = vr._lin_init(randn, c, 1, std=0.01)
    params["roi_vp"] = _vp_init(randn, cfg.out_features, cfg.roi_vp)
    vr._refine_init(randn, params, cfg.grid_size**3 * cfg.roi_vp.post, cfg)
    return _to(params, device)


# --- sectorized proposal-centric sampling -----------------------------------


@torch.no_grad()
def spc_keep(xyz: torch.Tensor, mask: torch.Tensor, rois: torch.Tensor,
             roi_valid: torch.Tensor, cfg: PVRCNNPPConfig) -> torch.Tensor:
    """The point set each sector samples from -> [num_sectors, B, N] bool:
    the valid points within ``half diagonal + spc_radius`` of their nearest
    valid proposal (the distances in the reference's expanded form), in the
    sector of their azimuth; an empty sector takes the whole kept set, and
    an empty kept set every valid point."""
    d2 = ((xyz**2).sum(-1)[:, :, None] - 2 * torch.einsum("bnc,brc->bnr", xyz, rois[..., :3])
          + (rois[..., :3] ** 2).sum(-1)[:, None, :])
    d2 = torch.where(roi_valid[:, None, :], d2, float("inf"))
    nearest = d2.argmin(-1)  # ties to the first, as jnp.argmin
    min_d2 = d2.gather(2, nearest[..., None])[..., 0]
    half_diag = 0.5 * torch.linalg.vector_norm(rois[..., 3:6], dim=-1)  # [B, R]
    limit = half_diag.gather(1, nearest) + cfg.spc_radius
    keep = mask & (torch.sqrt(min_d2) < limit) & roi_valid.any(-1)[:, None]
    angles = torch.atan2(xyz[..., 1], xyz[..., 0]) + np.pi
    sector = (angles / (2 * np.pi / cfg.num_sectors)).long().clamp(0, cfg.num_sectors - 1)
    masks = []
    for s in range(cfg.num_sectors):
        m = keep & (sector == s)
        m = torch.where(m.any(-1, keepdim=True), m, keep)
        masks.append(torch.where(m.any(-1, keepdim=True), m, mask))
    return torch.stack(masks)


def spc_sampling(xyz: torch.Tensor, mask: torch.Tensor, rois: torch.Tensor,
                 roi_valid: torch.Tensor, cfg: PVRCNNPPConfig) -> torch.Tensor:
    """-> keypoints [B, num_sectors * (num_keypoints // num_sectors), 3]
    (sectorized_proposal_centric_sampling): FPS in each sector of
    :func:`spc_keep`, one launch of the FPS kernel a sector on the card."""
    per = cfg.num_keypoints // cfg.num_sectors
    return torch.cat([point_ops.gather_points(xyz, point_ops.masked_fps(xyz, m, per))
                      for m in spc_keep(xyz, mask, rois, roi_valid, cfg)], 1)


# --- VectorPool aggregation -------------------------------------------------


@torch.no_grad()
def vector_pool_members(ctr: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                        vp: VectorPoolConfig) -> Tuple[torch.Tensor, ...]:
    """The discrete half of the VectorPool of one chunk of centres: ctr
    [B, M, 3], points [B, N, 3], valid [B, N] -> (idx [B, M, S], the first
    S = min(nsample, N) valid points by index inside each centre's cube
    (then the others); keep [B, M, S], the slots inside; sid [B, M, S], each
    slot's sub-voxel)."""
    n = points.shape[1]
    rel_all = points[:, None] - ctr[:, :, None]  # [B, M, N, 3]
    inside = (rel_all.abs().amax(-1) <= vp.radius) & valid[:, None, :]
    del rel_all
    ns = min(vp.nsample, n)
    # in-cube points by ascending index, then the others (keys exact while
    # 2 n < 2**24)
    order = torch.arange(n, dtype=torch.float32, device=points.device)
    idx = torch.topk(torch.where(inside, -order, -(order + n)), ns, dim=-1).indices
    keep = torch.arange(ns, device=points.device) < inside.sum(-1, keepdim=True)
    rel = point_ops.gather_points(points, idx) - ctr[:, :, None, :]
    cell = 2 * vp.radius / vp.nvox
    sub = torch.floor((rel + vp.radius) / cell).long().clamp(0, vp.nvox - 1)
    sid = (sub[..., 0] * vp.nvox + sub[..., 1]) * vp.nvox + sub[..., 2]
    return idx, keep, sid


def vector_pool(centers: torch.Tensor, points: torch.Tensor, feats: torch.Tensor,
                valid: torch.Tensor, vp: VectorPoolConfig, params: Params,
                chunk: int = 512) -> torch.Tensor:
    """'voxel_avg_pool' VectorPool -> [B, M, post]. ``points`` and ``feats``
    are [B, N, .] or one flat list [N, .] for every sample, ``valid`` [B, N]
    saying which points each sample sees; ``chunk`` centres at a time."""
    b, m, _ = centers.shape
    if points.dim() == 2:
        points = points.expand(b, *points.shape)
        feats = feats.expand(b, *feats.shape)
    v = vp.nvox**3
    outs = []
    for c0 in range(0, m, chunk):
        ctr = centers[:, c0:c0 + chunk]
        idx, keep, sid = vector_pool_members(ctr, points, valid, vp)
        rel = point_ops.gather_points(points, idx) - ctr[:, :, None, :]
        h = torch.cat([point_ops.gather_points(feats, idx), rel], -1)  # [B, mc, S, C+3]
        onehot = (sid[..., None] == torch.arange(v, device=sid.device)).to(h.dtype)
        onehot = onehot * keep[..., None].to(h.dtype)  # [B, mc, S, V]
        summed = torch.einsum("bmsv,bmsc->bmvc", onehot, h)
        mean = summed / onehot.sum(2).clamp_min(1.0)[..., None]
        loc = torch.relu(torch.einsum("bmvc,vcd->bmvd", mean, params["local_w"]))
        post = params["post"]
        outs.append(torch.relu(loc.reshape(*loc.shape[:2], -1) @ post["w"] + post["b"]))
    return torch.cat(outs, 1)


# --- the whole model --------------------------------------------------------


def as_voxel_rcnn(cfg: PVRCNNPPConfig) -> vr.VoxelRCNNConfig:
    """The Voxel R-CNN config the proposals and RoI targets run under, as
    the reference builds it: stage 1, the proposal NMS, ``num_rois`` and
    ``fg_per`` from ``cfg``, the other target constants Voxel R-CNN's."""
    return vr.VoxelRCNNConfig(stage1=cfg.stage1, proposal_nms_thresh=cfg.proposal_nms_thresh,
                              proposal_pre=cfg.proposal_pre, num_rois=cfg.num_rois,
                              fg_per=cfg.fg_per)


def _pv_like(cfg: PVRCNNPPConfig) -> pv.PVRCNNConfig:
    """PV-RCNN's config over this stage 1, as the reference's BEV sampling
    and point head read it (only ``stage1`` and ``point_cls_fc`` count)."""
    return pv.PVRCNNConfig(stage1=cfg.stage1, point_cls_fc=cfg.point_cls_fc)


def voxel_set_abstraction(params: Params, points: torch.Tensor, points_mask: torch.Tensor,
                          ms_feats, bev: torch.Tensor, rois: torch.Tensor,
                          roi_valid: torch.Tensor, cfg: PVRCNNPPConfig):
    """Keypoints by SPC sampling around the proposals, their features by
    VectorPool from each source and bilinear from the BEV map -> (keypoints
    [B, K, 3], fused [B, K, out_features], features before fusion)."""
    xyz = points[..., :3]
    keypoints = spc_sampling(xyz, points_mask, rois, roi_valid, cfg)
    feats: List[torch.Tensor] = []
    if cfg.use_bev:
        feats.append(pv.bev_interpolate(bev, keypoints, _pv_like(cfg)))
    b, dev = points.shape[0], points.device
    pcr = torch.tensor(cfg.stage1.pc_range[:3], dtype=points.dtype, device=dev)
    vsz = torch.tensor(cfg.stage1.voxel_size, dtype=points.dtype, device=dev)
    for src, vpc in cfg.vp_layers:
        if src == "raw_points":
            sx, sf, sv = xyz, points[..., 3:4], points_mask
        else:
            st = ms_feats[src]
            sx = (st.coords[:, 1:].flip(-1).to(points.dtype) + 0.5) * (vsz * vpc.stride) + pcr
            sf = st.features
            sv = (st.coords[None, :, 0] == torch.arange(b, device=dev)[:, None]) & st.valid
        feats.append(vector_pool(keypoints, sx, sf, sv, vpc, params[f"vp_{src}"]))
    pre = torch.cat(feats, -1)
    fused = torch.relu(pre @ params["fusion"]["w"] + params["fusion"]["b"])
    return keypoints, fused, pre


def roi_pool(params: Params, rois: torch.Tensor, keypoints: torch.Tensor,
             kp_feats: torch.Tensor, cfg: PVRCNNPPConfig) -> torch.Tensor:
    """Each RoI's G^3 grid VectorPools the weighted keypoints ->
    [B, R, G^3 * roi_vp.post]."""
    b, r, _ = rois.shape
    grid = vr.roi_grid_points(rois, cfg.grid_size).reshape(b, r * cfg.grid_size**3, 3)
    valid = torch.ones(keypoints.shape[:2], dtype=torch.bool, device=keypoints.device)
    return vector_pool(grid, keypoints, kp_feats, valid, cfg.roi_vp, params["roi_vp"]).reshape(
        b, r, -1)


def _rcnn(params, points, points_mask, ms, bev, rois, roi_valid, cfg):
    """The keypoints and their weighted features for ``rois`` -> (keypoints,
    weighted features, point logits, refined (cls, reg))."""
    keypoints, fused, pre = voxel_set_abstraction(params, points, points_mask, ms, bev, rois,
                                                  roi_valid, cfg)
    pt_logits = pv.point_head(params, pre, _pv_like(cfg))
    weighted = fused * torch.sigmoid(pt_logits)[..., None]
    rcnn_cls, rcnn_reg = vr.refine(params, roi_pool(params, rois, keypoints, weighted, cfg), cfg)
    return keypoints, weighted, pt_logits, rcnn_cls, rcnn_reg


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, anchors: torch.Tensor, cfg: PVRCNNPPConfig,
                  points_mask: Optional[torch.Tensor] = None):
    """loss_rpn + loss_point + loss_rcnn, the proposals sampled before the
    keypoints (pv_rcnn_plusplus.forward): the keypoints gather around the
    sampled RoIs, all taken as valid."""
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    vcfg = as_voxel_rcnn(cfg)
    preds, ms, bev = vr.forward_stage1(params, points, vcfg, points_mask)
    rpn_loss, rpn_logs = second.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg.stage1)
    rois, _, roi_valid = vr.propose(vr._detached(preds), anchors, vcfg)
    targets = vr.sample_rois_for_rcnn(rois, roi_valid, gt_boxes, gt_valid, vcfg)
    all_valid = torch.ones(targets["rois"].shape[:2], dtype=torch.bool, device=points.device)
    keypoints, _, pt_logits, rcnn_cls, rcnn_reg = _rcnn(params, points, points_mask, ms, bev,
                                                        targets["rois"], all_valid, cfg)
    pt_t = pv.point_head_targets(keypoints, gt_boxes, gt_valid, cfg.gt_extra_width)
    p = torch.sigmoid(pt_logits)
    pt = p * pt_t + (1 - p) * (1 - pt_t)
    alpha = 0.25 * pt_t + 0.75 * (1 - pt_t)
    point_loss = (-alpha * (1 - pt) ** 2 * torch.log(pt.clamp_min(1e-7))).sum() / (
        pt_t.sum().clamp_min(1.0))
    cls_loss, reg_loss, corner = vr.rcnn_losses(rcnn_cls, rcnn_reg, targets)
    total = (rpn_loss + cfg.point_cls_weight * point_loss + cfg.rcnn_cls_weight * cls_loss
             + cfg.rcnn_reg_weight * reg_loss + cfg.rcnn_corner_weight * corner)
    return total, {**{f"rpn_{k}": v for k, v in rpn_logs.items()}, "point_cls": point_loss,
                   "rcnn_cls": cls_loss, "rcnn_reg": reg_loss, "rcnn_corner": corner}


def predict(params: Params, points: torch.Tensor, anchors: torch.Tensor, cfg: PVRCNNPPConfig,
            score_thr: float = 0.1, iou_thr: float = 0.1, max_out: int = 128,
            points_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Two-stage inference: propose -> SPC keypoints -> VectorPool -> refine
    -> the final NMS; one dict a sample of tensors on the model's device."""
    with torch.no_grad():
        if points_mask is None:
            points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
        vcfg = as_voxel_rcnn(cfg)
        preds, ms, bev = vr.forward_stage1(params, points, vcfg, points_mask)
        rois, _, roi_valid = vr.propose(preds, anchors, vcfg)
        *_, rcnn_cls, rcnn_reg = _rcnn(params, points, points_mask, ms, bev, rois, roi_valid,
                                       cfg)
        return vr.final_nms(vr.decode_refined(rois, rcnn_reg), rcnn_cls, roi_valid, score_thr,
                            iou_thr, max_out)

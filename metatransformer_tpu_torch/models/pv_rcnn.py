"""PV-RCNN: the point-voxel two-stage 3D detector.

Port of ``metatransformer_tpu/models/pv_rcnn.py`` (pcdet's
``detectors/pv_rcnn.py``): SECOND as stage 1, then

- voxel set abstraction: keypoints by furthest-point sampling of the raw
  points (:func:`..ops.point_ops.masked_fps`, the FPS kernel on the card),
  each with features from the BEV map (bilinear), the raw points and every
  sparse stage (ball groups), fused by a linear layer;
- PointHeadSimple: a foreground logit a keypoint, trained on
  point-in-enlarged-box targets and used to weight the keypoints;
- the RoI grid head: a G^3 grid of each RoI ball-groups the weighted
  keypoints (two radii), then shared FCs refine.

The proposal, target and loss machinery is Voxel R-CNN's
(:mod:`.voxel_rcnn`). A ball query is the first ``nsample`` points in the
radius, by index, computed from dense distances in chunks of query points
to bound memory; the in-radius test is on ``|c|^2 - 2 c.p + |p|^2``, as in
the reference, so a point within rounding of the radius can fall either
side. The max-pools are ``amax``, which splits a tie's gradient evenly, as
the reference's ``jnp.max``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, second
from metatransformer_tpu_torch.models import voxel_rcnn as vr
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import point_ops, roi_pool3d
from metatransformer_tpu_torch.ops import sparse_conv as sp

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SALayerConfig:
    radii: Tuple[float, ...] = (0.4, 0.8)  # POOL_RADIUS (MSG groups)
    nsamples: Tuple[int, ...] = (16, 16)
    mlp: int = 16  # each group's output width
    stride: int = 1  # DOWNSAMPLE_FACTOR (voxel sources)


@dataclasses.dataclass(frozen=True)
class PVRCNNConfig:
    stage1: second.SECONDConfig = second.SECONDConfig(bev_channels=(128, 256), up_channels=256)
    num_keypoints: int = 2048
    out_features: int = 128  # NUM_OUTPUT_FEATURES
    # (source, SALayerConfig); "raw_points" is the raw cloud
    sa_layers: Tuple[Tuple[str, SALayerConfig], ...] = (
        ("raw_points", SALayerConfig((0.4, 0.8), (16, 16), 16)),
        ("x_conv1", SALayerConfig((0.4, 0.8), (16, 16), 16, stride=1)),
        ("x_conv2", SALayerConfig((0.8, 1.2), (16, 32), 32, stride=2)),
        ("x_conv3", SALayerConfig((1.2, 2.4), (16, 32), 64, stride=4)),
        ("x_conv4", SALayerConfig((2.4, 4.8), (16, 32), 64, stride=8)),
    )
    use_bev: bool = True
    point_cls_fc: Tuple[int, ...] = (256, 256)
    # the RoI head (PVRCNNHead): grid points ball-query the keypoints
    num_rois: int = 128
    fg_per: int = 64
    grid_size: int = 6
    roi_radii: Tuple[float, ...] = (0.8, 1.6)
    roi_nsamples: Tuple[int, ...] = (16, 16)
    roi_mlp: int = 64
    shared_fc: Tuple[int, ...] = (256, 256)
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    # the target and loss constants (Voxel R-CNN's values)
    reg_fg_thresh: float = 0.55
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    rcnn_cls_weight: float = 1.0
    rcnn_reg_weight: float = 1.0
    rcnn_corner_weight: float = 1.0
    point_cls_weight: float = 1.0
    proposal_nms_thresh: float = 0.8
    proposal_pre: int = 1024
    gt_extra_width: float = 0.2  # the point head's target enlargement
    # PVRCNNHeadMoE: one gated residual expert a source dataset on the
    # shared RoI features, chosen by the batch's source tag. 0: off.
    moe_sources: int = 0

    def source_channels(self, src: str) -> int:
        w = self.stage1.widths
        return {"raw_points": 1,  # intensity
                "x_conv1": w[1], "x_conv2": w[2], "x_conv3": w[3], "x_conv4": w[4]}[src]

    @property
    def bev_channels_out(self) -> int:
        return self.stage1.up_channels * len(self.stage1.bev_channels)

    @property
    def vsa_channels(self) -> int:
        c = sum(s.mlp * len(s.radii) for _, s in self.sa_layers)
        return c + (self.bev_channels_out if self.use_bev else 0)


def init(cfg: PVRCNNConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    params: Params = {"stage1": second.init_cpu(cfg.stage1, generator)}
    randn = detector3d._randn(generator)
    lin = vr._lin_init
    for src, sa in cfg.sa_layers:
        cin = cfg.source_channels(src)
        for gi in range(len(sa.radii)):  # MSG groups: a 2-layer MLP each
            params[f"sa_{src}_{gi}_a"] = lin(randn, cin + 3, sa.mlp)
            params[f"sa_{src}_{gi}_b"] = lin(randn, sa.mlp, sa.mlp)
    params["fusion"] = lin(randn, cfg.vsa_channels, cfg.out_features)
    # PointHeadSimple on the features before fusion, 1 logit
    c = vr._fc_stack(randn, params, "pt", cfg.vsa_channels, cfg.point_cls_fc)
    params["pt_pred"] = lin(randn, c, 1, std=0.01)
    for gi in range(len(cfg.roi_radii)):
        params[f"roi_{gi}_a"] = lin(randn, cfg.out_features + 3, cfg.roi_mlp)
        params[f"roi_{gi}_b"] = lin(randn, cfg.roi_mlp, cfg.roi_mlp)
    cin = cfg.grid_size**3 * cfg.roi_mlp * len(cfg.roi_radii)
    c0 = vr._fc_stack(randn, params, "shared", cin, cfg.shared_fc)
    if cfg.moe_sources:
        # stacked per-source gates, gathered by the source tag
        params["moe_gate"] = {
            "w": randn(cfg.moe_sources, c0, c0) * np.sqrt(2.0 / c0),
            "bn_scale": torch.ones(cfg.moe_sources, c0),
            "bn_bias": torch.zeros(cfg.moe_sources, c0),
        }
    params["cls_pred"] = lin(randn, vr._fc_stack(randn, params, "cls", c0, cfg.cls_fc), 1,
                             std=0.01)
    params["reg_pred"] = lin(randn, vr._fc_stack(randn, params, "reg", c0, cfg.reg_fc), 7,
                             std=0.001)
    return _to(params, device)


# --- grouping ---------------------------------------------------------------


@torch.no_grad()
def ball_members(centers: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                 radius: float, nsample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``nsample`` valid points within ``radius`` of each centre,
    by index: centers [B, M, 3], points [B, N, 3], valid [B, N] -> (idx
    [B, M, nsample], keep [B, M, nsample]); slots past a centre's count
    hold out-of-radius indices and keep False."""
    n = points.shape[1]
    d2 = ((centers**2).sum(-1)[:, :, None] - 2 * torch.einsum("bmc,bnc->bmn", centers, points)
          + (points**2).sum(-1)[:, None, :])
    d2 = torch.where(valid[:, None, :], d2, float("inf"))
    inside = d2 < radius * radius
    # in-radius points by ascending index, then the others (keys exact
    # while 2 n < 2**24)
    order = torch.arange(n, dtype=torch.float32, device=points.device)
    idx = torch.topk(torch.where(inside, -order, -(order + n)), nsample, dim=-1).indices
    slot = torch.arange(nsample, device=points.device)
    return idx, slot < inside.sum(-1, keepdim=True)


def ball_group(centers: torch.Tensor, points: torch.Tensor, feats: Optional[torch.Tensor],
               valid: torch.Tensor, radius: float, nsample: int,
               mlp: Callable[[torch.Tensor], torch.Tensor], chunk: int = 512) -> torch.Tensor:
    """Ball query + ``mlp`` on (rel_xyz ++ feature) + a masked max-pool ->
    [B, M, C_out]; an empty ball gives zeros. ``points`` and ``feats`` are
    [B, N, .] or one flat list [N, .] for every sample, with ``valid``
    [B, N] saying which points each sample sees; ``feats`` may be None. The
    distances are computed ``chunk`` query points at a time."""
    b, m, _ = centers.shape
    if points.dim() == 2:
        points = points.expand(b, *points.shape)
        feats = None if feats is None else feats.expand(b, *feats.shape)
    outs = []
    for c0 in range(0, m, chunk):
        ctr = centers[:, c0:c0 + chunk]
        idx, keep = ball_members(ctr, points, valid, radius, nsample)
        # empty slots read a row of their own (masked below): no long run of
        # one index in the gradient's scatter (see sparse_conv.gather_rows)
        own = torch.arange(idx[0].numel(), device=idx.device).view(idx.shape[1:])
        idx = torch.where(keep, idx, own % points.shape[1])
        h = point_ops.gather_points(points, idx) - ctr[:, :, None, :]
        if feats is not None:
            h = torch.cat([h, point_ops.gather_points(feats, idx)], -1)
        out = torch.where(keep[..., None], mlp(h), float("-inf")).amax(2)
        outs.append(torch.where(torch.isfinite(out), out, 0.0))
    return torch.cat(outs, 1)


def ball_group_max(centers: torch.Tensor, points: torch.Tensor, feats: torch.Tensor,
                   valid: torch.Tensor, radius: float, nsample: int, mlp_a: Params,
                   mlp_b: Params, chunk: int = 512) -> torch.Tensor:
    """:func:`ball_group` with a 2-layer MLP (pointnet2_stack
    StackSAModuleMSG) -> [B, M, mlp]."""
    def mlp(h):
        h = torch.relu(h @ mlp_a["w"] + mlp_a["b"])
        return torch.relu(h @ mlp_b["w"] + mlp_b["b"])

    return ball_group(centers, points, feats, valid, radius, nsample, mlp, chunk)


def bev_interpolate(feat: torch.Tensor, keypoints: torch.Tensor, cfg: PVRCNNConfig) -> torch.Tensor:
    """Bilinear BEV features at the keypoints' (x, y)
    (voxel_set_abstraction.interpolate_from_bev_features). feat [B, H, W, C]."""
    s1 = cfg.stage1
    stride = s1.spatial_shape[2] // feat.shape[2]  # voxel grid -> BEV
    x = (keypoints[..., 0] - s1.pc_range[0]) / s1.voxel_size[0] / stride
    y = (keypoints[..., 1] - s1.pc_range[1]) / s1.voxel_size[1] / stride
    h, w = feat.shape[1:3]
    x0 = torch.floor(x).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    flat = feat.reshape(feat.shape[0], h * w, -1)

    def at(yy, xx):
        return detector3d._gather_rows(flat, yy * w + xx)

    x0f, x1f, y0f, y1f = x0.float(), x1.float(), y0.float(), y1.float()
    wa, wb = (x1f - x) * (y1f - y), (x1f - x) * (y - y0f)
    wc, wd = (x - x0f) * (y1f - y), (x - x0f) * (y - y0f)
    return (at(y0, x0) * wa[..., None] + at(y1, x0) * wb[..., None]
            + at(y0, x1) * wc[..., None] + at(y1, x1) * wd[..., None])


# --- voxel set abstraction --------------------------------------------------


def keypoints_of(points: torch.Tensor, points_mask: torch.Tensor, n: int) -> torch.Tensor:
    """FPS keypoints of the raw clouds (get_sampled_points; padding
    collapsed onto the first valid point) -> [B, n, 3]. One launch of the
    FPS kernel on the card."""
    xyz = points[..., :3]
    return point_ops.gather_points(xyz, point_ops.masked_fps(xyz, points_mask, n))


def voxel_set_abstraction(params: Params, points: torch.Tensor, points_mask: torch.Tensor,
                          ms_feats: Dict[str, sp.SparseTensor], bev_feat: torch.Tensor,
                          cfg: PVRCNNConfig):
    """-> (keypoints [B, K, 3], fused features [B, K, out], features before
    fusion [B, K, vsa_channels])."""
    b = points.shape[0]
    keypoints = keypoints_of(points, points_mask, cfg.num_keypoints)
    feats_list: List[torch.Tensor] = []
    if cfg.use_bev:
        feats_list.append(bev_interpolate(bev_feat, keypoints, cfg))
    dev = points.device
    pcr = torch.tensor(cfg.stage1.pc_range[:3], dtype=torch.float32, device=dev)
    vsz = torch.tensor(cfg.stage1.voxel_size, dtype=torch.float32, device=dev)
    for src, sa in cfg.sa_layers:
        if src == "raw_points":
            src_xyz, src_feat, src_valid = points[..., :3], points[..., 3:4], points_mask
        else:
            st = ms_feats[src]
            zyx = st.coords[:, 1:].float()
            src_xyz = (zyx.flip(-1) + 0.5) * (vsz * sa.stride) + pcr
            src_feat = st.features
            src_valid = (st.coords[None, :, 0] == torch.arange(b, device=dev)[:, None]) & st.valid
        for gi, (r, ns) in enumerate(zip(sa.radii, sa.nsamples)):
            feats_list.append(ball_group_max(keypoints, src_xyz, src_feat, src_valid, r, ns,
                                             params[f"sa_{src}_{gi}_a"],
                                             params[f"sa_{src}_{gi}_b"]))
    pre_fusion = torch.cat(feats_list, -1)
    fused = torch.relu(pre_fusion @ params["fusion"]["w"] + params["fusion"]["b"])
    return keypoints, fused, pre_fusion


def point_head(params: Params, pre_fusion: torch.Tensor, cfg: PVRCNNConfig) -> torch.Tensor:
    """The foreground logit of each keypoint (PointHeadSimple) -> [B, K]."""
    h = vr._mlp(pre_fusion, params, [f"pt{i}" for i in range(len(cfg.point_cls_fc))])
    return (h @ params["pt_pred"]["w"] + params["pt_pred"]["b"])[..., 0]


@torch.no_grad()
def point_head_targets(keypoints: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                       extra: float) -> torch.Tensor:
    """1 where a keypoint lies in an enlarged valid ground truth -> [B, K]
    (point_head_template.assign_stack_targets, GT_EXTRA_WIDTH)."""
    grown = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6] + 2 * extra, gt_boxes[..., 6:]], -1)
    inside = roi_pool3d.points_in_boxes(keypoints, grown) & gt_valid[:, :, None]
    return inside.any(1).float()


# --- the RoI head (PVRCNNHead) ----------------------------------------------


def roi_grid_pool_keypoints(params: Params, rois: torch.Tensor, keypoints: torch.Tensor,
                            kp_features: torch.Tensor, cfg: PVRCNNConfig) -> torch.Tensor:
    """Each RoI's G^3 grid points ball-query the weighted keypoints (MSG)
    -> [B, R, G^3 * mlp * n_radii] (pvrcnn_head.roi_grid_pool)."""
    b, r, _ = rois.shape
    grid = vr.roi_grid_points(rois, cfg.grid_size).reshape(b, r * cfg.grid_size**3, 3)
    valid = torch.ones(keypoints.shape[:2], dtype=torch.bool, device=keypoints.device)
    groups = [ball_group_max(grid, keypoints, kp_features, valid, rad, ns,
                             params[f"roi_{gi}_a"], params[f"roi_{gi}_b"])
              for gi, (rad, ns) in enumerate(zip(cfg.roi_radii, cfg.roi_nsamples))]
    return torch.cat(groups, -1).reshape(b, r, -1)


def refine(params: Params, pooled: torch.Tensor, cfg: PVRCNNConfig, source_id=None):
    """pooled [B, R, C] -> (rcnn_cls [B, R], rcnn_reg [B, R, 7]); with
    ``moe_sources`` and a ``source_id``, the source's gate adds
    relu(bn(x W)) * x to the shared features (pvrcnn_head_MoE)."""
    b, r, _ = pooled.shape
    x = vr._mlp(pooled.reshape(b * r, -1), params,
                [f"shared{i}" for i in range(len(cfg.shared_fc))])
    if cfg.moe_sources and source_id is not None:
        g = params["moe_gate"]
        h = x @ g["w"][source_id]
        var, mean = torch.var_mean(h, dim=0, keepdim=True, correction=0)
        h = (h - mean) * torch.rsqrt(var + 1e-3) * g["bn_scale"][source_id] + g["bn_bias"][source_id]
        x = x + torch.relu(h) * x
    cls, reg = vr.heads(params, x, cfg)
    return cls.reshape(b, r), reg.reshape(b, r, 7)


# --- the whole model --------------------------------------------------------


def as_voxel_rcnn(cfg: PVRCNNConfig) -> vr.VoxelRCNNConfig:
    """The Voxel R-CNN config the proposals and RoI targets run under, as
    the reference builds it: stage 1, the proposal NMS and ``num_rois``
    from ``cfg``, every other target constant (``fg_per`` among them) at
    Voxel R-CNN's defaults."""
    return vr.VoxelRCNNConfig(stage1=cfg.stage1, proposal_nms_thresh=cfg.proposal_nms_thresh,
                              proposal_pre=cfg.proposal_pre, num_rois=cfg.num_rois)


def forward(params: Params, points: torch.Tensor, cfg: PVRCNNConfig,
            points_mask: Optional[torch.Tensor] = None):
    """-> (stage-1 predictions, keypoints, weighted keypoint features,
    point logits)."""
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    preds, ms, bev = vr.forward_stage1(params, points, cfg, points_mask)
    keypoints, fused, pre = voxel_set_abstraction(params, points, points_mask, ms, bev, cfg)
    pt_logits = point_head(params, pre, cfg)
    # Predicted Keypoint Weighting (pvrcnn_head: point_cls_scores)
    return preds, keypoints, fused * torch.sigmoid(pt_logits)[..., None], pt_logits


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, anchors: torch.Tensor, cfg: PVRCNNConfig,
                  points_mask: Optional[torch.Tensor] = None, source_id=None):
    """loss_rpn + loss_point + loss_rcnn (pv_rcnn.get_training_loss)."""
    preds, keypoints, weighted, pt_logits = forward(params, points, cfg, points_mask)
    rpn_loss, rpn_logs = second.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg.stage1)
    # the point segmentation loss: focal BCE on the keypoints' targets
    pt_t = point_head_targets(keypoints, gt_boxes, gt_valid, cfg.gt_extra_width)
    p = torch.sigmoid(pt_logits)
    pt = p * pt_t + (1 - p) * (1 - pt_t)
    alpha_t = 0.25 * pt_t + 0.75 * (1 - pt_t)
    point_loss = (alpha_t * (1 - pt) ** 2 * -torch.log(pt.clamp_min(1e-7))).sum() / (
        pt_t.sum().clamp_min(1.0))
    vcfg = as_voxel_rcnn(cfg)
    rois, _, roi_valid = vr.propose(vr._detached(preds), anchors, vcfg)
    targets = vr.sample_rois_for_rcnn(rois, roi_valid, gt_boxes, gt_valid, vcfg)
    pooled = roi_grid_pool_keypoints(params, targets["rois"], keypoints, weighted, cfg)
    rcnn_cls, rcnn_reg = refine(params, pooled, cfg, source_id=source_id)
    cls_loss, reg_loss, corner = vr.rcnn_losses(rcnn_cls, rcnn_reg, targets)
    total = (rpn_loss + cfg.point_cls_weight * point_loss + cfg.rcnn_cls_weight * cls_loss
             + cfg.rcnn_reg_weight * reg_loss + cfg.rcnn_corner_weight * corner)
    return total, {**{f"rpn_{k}": v for k, v in rpn_logs.items()}, "point_cls": point_loss,
                   "rcnn_cls": cls_loss, "rcnn_reg": reg_loss, "rcnn_corner": corner}


def predict(params: Params, points: torch.Tensor, anchors: torch.Tensor, cfg: PVRCNNConfig,
            score_thr: float = 0.1, iou_thr: float = 0.1, max_out: int = 128,
            points_mask: Optional[torch.Tensor] = None,
            source_id=None) -> List[Dict[str, torch.Tensor]]:
    """Two-stage inference over the keypoint features; one dict a sample
    of tensors on the model's device."""
    with torch.no_grad():
        preds, keypoints, weighted, _ = forward(params, points, cfg, points_mask)
        rois, _, roi_valid = vr.propose(preds, anchors, as_voxel_rcnn(cfg))
        pooled = roi_grid_pool_keypoints(params, rois, keypoints, weighted, cfg)
        rcnn_cls, rcnn_reg = refine(params, pooled, cfg, source_id=source_id)
        return vr.final_nms(vr.decode_refined(rois, rcnn_reg), rcnn_cls, roi_valid, score_thr,
                            iou_thr, max_out)

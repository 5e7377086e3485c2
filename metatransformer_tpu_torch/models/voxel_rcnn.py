"""Voxel R-CNN: the two-stage sparse-voxel 3D detector (SECOND + RoI
refinement).

Port of ``metatransformer_tpu/models/voxel_rcnn.py`` (pcdet's
``detectors/voxel_rcnn.py`` with ``roi_heads/voxelrcnn_head.py``): stage 1
is SECOND; stage 2 takes the anchor head's proposals (top-k + rotated NMS),
pools a G^3 grid of each RoI from the backbone's multi-scale sparse
features, and refines class and box through shared FCs. The proposal,
target and loss machinery here is shared by the later two-stage detectors.

As in the reference:

- the RoI grid pool replaces pcdet's random ball query with a fixed
  *offset template* (the in-ball integer voxel offsets sorted by distance,
  strided down to ``nsample``) looked up in the sparse voxel list, and
  max-pools by a loop over the offsets, so peak memory is one
  ``[B*R*G^3, C+3]`` slab. The running max is ``torch.maximum`` one offset
  at a time, which splits a tie's gradient as the reference's scan of
  ``jnp.maximum`` does;
- proposal subsampling is rank-based, not random: the top ``fg_per``
  foregrounds by IoU, then hard backgrounds before easy ones;
- the roi_iou soft class labels are clamp((iou - bg) / (fg - bg), 0, 1).

The discrete choices (:func:`.detector3d.top_scores`, :func:`..ops.iou3d.nms_bev`,
:func:`sample_rois` and the grid pool's :func:`pool_members`) take no
gradient, so a caller can record them from one run and replay them in
another.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, second
from metatransformer_tpu_torch.models.detector3d import _gather_rows, decode_boxes, encode_boxes
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import iou3d
from metatransformer_tpu_torch.ops import sparse_conv as sp

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PoolLayerConfig:
    stride: int
    radius: float  # metres (POOL_RADIUS)
    nsample: int = 16
    mlp: int = 32


@dataclasses.dataclass(frozen=True)
class VoxelRCNNConfig:
    stage1: second.SECONDConfig = second.SECONDConfig(bev_channels=(64, 128), up_channels=128)
    num_rois: int = 128  # ROI_PER_IMAGE (train) / the NMS_POST cap (test)
    fg_per: int = 64  # ROI_PER_IMAGE * FG_RATIO
    grid_size: int = 6
    # (source name, PoolLayerConfig) in FEATURES_SOURCE order
    pool_layers: Tuple[Tuple[str, PoolLayerConfig], ...] = (
        ("x_conv2", PoolLayerConfig(2, 0.4)),
        ("x_conv3", PoolLayerConfig(4, 0.8)),
        ("x_conv4", PoolLayerConfig(8, 1.6)),
    )
    shared_fc: Tuple[int, ...] = (256, 256)
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    # TARGET_CONFIG
    reg_fg_thresh: float = 0.55
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    # LOSS_CONFIG
    rcnn_cls_weight: float = 1.0
    rcnn_reg_weight: float = 1.0
    rcnn_corner_weight: float = 1.0
    # proposal NMS
    proposal_nms_thresh: float = 0.8
    proposal_pre: int = 1024

    @property
    def pooled_channels(self) -> int:
        return sum(p.mlp for _, p in self.pool_layers)

    def source_channels(self, src: str) -> int:
        w = self.stage1.widths
        return {"x_conv2": w[2], "x_conv3": w[3], "x_conv4": w[4]}[src]


def _lin_init(randn, cin, cout, std=None):
    scale = std if std is not None else np.sqrt(2.0 / cin)
    return {"w": randn(cin, cout) * scale, "b": torch.zeros(cout)}


def _fc_stack(randn, params, prefix, cin, widths):
    for i, c in enumerate(widths):
        params[f"{prefix}{i}"] = _lin_init(randn, cin, c)
        cin = c
    return cin


def _refine_init(randn, params, cin, cfg) -> None:
    """shared FCs, then the class and box branches on their output."""
    c0 = _fc_stack(randn, params, "shared", cin, cfg.shared_fc)
    params["cls_pred"] = _lin_init(randn, _fc_stack(randn, params, "cls", c0, cfg.cls_fc), 1,
                                   std=0.01)
    params["reg_pred"] = _lin_init(randn, _fc_stack(randn, params, "reg", c0, cfg.reg_fc), 7,
                                   std=0.001)


def init(cfg: VoxelRCNNConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    params: Params = {"stage1": second.init_cpu(cfg.stage1, generator)}
    randn = detector3d._randn(generator)
    for src, pl in cfg.pool_layers:
        params[f"pre_{src}"] = _lin_init(randn, cfg.source_channels(src), pl.mlp)
        # the post-grouping MLP over (feature, rel_xyz)
        params[f"agg_{src}"] = _lin_init(randn, pl.mlp + 3, pl.mlp)
    _refine_init(randn, params, cfg.grid_size**3 * cfg.pooled_channels, cfg)
    return _to(params, device)


# --- geometry ---------------------------------------------------------------


def rotate_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] points rotated about z by the [...]-broadcast angle
    (common_utils.rotate_points_along_z: x -> y positive)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return torch.cat([x * c - y * s, x * s + y * c, z.expand_as(x * c)], -1)


def roi_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """[..., R, 7] RoIs -> [..., R, G^3, 3] global grid points
    (voxelrcnn_head.get_global_grid_points_of_roi); grid index order
    (x, y, z), the last fastest."""
    g = grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij"),
                   -1).reshape(-1, 3)
    idx = torch.as_tensor(idx, dtype=torch.float32, device=rois.device)
    dims = rois[..., None, 3:6]
    local = (idx + 0.5) / g * dims - dims / 2
    return rotate_z(local, rois[..., None, 6]) + rois[..., None, 0:3]


def _offset_template(radius_vox: float, nsample: int) -> np.ndarray:
    """The fixed stand-in for random ball-query sampling: every integer
    offset with |o| <= radius sorted by distance, strided down to nsample
    (the centre first, spread over the shells)."""
    r = int(np.ceil(radius_vox))
    g = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"), -1).reshape(-1, 3)
    d = np.linalg.norm(g, axis=1)
    g = g[d <= max(radius_vox, 1.0)]
    d = np.linalg.norm(g, axis=1)
    g = g[np.argsort(d, kind="stable")]
    if len(g) <= nsample:
        return g.astype(np.int64)
    pick = np.linspace(0, len(g) - 1, nsample).round().astype(int)
    return g[pick].astype(np.int64)


# --- RoI grid pooling -------------------------------------------------------


def _neighbour_rel(nb_zyx: torch.Tensor, grid: torch.Tensor, scale: torch.Tensor,
                   pcr: torch.Tensor) -> torch.Tensor:
    """The centre of the voxel at ``nb_zyx`` (get_voxel_centers) relative to
    each grid point: [Q, 3]."""
    return (nb_zyx.flip(-1).float() + 0.5) * scale + pcr - grid


def _pool_scale(pl: PoolLayerConfig, cfg: VoxelRCNNConfig, dev):
    """(pc_range's origin, the voxel size at this scale) as [3] tensors."""
    pcr = torch.tensor(cfg.stage1.pc_range[:3], dtype=torch.float32, device=dev)
    scale = torch.tensor(cfg.stage1.voxel_size, dtype=torch.float32, device=dev) * pl.stride
    return pcr, scale


@torch.no_grad()
def pool_members(grid: torch.Tensor, st: sp.SparseTensor, pl: PoolLayerConfig,
                 cfg: VoxelRCNNConfig, rois_per_sample: int):
    """The discrete half of the grid pool at one scale: grid [Q, 3] global
    points, ``rois_per_sample * G^3`` of them a sample -> (q_zyx [Q, 3], each
    point's voxel at this scale; tmpl [K, 3], the offset template; src
    [K, Q], the row of the voxel at each template offset; keep [K, Q], found
    and inside the pool radius)."""
    dev = grid.device
    pcr, scale = _pool_scale(pl, cfg, dev)
    q_zyx = torch.floor((grid - pcr) / scale).long().flip(-1)  # (x, y, z) -> (z, y, x)
    bidx = torch.arange(grid.shape[0], device=dev)[:, None] // rois_per_sample
    sorted_keys, order = sp.build_lookup(st)
    always = torch.ones(grid.shape[0], dtype=torch.bool, device=dev)
    tmpl = torch.as_tensor(
        _offset_template(pl.radius / float(cfg.stage1.voxel_size[0]) / pl.stride, pl.nsample),
        device=dev)
    src, keep = [], []
    for off in tmpl:
        nb_zyx = q_zyx + off
        idx, found = sp.lookup(sorted_keys, order,
                               sp._linearize(torch.cat([bidx, nb_zyx], -1), always,
                                             st.spatial_shape))
        src.append(idx)
        keep.append(found & (_neighbour_rel(nb_zyx, grid, scale, pcr).square().sum(-1)
                             <= pl.radius**2))
    return q_zyx, tmpl, torch.stack(src), torch.stack(keep)


def roi_grid_pool(params: Params, ms_feats: Dict[str, sp.SparseTensor], rois: torch.Tensor,
                  cfg: VoxelRCNNConfig) -> torch.Tensor:
    """-> [B, R, G^3 * sum(mlps)] pooled features (voxelrcnn_head.roi_grid_pool)."""
    b, r, _ = rois.shape
    g3 = cfg.grid_size**3
    grid = roi_grid_points(rois, cfg.grid_size).reshape(b * r * g3, 3)  # global xyz
    pooled = []
    for src, pl in cfg.pool_layers:
        st = ms_feats[src]
        pre, agg = params[f"pre_{src}"], params[f"agg_{src}"]
        feats = torch.relu(st.features @ pre["w"] + pre["b"]) * st.valid[:, None].float()
        q_zyx, tmpl, members, keep = pool_members(grid, st, pl, cfg, r * g3)
        pcr, scale = _pool_scale(pl, cfg, rois.device)
        acc = grid.new_full((grid.shape[0], pl.mlp), float("-inf"))
        for k, off in enumerate(tmpl):  # a loop over the template, as the reference's scan
            rel = _neighbour_rel(q_zyx + off, grid, scale, pcr)
            h = torch.cat([sp.gather_rows(feats, members[k], keep[k]), rel], -1)
            h = torch.relu(h @ agg["w"] + agg["b"])
            acc = torch.maximum(acc, torch.where(keep[k][:, None], h, float("-inf")))
        acc = torch.where(torch.isfinite(acc), acc, 0.0)  # empty neighbourhoods
        pooled.append(acc.reshape(b, r, g3, pl.mlp))
    return torch.cat(pooled, -1).reshape(b, r, -1)


# --- proposals --------------------------------------------------------------


def propose(preds: Dict[str, torch.Tensor], anchors: torch.Tensor, cfg):
    """Stage-1 outputs -> (rois [B, R, 7], roi_scores [B, R], roi_valid
    [B, R]) by top-k and rotated NMS over the whole batch at once
    (roi_head_template.proposal_layer). Carries no gradient."""
    with torch.no_grad():
        s_all = torch.sigmoid(preds["cls_logits"]).amax(-1)  # [B, A]
        top = detector3d.top_scores(s_all, min(cfg.proposal_pre, s_all.shape[1]))
        top_s = s_all.gather(1, top)
        boxes = decode_boxes(_gather_rows(preds["box_deltas"], top), anchors[top])
        sel, valid = iou3d.nms_bev(boxes, top_s, cfg.proposal_nms_thresh, cfg.num_rois)
        return _gather_rows(boxes, sel), top_s.gather(1, sel), valid


# --- the proposal target layer ----------------------------------------------


@torch.no_grad()
def sample_rois(iou: torch.Tensor, roi_valid: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """The rank-based subsampling of proposal_target_layer: iou [B, R0, G]
    (-1 where a proposal or ground truth is padding) -> (sel [B, num_rois],
    max_iou [B, R0], gt_idx [B, R0]). Foregrounds (IoU >= reg_fg_thresh)
    are capped at ``fg_per`` by IoU rank; then hard backgrounds (IoU >=
    cls_bg_thresh_lo) come before easy ones; over-cap foregrounds and
    padding come last. Ranks are stable sorts, ties to the lower index."""
    r0 = iou.shape[1]
    max_iou = iou.amax(-1).clamp_min(0.0)
    gt_idx = iou.argmax(-1)
    fg = max_iou >= cfg.reg_fg_thresh
    hard = (max_iou >= cfg.cls_bg_thresh_lo) & ~fg
    fg_score = torch.where(fg, max_iou, float("-inf"))
    by_rank = torch.sort(-fg_score, dim=-1, stable=True).indices
    fg_rank = torch.empty_like(by_rank).scatter_(
        1, by_rank, torch.arange(r0, device=iou.device).expand_as(by_rank))
    keep_fg = fg & (fg_rank < cfg.fg_per)
    sel_score = torch.where(keep_fg, 2e6 + max_iou, torch.where(
        fg, float("-inf"), torch.where(hard, 1e6 + max_iou, max_iou)))
    sel_score = torch.where(roi_valid, sel_score, float("-inf"))
    sel = torch.sort(sel_score, dim=-1, descending=True, stable=True).indices[:, :cfg.num_rois]
    return sel, max_iou, gt_idx


def sample_rois_for_rcnn(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_valid: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """Proposals [B, R0, 7] -> the sampled RoIs and their targets
    (proposal_target_layer.sample_rois_for_rcnn, rank-based), batched."""
    with torch.no_grad():
        iou = iou3d.boxes_iou3d(rois, gt_boxes)  # [B, R0, G]
        iou = torch.where(gt_valid[:, None, :] & roi_valid[:, :, None], iou, -1.0)
        sel, max_iou, gt_idx = sample_rois(iou, roi_valid, cfg)
        s_rois = _gather_rows(rois, sel)
        s_iou = max_iou.gather(1, sel)
        s_gt = _gather_rows(gt_boxes, gt_idx.gather(1, sel))
        # roi_iou soft labels (CLS_SCORE_TYPE roi_iou)
        cls_label = ((s_iou - cfg.cls_bg_thresh) / (cfg.cls_fg_thresh - cfg.cls_bg_thresh)
                     ).clamp(0.0, 1.0)
        # the canonical transform (roi_head_template.assign_targets)
        roi_ry = s_rois[..., 6] % (2 * np.pi)
        local_xyz = rotate_z(s_gt[..., 0:3] - s_rois[..., 0:3], -roi_ry)
        heading = (s_gt[..., 6] - roi_ry) % (2 * np.pi)
        opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
        heading = torch.where(opposite, (heading + np.pi) % (2 * np.pi), heading)
        heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
        heading = heading.clamp(-np.pi / 2, np.pi / 2)
        gt_ct = torch.cat([local_xyz, s_gt[..., 3:6], heading[..., None]], -1)
    return {"rois": s_rois, "gt_of_rois": gt_ct, "gt_src": s_gt, "cls_labels": cls_label,
            "reg_valid": s_iou >= cfg.reg_fg_thresh}


# --- the refinement head ----------------------------------------------------


def _mlp(x, params, names):
    for n in names:
        x = torch.relu(x @ params[n]["w"] + params[n]["b"])
    return x


def heads(params: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The class and box branches on the shared features [N, C] -> (cls [N],
    reg [N, 7])."""
    hc = _mlp(x, params, [f"cls{i}" for i in range(len(cfg.cls_fc))])
    cls = (hc @ params["cls_pred"]["w"] + params["cls_pred"]["b"])[:, 0]
    hr = _mlp(x, params, [f"reg{i}" for i in range(len(cfg.reg_fc))])
    return cls, hr @ params["reg_pred"]["w"] + params["reg_pred"]["b"]


def refine(params: Params, pooled: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """pooled [B, R, G^3*C] -> (rcnn_cls [B, R], rcnn_reg [B, R, 7])."""
    b, r, _ = pooled.shape
    x = _mlp(pooled.reshape(b * r, -1), params, [f"shared{i}" for i in range(len(cfg.shared_fc))])
    cls, reg = heads(params, x, cfg)
    return cls.reshape(b, r), reg.reshape(b, r, 7)


def _local_anchor(rois: torch.Tensor) -> torch.Tensor:
    """The RoI as its own anchor at the origin with heading 0."""
    zeros = torch.zeros_like(rois[..., 0:3])
    return torch.cat([zeros, rois[..., 3:6], zeros[..., :1]], -1)


def decode_refined(rois: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """rcnn_reg deltas -> global refined boxes
    (roi_head_template.generate_predicted_boxes)."""
    local = decode_boxes(reg, _local_anchor(rois))
    xyz = rotate_z(local[..., 0:3], rois[..., 6])
    return torch.cat([xyz + rois[..., 0:3], local[..., 3:6], local[..., 6:7] + rois[..., 6:7]], -1)


# --- the corner loss --------------------------------------------------------


_CORNERS = np.array([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32) / 2.0


def box_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 8, 3] box corners (box_utils.boxes_to_corners_3d)."""
    template = torch.as_tensor(_CORNERS, device=boxes.device)
    corners = rotate_z(boxes[..., None, 3:6] * template, boxes[..., None, 6])
    return corners + boxes[..., None, 0:3]


def corner_loss(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Huber corner distance with the heading-flip min
    (loss_utils.get_corner_loss_lidar) -> [...]."""
    pc, gc = box_corners_3d(pred_boxes), box_corners_3d(gt_boxes)
    gcf = box_corners_3d(torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:7] + np.pi], -1))
    d = torch.minimum(torch.linalg.vector_norm(pc - gc, dim=-1),
                      torch.linalg.vector_norm(pc - gcf, dim=-1))
    return torch.where(d < 1.0, 0.5 * d**2, d - 0.5).mean(-1)


def rcnn_losses(rcnn_cls, rcnn_reg, targets) -> Tuple[torch.Tensor, ...]:
    """(BCE on the soft IoU labels, smooth-L1 on the canonical residuals of
    the foregrounds, the corner loss of the refined foregrounds)."""
    p = torch.sigmoid(rcnn_cls).clamp(1e-7, 1 - 1e-7)
    t = targets["cls_labels"]
    cls_loss = (-(t * torch.log(p) + (1 - t) * torch.log(1 - p))).mean()
    reg_targets = encode_boxes(targets["gt_of_rois"], _local_anchor(targets["rois"]))
    fg = targets["reg_valid"].float()
    n_fg = fg.sum().clamp_min(1.0)
    reg_loss = (detector3d.smooth_l1(rcnn_reg - reg_targets) * fg[..., None]).sum() / n_fg
    refined = decode_refined(targets["rois"], rcnn_reg)
    corner = (corner_loss(refined, targets["gt_src"]) * fg).sum() / n_fg
    return cls_loss, reg_loss, corner


# --- the whole model --------------------------------------------------------


def forward_stage1(params: Params, points: torch.Tensor, cfg,
                   points_mask: Optional[torch.Tensor] = None):
    """points -> (the anchor head's predictions, the multi-scale sparse
    features, the BEV feature map [B, H, W, C])."""
    s1 = cfg.stage1
    st, ms = second.voxel_backbone_8x_ms(params["stage1"], second.voxelize(points, s1, points_mask))
    feat = detector3d.bev_backbone(params["stage1"], second.height_compression(st), s1)
    return detector3d.anchor_head(params["stage1"], feat, s1), ms, feat


def _detached(preds):
    return {k: v.detach() for k, v in preds.items()}


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, anchors: torch.Tensor, cfg: VoxelRCNNConfig,
                  points_mask: Optional[torch.Tensor] = None):
    """The joint stage-1 (anchor) and stage-2 (R-CNN) objective
    (detectors/voxel_rcnn.py get_training_loss: loss_rpn + loss_rcnn)."""
    preds, ms, _ = forward_stage1(params, points, cfg, points_mask)
    rpn_loss, rpn_logs = second.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg.stage1)
    rois, _, roi_valid = propose(_detached(preds), anchors, cfg)
    targets = sample_rois_for_rcnn(rois, roi_valid, gt_boxes, gt_valid, cfg)
    rcnn_cls, rcnn_reg = refine(params, roi_grid_pool(params, ms, targets["rois"], cfg), cfg)
    cls_loss, reg_loss, corner = rcnn_losses(rcnn_cls, rcnn_reg, targets)
    total = (rpn_loss + cfg.rcnn_cls_weight * cls_loss + cfg.rcnn_reg_weight * reg_loss
             + cfg.rcnn_corner_weight * corner)
    return total, {**{f"rpn_{k}": v for k, v in rpn_logs.items()}, "rcnn_cls": cls_loss,
                   "rcnn_reg": reg_loss, "rcnn_corner": corner}


def final_nms(boxes: torch.Tensor, rcnn_cls: torch.Tensor, roi_valid: torch.Tensor,
              score_thr: float, iou_thr: float, max_out: int) -> List[Dict[str, torch.Tensor]]:
    """Refined boxes [B, R, 7] and class logits -> one dict a sample:
    boxes, scores, valid, after score masking and rotated NMS."""
    scores = torch.sigmoid(rcnn_cls) * roi_valid
    scores = torch.where(scores >= score_thr, scores, 0.0)
    sel, valid = iou3d.nms_bev(boxes, scores, iou_thr, min(max_out, boxes.shape[1]))
    s = scores.gather(1, sel)
    kept = _gather_rows(boxes, sel)
    return [{"boxes": kept[i], "scores": s[i], "valid": (valid & (s > 0))[i]}
            for i in range(boxes.shape[0])]


def predict(params: Params, points: torch.Tensor, anchors: torch.Tensor, cfg: VoxelRCNNConfig,
            score_thr: float = 0.3, iou_thr: float = 0.1, max_out: int = 128,
            points_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Two-stage inference: propose -> pool -> refine -> the final NMS; one
    dict a sample of tensors on the model's device."""
    with torch.no_grad():
        preds, ms, _ = forward_stage1(params, points, cfg, points_mask)
        rois, _, roi_valid = propose(preds, anchors, cfg)
        rcnn_cls, rcnn_reg = refine(params, roi_grid_pool(params, ms, rois, cfg), cfg)
        return final_nms(decode_refined(rois, rcnn_reg), rcnn_cls, roi_valid, score_thr,
                         iou_thr, max_out)

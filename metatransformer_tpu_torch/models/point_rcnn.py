"""PointRCNN: the point-based two-stage 3D detector.

Port of ``metatransformer_tpu/models/point_rcnn.py`` (pcdet's
``detectors/point_rcnn.py``): a PointNet2MSG backbone (4 set-abstraction
stages on furthest-point samples, then 4 feature-propagation stages back to
every point), PointHeadBox (a class and a PointResidualCoder box a point),
and PointRCNNHead (RoI point pooling, the canonical transform, the xyz-up /
merge-down MLPs, 3 set-abstraction stages on the pooled points, class and
box refinement).

As in the reference, point sets are batch-major with validity masks; a ball
query takes the first ``nsample`` points inside the radius by index
(:func:`.pv_rcnn.ball_members`) and the RoI pool the first ``num_sampled``
points inside the box (:func:`roi_members`); the proposal, target and loss
machinery is Voxel R-CNN's (:mod:`.voxel_rcnn`). Every FPS is
:func:`..ops.point_ops.masked_fps` / ``furthest_point_sample``: the FPS
kernel on the card, eight launches a forward, two more in the RoI head of
``training_loss`` and ``predict``, there over B x R small clouds at once.

The discrete choices (:func:`.pv_rcnn.ball_members`, :func:`roi_members`,
:func:`assign_point_targets`, :func:`.detector3d.top_scores`,
:func:`..ops.iou3d.nms_bev`) take no gradient, so a caller can record them
from one run and replay them in another. The ball query's distances are
computed ``chunk`` centres at a time: at IA-SSD's first stage
(b = 8, 4,096 centres on 16,384 points) the whole [B, M, N] distance and key
tensors would be 2 GiB each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, pv_rcnn as pv, voxel_rcnn as vr
from metatransformer_tpu_torch.models.detector3d import _gather_rows
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import iou3d, point_interp, point_ops, roi_pool3d
from metatransformer_tpu_torch.ops.gates import gated_relu

Params = Dict[str, Any]

# KITTI class mean sizes (PointResidualCoder BOX_CODER_CONFIG mean_size)
KITTI_MEAN_SIZES = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))


@dataclasses.dataclass(frozen=True)
class SAStage:
    npoint: int
    radii: Tuple[float, ...]
    nsamples: Tuple[int, ...]
    mlps: Tuple[Tuple[int, ...], ...]  # one per radius


@dataclasses.dataclass(frozen=True)
class PointRCNNConfig:
    num_classes: int = 3
    point_features: int = 1  # intensity
    mean_sizes: Tuple[Tuple[float, float, float], ...] = KITTI_MEAN_SIZES
    # PointNet2MSG (OpenPCDet pointrcnn recipe values)
    sa_stages: Tuple[SAStage, ...] = (
        SAStage(4096, (0.1, 0.5), (16, 32), ((16, 16, 32), (32, 32, 64))),
        SAStage(1024, (0.5, 1.0), (16, 32), ((64, 64, 128), (64, 96, 128))),
        SAStage(256, (1.0, 2.0), (16, 32), ((128, 196, 256), (128, 196, 256))),
        SAStage(64, (2.0, 4.0), (16, 32), ((256, 256, 512), (256, 384, 512))),
    )
    fp_mlps: Tuple[Tuple[int, ...], ...] = ((128, 128), (256, 256), (512, 512), (512, 512))
    # PointHeadBox
    head_cls_fc: Tuple[int, ...] = (128,)
    head_reg_fc: Tuple[int, ...] = (128,)
    gt_extra_width: float = 0.2
    # PointRCNNHead
    num_rois: int = 128
    fg_per: int = 64
    num_sampled_points: int = 512
    depth_normalizer: float = 70.0
    xyz_up: Tuple[int, ...] = (128, 128)
    roi_sa_stages: Tuple[SAStage, ...] = (
        SAStage(128, (0.2,), (16,), ((128, 128, 128),)),
        SAStage(32, (0.4,), (16,), ((128, 128, 256),)),
        SAStage(-1, (100.0,), (16,), ((256, 256, 512),)),  # group-all
    )
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    # the target and loss thresholds (Voxel R-CNN's)
    reg_fg_thresh: float = 0.55
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    rcnn_cls_weight: float = 1.0
    rcnn_reg_weight: float = 1.0
    rcnn_corner_weight: float = 1.0
    proposal_nms_thresh: float = 0.8
    proposal_pre: int = 1024

    @property
    def backbone_out(self) -> int:
        return self.fp_mlps[0][-1]


def _mlp_stack_init(randn, cin: int, widths) -> Tuple[List[Params], int]:
    out = []
    for w in widths:
        out.append(vr._lin_init(randn, cin, w))
        cin = w
    return out, cin


def init(cfg: PointRCNNConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    randn = detector3d._randn(generator)
    lin = vr._lin_init
    params: Params = {}
    cin, skip = cfg.point_features, [cfg.point_features]
    for si, st in enumerate(cfg.sa_stages):
        c_out = 0
        for gi, mlp in enumerate(st.mlps):
            params[f"sa{si}_{gi}"], c = _mlp_stack_init(randn, cin + 3, mlp)
            c_out += c
        skip.append(c_out)
        cin = c_out
    c_deep = cin  # FP stages, deep -> shallow: interp(deeper) ++ skip
    for fi in reversed(range(len(cfg.fp_mlps))):
        params[f"fp{fi}"], c_deep = _mlp_stack_init(randn, c_deep + skip[fi], cfg.fp_mlps[fi])
    c_pt = cfg.backbone_out
    params["ph_cls"], c = _mlp_stack_init(randn, c_pt, cfg.head_cls_fc)
    params["ph_cls_pred"] = lin(randn, c, cfg.num_classes, std=0.01)
    params["ph_reg"], c = _mlp_stack_init(randn, c_pt, cfg.head_reg_fc)
    params["ph_reg_pred"] = lin(randn, c, 8, std=0.001)
    params["xyz_up"], c_up = _mlp_stack_init(randn, 5, cfg.xyz_up)
    params["merge_down"] = lin(randn, c_up + c_pt, c_up)
    cin = c_up
    for si, st in enumerate(cfg.roi_sa_stages):
        for gi, mlp in enumerate(st.mlps):
            params[f"rsa{si}_{gi}"], cin2 = _mlp_stack_init(randn, cin + 3, mlp)
        cin = cin2
    params["rcnn_cls"], c = _mlp_stack_init(randn, cin, cfg.cls_fc)
    params["rcnn_cls_pred"] = lin(randn, c, 1, std=0.01)
    params["rcnn_reg"], c = _mlp_stack_init(randn, cin, cfg.reg_fc)
    params["rcnn_reg_pred"] = lin(randn, c, 7, std=0.001)
    return _to(params, device)


# --- grouping with an MLP stack ---------------------------------------------


def apply_stack(stack: List[Params], x: torch.Tensor) -> torch.Tensor:
    """Linear + ReLU layers (the ReLUs through :func:`..ops.gates.gated_relu`)."""
    for p in stack:
        x = gated_relu(x @ p["w"] + p["b"])
    return x


def ball_group_mlp(centers: torch.Tensor, points: torch.Tensor, feats: Optional[torch.Tensor],
                   valid: torch.Tensor, radius: float, nsample: int, stack: List[Params],
                   chunk: int = 512) -> torch.Tensor:
    """Ball query + (rel_xyz ++ feature) MLP stack + a masked max-pool
    (PointnetSAModuleMSG's group) -> [B, M, C_out]: :func:`.pv_rcnn.ball_group`
    with :func:`apply_stack`."""
    return pv.ball_group(centers, points, feats, valid, radius, nsample,
                         lambda h: apply_stack(stack, h), chunk)


# --- PointNet2MSG backbone --------------------------------------------------


def pointnet2_msg(params: Params, xyz: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                  cfg: PointRCNNConfig) -> torch.Tensor:
    """-> per-point features [B, N, backbone_out]: the SA stages on FPS
    centres (one launch of the FPS kernel each), then 3-NN interpolation,
    skip concat and an MLP back up each level."""
    l_xyz, l_feat, l_mask = [xyz], [feats], [mask]
    for si, st in enumerate(cfg.sa_stages):
        idx = point_ops.masked_fps(l_xyz[si], l_mask[si], st.npoint)
        ctr = point_ops.gather_points(l_xyz[si], idx)
        groups = [ball_group_mlp(ctr, l_xyz[si], l_feat[si], l_mask[si], r, ns,
                                 params[f"sa{si}_{gi}"])
                  for gi, (r, ns) in enumerate(zip(st.radii, st.nsamples))]
        l_xyz.append(ctr)
        l_feat.append(torch.cat(groups, -1))
        l_mask.append(l_mask[si].gather(1, idx))
    deep = l_feat[-1]
    for fi in reversed(range(len(cfg.fp_mlps))):
        interp = point_interp.three_interpolation(l_xyz[fi], l_xyz[fi + 1], deep)
        deep = apply_stack(params[f"fp{fi}"], torch.cat([interp, l_feat[fi]], -1))
    return deep


# --- PointResidualCoder -----------------------------------------------------


def mean_sizes_of(classes: torch.Tensor, mean_sizes) -> torch.Tensor:
    """The class mean sizes [..., 3]; a class past the last takes the last,
    as the reference's gather clamps (the recipes' labels are 1-based)."""
    ms = torch.tensor(mean_sizes, dtype=torch.float32, device=classes.device)
    return ms[classes.clamp(0, len(mean_sizes) - 1)]


def point_encode_boxes(gt: torch.Tensor, points: torch.Tensor, classes: torch.Tensor,
                       mean_sizes) -> torch.Tensor:
    """PointResidualCoder.encode_torch: [..., 7] boxes at [..., 3] points
    -> [..., 8] (cos / sin heading)."""
    ms = mean_sizes_of(classes, mean_sizes)
    diag = torch.sqrt(ms[..., 0] ** 2 + ms[..., 1] ** 2)
    return torch.stack([
        (gt[..., 0] - points[..., 0]) / diag, (gt[..., 1] - points[..., 1]) / diag,
        (gt[..., 2] - points[..., 2]) / ms[..., 2],
        torch.log(gt[..., 3].clamp_min(1e-5) / ms[..., 0]),
        torch.log(gt[..., 4].clamp_min(1e-5) / ms[..., 1]),
        torch.log(gt[..., 5].clamp_min(1e-5) / ms[..., 2]),
        torch.cos(gt[..., 6]), torch.sin(gt[..., 6])], -1)


def point_decode_boxes(enc: torch.Tensor, points: torch.Tensor, classes: torch.Tensor,
                       mean_sizes) -> torch.Tensor:
    ms = mean_sizes_of(classes, mean_sizes)
    diag = torch.sqrt(ms[..., 0] ** 2 + ms[..., 1] ** 2)
    return torch.stack([
        enc[..., 0] * diag + points[..., 0], enc[..., 1] * diag + points[..., 1],
        enc[..., 2] * ms[..., 2] + points[..., 2], torch.exp(enc[..., 3]) * ms[..., 0],
        torch.exp(enc[..., 4]) * ms[..., 1], torch.exp(enc[..., 5]) * ms[..., 2],
        torch.atan2(enc[..., 7], enc[..., 6])], -1)


# --- PointHeadBox -----------------------------------------------------------


def point_head_box(params: Params, point_feats: torch.Tensor, cfg: PointRCNNConfig):
    """-> (cls_logits [B, N, num_classes], box_enc [B, N, 8])."""
    h = apply_stack(params["ph_cls"], point_feats)
    cls = h @ params["ph_cls_pred"]["w"] + params["ph_cls_pred"]["b"]
    h = apply_stack(params["ph_reg"], point_feats)
    return cls, h @ params["ph_reg_pred"]["w"] + params["ph_reg_pred"]["b"]


@torch.no_grad()
def assign_point_targets(xyz: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                         gt_valid: torch.Tensor, cfg: PointRCNNConfig):
    """-> (labels [B, N] in {-1 ignore, 0 background, class + 1}, box_gt
    [B, N, 7], box_cls [B, N]): the first ground truth holding each point,
    points only in the enlarged box ignored (point_head_template
    assign_stack_targets with set_ignore_flag)."""
    inside = roi_pool3d.points_in_boxes(xyz, gt_boxes) & gt_valid[:, :, None]
    grown = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6] + 2 * cfg.gt_extra_width,
                       gt_boxes[..., 6:]], -1)
    in_ext = (roi_pool3d.points_in_boxes(xyz, grown) & gt_valid[:, :, None]).any(1)
    gt_idx = inside.to(torch.uint8).argmax(1)  # [B, N], the first holding box
    box_cls = gt_labels.long().gather(1, gt_idx)
    labels = torch.where(inside.any(1), box_cls + 1, torch.where(in_ext, -1, 0))
    return labels, _gather_rows(gt_boxes, gt_idx), box_cls


# --- forward / proposals / the RoI head -------------------------------------


def forward(params: Params, points: torch.Tensor, cfg: PointRCNNConfig,
            points_mask: Optional[torch.Tensor] = None):
    """points [B, N, 3 + point_features] -> (point_feats [B, N, C],
    cls_logits [B, N, K], box_enc [B, N, 8])."""
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    pf = pointnet2_msg(params, points[..., :3], points[..., 3:], points_mask, cfg)
    return (pf, *point_head_box(params, pf, cfg))


def propose(xyz: torch.Tensor, cls_logits: torch.Tensor, box_enc: torch.Tensor,
            mask: torch.Tensor, cfg: PointRCNNConfig):
    """Each point's decoded box -> the top ``proposal_pre`` by score ->
    rotated NMS to ``num_rois`` (point_head_box.generate_predicted_boxes +
    proposal_layer), the whole batch at once -> (rois [B, R, 7], scores,
    valid). Carries no gradient."""
    with torch.no_grad():
        probs = torch.sigmoid(cls_logits)
        s = probs.amax(-1) * mask
        boxes = point_decode_boxes(box_enc, xyz, probs.argmax(-1), cfg.mean_sizes)
        top = detector3d.top_scores(s, min(cfg.proposal_pre, s.shape[1]))
        top_s, top_boxes = s.gather(1, top), _gather_rows(boxes, top)
        sel, valid = iou3d.nms_bev(top_boxes, top_s, cfg.proposal_nms_thresh, cfg.num_rois)
        return _gather_rows(top_boxes, sel), top_s.gather(1, sel), valid


@torch.no_grad()
def roi_members(xyz: torch.Tensor, mask: torch.Tensor, rois: torch.Tensor, num_sampled: int):
    """The first ``num_sampled`` valid points inside each RoI, by index
    (roipoint_pool3d, deterministic) -> (idx [B, R, S], keep [B, R, S],
    empty [B, R]); with fewer points than S the first index repeats."""
    inside = roi_pool3d.points_in_boxes(xyz, rois) & mask[:, None, :]
    n = xyz.shape[1]
    order = torch.arange(n, dtype=torch.float32, device=xyz.device)
    k = min(num_sampled, n)
    idx = torch.topk(torch.where(inside, -order, -(order + n)), k, dim=-1).indices
    if k < num_sampled:
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:2], num_sampled - k)], -1)
    count = inside.sum(-1, keepdim=True)
    keep = torch.arange(num_sampled, device=xyz.device) < count
    return idx, keep, count[..., 0] == 0


def roi_point_pool(xyz: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                   rois: torch.Tensor, num_sampled: int):
    """The RoIs' points in their canonical frame (roipoint_pool3d +
    pointrcnn_head.roipool3d_gpu) -> (local_xyz [B, R, S, 3], feats
    [B, R, S, C], empty [B, R]); slots past a RoI's count and empty RoIs
    are zeros."""
    idx, keep, empty = roi_members(xyz, mask, rois, num_sampled)
    local = point_ops.gather_points(xyz, idx) - rois[:, :, None, :3]
    local = vr.rotate_z(local, -rois[:, :, None, 6])
    z = ((~empty)[..., None, None] & keep[..., None]).to(feats.dtype)
    return local * z, point_ops.gather_points(feats, idx) * z, empty


def rcnn_refine(params: Params, local_xyz: torch.Tensor, point_scores: torch.Tensor,
                point_feats: torch.Tensor, cfg: PointRCNNConfig):
    """xyz-up + merge-down + the SA stages over the B x R pooled clouds (one
    FPS launch a stage with centres) + the heads -> (cls [B, R], reg
    [B, R, 7])."""
    b, r, s, _ = local_xyz.shape
    depth = torch.linalg.vector_norm(local_xyz, dim=-1) / cfg.depth_normalizer - 0.5
    h_xyz = apply_stack(params["xyz_up"],
                        torch.cat([local_xyz, point_scores[..., None], depth[..., None]], -1))
    md = params["merge_down"]
    h = gated_relu(torch.cat([h_xyz, point_feats], -1) @ md["w"] + md["b"])
    cur_xyz = local_xyz.reshape(b * r, s, 3)
    cur_f = h.reshape(b * r, s, -1)
    cur_m = torch.ones(b * r, s, dtype=torch.bool, device=local_xyz.device)
    for si, st in enumerate(cfg.roi_sa_stages):
        if st.npoint == -1:  # group-all: one centre at the origin
            ctr = cur_xyz.new_zeros(b * r, 1, 3)
        else:
            ctr = point_ops.gather_points(
                cur_xyz, point_ops.furthest_point_sample(cur_xyz, st.npoint))
        cur_f = ball_group_mlp(ctr, cur_xyz, cur_f, cur_m, st.radii[0], st.nsamples[0],
                               params[f"rsa{si}_0"])
        cur_xyz = ctr
        cur_m = torch.ones(ctr.shape[:2], dtype=torch.bool, device=ctr.device)
    shared = cur_f[:, 0]
    hc = apply_stack(params["rcnn_cls"], shared)
    cls = (hc @ params["rcnn_cls_pred"]["w"] + params["rcnn_cls_pred"]["b"])[:, 0]
    hr = apply_stack(params["rcnn_reg"], shared)
    reg = hr @ params["rcnn_reg_pred"]["w"] + params["rcnn_reg_pred"]["b"]
    return cls.reshape(b, r), reg.reshape(b, r, 7)


def as_voxel_rcnn(cfg: PointRCNNConfig) -> vr.VoxelRCNNConfig:
    """The Voxel R-CNN config the RoI targets run under, as the reference
    builds it: the proposal NMS, ``num_rois`` and ``fg_per`` from ``cfg``,
    every other target constant at Voxel R-CNN's defaults."""
    return vr.VoxelRCNNConfig(proposal_nms_thresh=cfg.proposal_nms_thresh,
                              proposal_pre=cfg.proposal_pre, num_rois=cfg.num_rois,
                              fg_per=cfg.fg_per)


def _pooled_refine(params, xyz, cls_logits, pf, mask, rois, cfg):
    scores = torch.sigmoid(cls_logits).amax(-1)
    local, gfeat, empty = roi_point_pool(xyz, torch.cat([scores[..., None], pf], -1), mask, rois,
                                         cfg.num_sampled_points)
    return (*rcnn_refine(params, local, gfeat[..., 0], gfeat[..., 1:], cfg), empty)


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor, cfg: PointRCNNConfig,
                  points_mask: Optional[torch.Tensor] = None):
    """The point head's focal class and smooth-L1 box losses + the RoI
    head's (point_rcnn.get_training_loss) -> (total, logs)."""
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    xyz = points[..., :3]
    pf, cls_logits, box_enc = forward(params, points, cfg, points_mask)
    labels, box_gt, box_cls = assign_point_targets(xyz, gt_boxes, gt_labels, gt_valid, cfg)
    valid = ((labels >= 0) & points_mask).float()
    fg = (labels > 0).float()
    n_fg = fg.sum().clamp_min(1.0)
    onehot = detector3d._one_hot(labels - 1, cfg.num_classes) * fg[..., None]
    p = torch.sigmoid(cls_logits)
    pt = p * onehot + (1 - p) * (1 - onehot)
    alpha = 0.25 * onehot + 0.75 * (1 - onehot)
    ce = -torch.log(pt.clamp_min(1e-7))
    cls_loss = (alpha * (1 - pt) ** 2 * ce * valid[..., None]).sum() / n_fg
    enc_t = point_encode_boxes(box_gt, xyz, box_cls, cfg.mean_sizes)
    box_loss = (detector3d.smooth_l1(box_enc - enc_t) * fg[..., None]).sum() / n_fg
    # stage 2
    rois, _, roi_valid = propose(xyz, cls_logits.detach(), box_enc.detach(), points_mask, cfg)
    vcfg = as_voxel_rcnn(cfg)
    targets = vr.sample_rois_for_rcnn(rois, roi_valid, gt_boxes, gt_valid, vcfg)
    rcnn_cls, rcnn_reg, _ = _pooled_refine(params, xyz, cls_logits, pf, points_mask,
                                           targets["rois"], cfg)
    rcls, rreg, corner = vr.rcnn_losses(rcnn_cls, rcnn_reg, targets)
    total = (cls_loss + box_loss + cfg.rcnn_cls_weight * rcls + cfg.rcnn_reg_weight * rreg
             + cfg.rcnn_corner_weight * corner)
    return total, {"point_cls": cls_loss, "point_box": box_loss, "rcnn_cls": rcls,
                   "rcnn_reg": rreg, "rcnn_corner": corner}


def predict(params: Params, points: torch.Tensor, cfg: PointRCNNConfig, score_thr: float = 0.1,
            iou_thr: float = 0.1, max_out: int = 128,
            points_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Two-stage inference: propose -> pool -> refine -> the final NMS (an
    empty RoI scores 0); one dict a sample of tensors on the model's
    device."""
    with torch.no_grad():
        if points_mask is None:
            points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
        xyz = points[..., :3]
        pf, cls_logits, box_enc = forward(params, points, cfg, points_mask)
        rois, _, roi_valid = propose(xyz, cls_logits, box_enc, points_mask, cfg)
        rcnn_cls, rcnn_reg, empty = _pooled_refine(params, xyz, cls_logits, pf, points_mask,
                                                   rois, cfg)
        return vr.final_nms(vr.decode_refined(rois, rcnn_reg), rcnn_cls, roi_valid & ~empty,
                            score_thr, iou_thr, max_out)

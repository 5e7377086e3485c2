"""CenterPoint: the anchor-free centre-heatmap 3D detector.

Port of ``metatransformer_tpu/models/centerpoint.py`` (pcdet's
``detectors/centerpoint.py``): MeanVFE -> VoxelResBackBone8x (a residual
sparse backbone on :mod:`..ops.sparse_conv`, each stage's lookup shared by
its blocks as the reference's ``indice_key``) -> HeightCompression ->
BaseBEVBackbone (:func:`.detector3d.bev_backbone`, every 3x3 conv a patch
GEMM) -> CenterHead (a shared conv, then one stack a regression map and
the heatmap; one set a class group for the nuScenes multihead, with the
2-channel velocity branch; its convs on cuDNN, :func:`head_conv`),
CenterNet's focal and gathered-L1 losses and a top-K heatmap decode with
the rotated BEV NMS.

The discrete steps are named functions without gradient, so a check can
record and replay them: :func:`assign_targets` (each object's integer
centre cell, its radius and its class, and so the heatmap), the top-K of
the decode (:func:`.detector3d.top_scores`, ties to the lower index as
``lax.top_k``), the NMS (:func:`..ops.iou3d.nms_bev`) and every ReLU's
gate (:func:`..ops.gates.act_gate`, the sparse, BEV and head stages
alike). The targets of a
batch are drawn at once, each class's heatmap the maximum of its objects'
Gaussians (the reference's ``lax.scan`` max-composites them one object at
a time, the same maximum). Predictions come back as tensors on the
model's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, second
from metatransformer_tpu_torch.models.vit_adapter import _to, conv2d, group_norm
from metatransformer_tpu_torch.ops import iou3d
from metatransformer_tpu_torch.ops import sparse_conv as sp
from metatransformer_tpu_torch.ops.gates import gated_relu

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    # KITTI geometry (cfgs/dataset_configs/kitti/OD/kitti_dataset.yaml)
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    pc_range: Tuple[float, ...] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    spatial_shape: Tuple[int, int, int] = (41, 1600, 1408)  # (D, H, W)
    max_voxels: int = 16000
    point_features: int = 4
    # VoxelResBackBone8x's channel plan
    widths: Tuple[int, ...] = (16, 16, 32, 64, 128, 128)
    # BaseBEVBackbone (centerpoint.yaml LAYER_NUMS [5, 5])
    bev_channels: Tuple[int, ...] = (128, 256)
    bev_strides: Tuple[int, ...] = (1, 2)
    up_channels: int = 256
    bev_layer_num: int = 5
    # CenterHead
    num_classes: int = 3
    shared_ch: int = 64
    num_conv: int = 2  # a separate head's convs, the last included
    # nuScenes (CLASS_NAMES_EACH_HEAD): one set of heads a group of class
    # ids; () = one head over every class (KITTI)
    class_groups: Tuple[Tuple[int, ...], ...] = ()
    # the 2-channel 'vel' branch; gt_boxes then carry 9 columns
    velocity: bool = False
    # the target assigner
    feature_map_stride: int = 8  # the voxel grid -> the BEV map
    max_objs: int = 500
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    # "centerpoint" keeps the upstream divide-by-2 radius quirk; "3dal"
    # takes the corrected roots (gaussian_radius_3dal)
    radius_mode: str = "centerpoint"
    # losses
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    code_weights: Tuple[float, ...] = (1.0,) * 8
    # post-processing
    score_thresh: float = 0.1
    post_center_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
    nms_thresh: float = 0.7
    max_per_sample: int = 500

    @property
    def bev_hw(self) -> Tuple[int, int]:
        return (self.spatial_shape[1] // 8 // self.bev_strides[0],
                self.spatial_shape[2] // 8 // self.bev_strides[0])

    @property
    def groups(self) -> Tuple[Tuple[int, ...], ...]:
        """The head groups; one all-classes group without class_groups."""
        return self.class_groups or (tuple(range(self.num_classes)),)

    @property
    def code_size(self) -> int:
        return 10 if self.velocity else 8

    def group_channels(self, group: Tuple[int, ...]) -> Dict[str, int]:
        """HEAD_ORDER (+ vel) + hm for one head group."""
        ch = {"center": 2, "center_z": 1, "dim": 3, "rot": 2}
        if self.velocity:
            ch["vel"] = 2
        ch["hm"] = len(group)
        return ch

    @property
    def head_channels(self) -> Dict[str, int]:
        return self.group_channels(self.groups[0])


# --- init ---------------------------------------------------------------------


def _conv_init(randn, cin: int, cout: int, norm: bool = True) -> Params:
    p = {"w": randn(3, 3, cin, cout) * math.sqrt(2.0 / (9 * cin)), "b": torch.zeros(cout)}
    if norm:
        p["gn_scale"] = torch.ones(cout)
        p["gn_bias"] = torch.zeros(cout)
    return p


def _head_prefix(cfg: CenterPointConfig, gi: int) -> str:
    """One group keeps the reference's ``head_`` names."""
    return "head_" if not cfg.class_groups else f"head{gi}_"


def init(cfg: CenterPointConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    randn = detector3d._randn(generator)
    w = cfg.widths
    params: Params = {"conv_input": second._subm_init(randn, cfg.point_features, w[0])}
    for name, cin, cout in (("res1", w[0], w[1]), ("res2", w[1], w[2]), ("res3", w[2], w[3]),
                            ("res4", w[3], w[4])):
        if name != "res1":
            params[f"{name}_down"] = second._subm_init(randn, cin, cout)
        for blk in ("a", "b"):
            params[f"{name}_{blk}1"] = second._subm_init(randn, cout, cout)
            params[f"{name}_{blk}2"] = second._subm_init(randn, cout, cout)
    params["conv_out"] = second._subm_init(randn, w[4], w[5], k=(3, 1, 1))
    cin = w[5] * second._out_depth(second.SECONDConfig(spatial_shape=cfg.spatial_shape))
    for i, cout in enumerate(cfg.bev_channels):
        params[f"block{i}"] = detector3d._bev_block_init(randn, cin, cout, cfg.bev_layer_num)
        params[f"up{i}"] = detector3d._up_init(randn, cout, cfg.up_channels)
        cin = cout
    params["shared"] = _conv_init(randn, cfg.up_channels * len(cfg.bev_channels), cfg.shared_ch)
    for gi, group in enumerate(cfg.groups):
        for name, cout in cfg.group_channels(group).items():
            stack = [_conv_init(randn, cfg.shared_ch, cfg.shared_ch)
                     for _ in range(cfg.num_conv - 1)]
            final = _conv_init(randn, cfg.shared_ch, cout, norm=False)
            if name == "hm":  # the focal prior, init_bias -2.19
                final["b"] = torch.full((cout,), -2.19)
            stack.append(final)
            params[f"{_head_prefix(cfg, gi)}{name}"] = stack
    return _to(params, device)


# --- the sparse residual backbone --------------------------------------------------


def _basic_block(st: sp.SparseTensor, p1: Params, p2: Params, rb) -> sp.SparseTensor:
    """SparseBasicBlock: two submanifold convs on the stage's lookup and a
    residual add."""
    identity = st.features
    st = sp.batch_norm_relu(sp.subm_conv3d(st, p1["w"], rb), p1["bn_scale"], p1["bn_bias"])
    st = sp.batch_norm_relu(sp.subm_conv3d(st, p2["w"], rb), p2["bn_scale"], p2["bn_bias"],
                            relu=False)
    f = gated_relu(st.features + identity) * st.valid[:, None].to(st.features.dtype)
    return dataclasses.replace(st, features=f)


def voxel_res_backbone_8x(params: Params, st: sp.SparseTensor) -> sp.SparseTensor:
    """VoxelResBackBone8x: the stem and four residual stages, stride 8."""
    rb = sp.build_lookup(st)
    st = second._block(st, params["conv_input"], rb)
    st = _basic_block(st, params["res1_a1"], params["res1_a2"], rb)
    st = _basic_block(st, params["res1_b1"], params["res1_b2"], rb)
    for name, pad in (("res2", (1, 1, 1)), ("res3", (1, 1, 1)), ("res4", (0, 1, 1))):
        st = second._down(st, params[f"{name}_down"], (2, 2, 2), pad)
        rb = sp.build_lookup(st)
        st = _basic_block(st, params[f"{name}_a1"], params[f"{name}_a2"], rb)
        st = _basic_block(st, params[f"{name}_b1"], params[f"{name}_b2"], rb)
    return second._down(st, params["conv_out"], (2, 1, 1), (0, 0, 0))


# --- the centre head ------------------------------------------------------------


def head_conv(x: torch.Tensor, p: Params) -> torch.Tensor:
    """A head's 3x3 conv with its bias, XLA "SAME" padding, on cuDNN
    (:func:`..models.vit_adapter.conv2d`, TF32 off), as the reference's.
    On an NVIDIA H100 (700 W) it beat the patch GEMM of
    :func:`.detector3d.conv3x3_gemm` at every head shape of the three
    YAMLs: the shared 512 -> 64 conv 1.66 / 1.17 / 2.83 ms forward against
    2.56 / 2.09 / 4.73 (KITTI b = 2, nuScenes b = 4, Waymo b = 4), the
    64 -> 64 and 64 -> 3 convs 1.2-1.8x, forward and backward alike
    (``scripts/bench_bev_conv.py centerpoint``)."""
    return conv2d(x, p["w"], p["b"])


def _head_stack(x: torch.Tensor, stack: List[Params]) -> torch.Tensor:
    for i, p in enumerate(stack):
        x = head_conv(x, p)
        if i < len(stack) - 1:
            x = gated_relu(group_norm(x, p["gn_scale"], p["gn_bias"]))
    return x


def center_head(params: Params, feat: torch.Tensor, cfg: CenterPointConfig):
    """BEV features [B, H, W, C] -> the prediction maps (NHWC): one dict,
    or with class groups a list of one dict a group."""
    p = params["shared"]
    x = gated_relu(group_norm(head_conv(feat, p), p["gn_scale"], p["gn_bias"]))
    heads = [{name: _head_stack(x, params[f"{_head_prefix(cfg, gi)}{name}"])
              for name in cfg.group_channels(group)}
             for gi, group in enumerate(cfg.groups)]
    return heads if cfg.class_groups else heads[0]


def _as_groups(preds) -> List[Dict[str, torch.Tensor]]:
    return [preds] if isinstance(preds, dict) else list(preds)


def forward(params: Params, points: torch.Tensor, cfg: CenterPointConfig,
            points_mask: torch.Tensor = None):
    """points [B, P, point_features] -> {hm, center, center_z, dim, rot
    (, vel)} NHWC prediction maps (a list of them with class groups)."""
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    st = sp.voxelize_points(points, points_mask, cfg.voxel_size, cfg.pc_range,
                            cfg.spatial_shape, cfg.max_voxels)
    bev = second.height_compression(voxel_res_backbone_8x(params, st))
    return center_head(params, detector3d.bev_backbone(params, bev, cfg), cfg)


# --- target assignment ------------------------------------------------------------


def gaussian_radius(height: torch.Tensor, width: torch.Tensor, min_overlap: float,
                    mode: str = "centerpoint") -> torch.Tensor:
    """CornerNet's radius. In "centerpoint" mode all three roots divide by
    2, not 2a, the upstream CenterNet quirk the reference keeps; "3dal"
    divides by 2a."""
    d2, d8, d3 = (2.0, 2.0, 2.0) if mode == "centerpoint" else (2.0, 8.0, 8.0 * min_overlap)
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1**2 - 4 * c1, 0.0))) / d2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2**2 - 16 * c2, 0.0))) / d8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3**2 - 4 * a3 * c3, 0.0))) / d3
    return torch.minimum(torch.minimum(r1, r2), r3)


@torch.no_grad()
def assign_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   cfg: CenterPointConfig, num_classes: int = None) -> Dict[str, torch.Tensor]:
    """A batch: gt_boxes [B, G, 7|9], gt_labels [B, G] (0-based, the
    head's own), gt_valid [B, G] -> heatmap [B, H, W, C], target_boxes
    [B, G, code_size], inds [B, G], mask [B, G] (pcdet's
    assign_target_of_single_head). Each object draws its Gaussian at its
    integer centre cell, zero outside its Chebyshev radius; a class's
    heatmap is the maximum over its objects. No gradient."""
    n_cls = cfg.num_classes if num_classes is None else num_classes
    fh, fw = cfg.bev_hw
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    s = cfg.feature_map_stride
    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    cx = torch.clamp((x - cfg.pc_range[0]) / vx / s, 0, fw - 0.5)
    cy = torch.clamp((y - cfg.pc_range[1]) / vy / s, 0, fh - 0.5)
    cxi, cyi = cx.to(torch.int32), cy.to(torch.int32)  # truncation, as astype
    dxf = gt_boxes[..., 3] / vx / s
    dyf = gt_boxes[..., 4] / vy / s
    radius = torch.clamp_min(
        gaussian_radius(dyf, dxf, cfg.gaussian_overlap, cfg.radius_mode).to(torch.int32),
        cfg.min_radius)
    ok = gt_valid & (dxf > 0) & (dyf > 0)

    dev = gt_boxes.device
    gx = torch.arange(fw, dtype=torch.float32, device=dev)
    gy = torch.arange(fh, dtype=torch.float32, device=dev)
    sigma = (2 * radius + 1).to(torch.float32) / 6.0  # [B, G]
    dx = gx - cxi[..., None]  # [B, G, W]
    dy = gy - cyi[..., None]  # [B, G, H]
    g = torch.exp(-(torch.square(dy)[..., :, None] + torch.square(dx)[..., None, :])
                  / (2 * sigma**2)[..., None, None])  # [B, G, H, W]
    inside = ((dy.abs() <= radius[..., None])[..., :, None]
              & (dx.abs() <= radius[..., None])[..., None, :])
    g = torch.where(inside & ok[..., None, None], g, 0.0)
    heatmap = torch.stack([torch.where((gt_labels == c)[..., None, None], g, 0.0).amax(1)
                           if g.shape[1] else g.new_zeros(g.shape[0], fh, fw)
                           for c in range(n_cls)], -1)

    cols = [cx - cxi, cy - cyi, z,
            torch.log(torch.clamp_min(gt_boxes[..., 3], 1e-4)),
            torch.log(torch.clamp_min(gt_boxes[..., 4], 1e-4)),
            torch.log(torch.clamp_min(gt_boxes[..., 5], 1e-4)),
            torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])]
    if cfg.velocity:
        cols += [gt_boxes[..., 7], gt_boxes[..., 8]]
    return {"heatmap": heatmap, "target_boxes": torch.stack(cols, -1),
            "inds": (cyi * fw + cxi).long(), "mask": ok}


# --- losses ---------------------------------------------------------------------


def focal_loss_centernet(pred_hm: torch.Tensor, gt_hm: torch.Tensor) -> torch.Tensor:
    """The penalty-reduced focal loss (FocalLossCenterNet); ``pred_hm`` the
    clamped sigmoid probabilities."""
    pos = (gt_hm >= 1.0).to(pred_hm.dtype)
    neg_w = torch.pow(1 - gt_hm, 4)
    pos_loss = torch.log(pred_hm) * torch.square(1 - pred_hm) * pos
    neg_loss = torch.log(1 - pred_hm) * torch.square(pred_hm) * neg_w * (1.0 - pos)
    num_pos = pos.sum()
    total = -(pos_loss.sum() + neg_loss.sum())
    return torch.where(num_pos > 0, total / torch.clamp_min(num_pos, 1.0), -neg_loss.sum())


def detection_loss(preds, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, cfg: CenterPointConfig):
    """The heatmap focal loss + the gathered L1 over HEAD_ORDER, summed
    over the class groups; each group sees its own classes only, with
    group-local labels. -> (total, {"hm", "loc"})."""
    order = ("center", "center_z", "dim", "rot") + (("vel",) if cfg.velocity else ())
    cw = list(cfg.code_weights)
    cw += [1.0] * (cfg.code_size - len(cw))  # the 8-wide default with velocity on
    cw = torch.tensor(cw, dtype=torch.float32, device=gt_boxes.device)
    b = gt_boxes.shape[0]
    hm_total = loc_total = 0.0
    for group, gp in zip(cfg.groups, _as_groups(preds)):
        grp = torch.tensor(group, dtype=gt_labels.dtype, device=gt_labels.device)
        hit = gt_labels[..., None] == grp
        targets = assign_targets(gt_boxes, hit.to(torch.uint8).argmax(-1), gt_valid & hit.any(-1),
                                 cfg, len(group))
        hm = torch.clamp(torch.sigmoid(gp["hm"]), 1e-4, 1 - 1e-4)
        hm_total = hm_total + focal_loss_centernet(hm, targets["heatmap"])
        reg = torch.cat([gp[k] for k in order], -1).reshape(b, -1, cfg.code_size)
        picked = reg.gather(1, targets["inds"][..., None].expand(-1, -1, cfg.code_size))
        m = targets["mask"][..., None].to(reg.dtype)
        loc = (picked - targets["target_boxes"]).abs() * m * cw
        loc_total = loc_total + loc.sum() / torch.clamp_min(m.sum(), 1.0)
    total = cfg.cls_weight * hm_total + cfg.loc_weight * loc_total
    return total, {"hm": hm_total, "loc": loc_total}


# --- decoding ---------------------------------------------------------------------


@torch.no_grad()
def decode(preds, cfg: CenterPointConfig, k: int = 100,
           nms: bool = True) -> List[Dict[str, torch.Tensor]]:
    """Top-K heatmap decode (centernet_utils.decode_bbox_from_heatmap) +
    the class-agnostic rotated BEV NMS, batched; ``valid`` masks the pads.
    With class groups each group takes its own top K, its classes mapped
    to global ids, and one NMS runs over them all; with velocity the boxes
    carry 9 columns. -> one dict a sample: boxes, scores, labels, valid."""
    fw, s = cfg.bev_hw[1], cfg.feature_map_stride
    boxes_all, scores_all, cls_all = [], [], []
    for group, gp in zip(cfg.groups, _as_groups(preds)):
        b, n_cls = gp["hm"].shape[0], len(group)
        flat = torch.sigmoid(gp["hm"]).reshape(b, -1)  # index = (y W + x) Cg + c
        idx = detector3d.top_scores(flat, k)
        scores = flat.gather(1, idx)
        cls = torch.tensor(group, device=idx.device)[idx % n_cls]
        pix = idx // n_cls
        ys, xs = (pix // fw).to(torch.float32), (pix % fw).to(torch.float32)

        def gather(m):
            c = m.shape[-1]
            return m.reshape(b, -1, c).gather(1, pix[..., None].expand(-1, -1, c))

        ctr, dim, rot = gather(gp["center"]), torch.exp(gather(gp["dim"])), gather(gp["rot"])
        cols = [(xs + ctr[..., 0]) * s * cfg.voxel_size[0] + cfg.pc_range[0],
                (ys + ctr[..., 1]) * s * cfg.voxel_size[1] + cfg.pc_range[1],
                gather(gp["center_z"])[..., 0], dim[..., 0], dim[..., 1], dim[..., 2],
                torch.atan2(rot[..., 1], rot[..., 0])]
        if cfg.velocity:
            vel = gather(gp["vel"])
            cols += [vel[..., 0], vel[..., 1]]
        boxes = torch.stack(cols, -1)
        r = torch.tensor(cfg.post_center_range, dtype=boxes.dtype, device=boxes.device)
        keep = ((scores > cfg.score_thresh) & (boxes[..., :3] >= r[:3]).all(-1)
                & (boxes[..., :3] <= r[3:]).all(-1))
        boxes_all.append(boxes)
        scores_all.append(torch.where(keep, scores, 0.0))
        cls_all.append(cls)
    boxes, scores, cls = (torch.cat(t, 1) for t in (boxes_all, scores_all, cls_all))
    if not nms:
        return [{"boxes": boxes[i], "scores": scores[i], "labels": cls[i],
                 "valid": scores[i] > 0} for i in range(boxes.shape[0])]
    sel, valid = iou3d.nms_bev(boxes[..., :7], scores, cfg.nms_thresh,
                               min(len(cfg.groups) * k, cfg.max_per_sample))
    sel_scores = scores.gather(1, sel)
    kept = boxes.gather(1, sel[..., None].expand(-1, -1, boxes.shape[-1]))
    return [{"boxes": kept[i], "scores": sel_scores[i], "labels": cls.gather(1, sel)[i],
             "valid": (valid & (sel_scores > 0))[i]} for i in range(boxes.shape[0])]


"""IA-SSD: the instance-aware single-stage point-based 3D detector.

Port of ``metatransformer_tpu/models/iassd.py`` (pcdet's
``detectors/IASSD.py``): IASSD_Backbone (set-abstraction stages that sample
by D-FPS, then ctr-aware (the top predicted foreground scores), a vote
layer predicting clipped centroid offsets, and a last stage aggregating
around the votes) and IASSD_Head (centre classification weighted by
centerness, the PointResidual_BinOri_Coder box, corner, vote and
per-stage instance-aware losses). Values of ``tools/cfgs/kitti_models/
IA-SSD.yaml``.

As in the reference, point sets are batch-major with validity masks; the
ball groups are PointRCNN's first-k-in-radius form
(:func:`.point_rcnn.ball_group_mlp`); the D-FPS stages are
:func:`..ops.point_ops.masked_fps`, the FPS kernel on the card (two
launches a forward at KITTI width). The ctr-aware pick is
:func:`.detector3d.top_scores`, a stable sort with ties to the lower index
as ``lax.top_k``: masked points score -1 and saturated sigmoids tie at 1.0
in fp32, so ties are certain there. The discrete choices take no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d, point_rcnn as prc, voxel_rcnn as vr
from metatransformer_tpu_torch.models.detector3d import _gather_rows
from metatransformer_tpu_torch.models.point_rcnn import KITTI_MEAN_SIZES
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import iou3d, point_ops, roi_pool3d

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class IASSDStage:
    kind: str  # 'sa' | 'vote'
    npoint: int = -1
    sample: str = "d-fps"  # 'd-fps' | 'ctr-aware'
    radii: Tuple[float, ...] = ()
    nsamples: Tuple[int, ...] = ()
    mlps: Tuple[Tuple[int, ...], ...] = ()
    agg: int = 0  # aggregation MLP width (0: none)
    conf: int = 0  # confidence MLP width (0: none)
    layer_input: int = -1  # index into the encoder list
    ctr_input: int = -1  # SA centres come from this encoder entry
    vote_mlp: Tuple[int, ...] = ()
    max_translate: Tuple[float, float, float] = (3.0, 3.0, 2.0)


# IA-SSD.yaml SA_CONFIG, stage by stage
KITTI_STAGES: Tuple[IASSDStage, ...] = (
    IASSDStage("sa", 4096, "d-fps", (0.2, 0.8), (16, 32), ((16, 16, 32), (32, 32, 64)), agg=64,
               layer_input=0),
    IASSDStage("sa", 1024, "d-fps", (0.8, 1.6), (16, 32), ((64, 64, 128), (64, 96, 128)),
               agg=128, conf=128, layer_input=1),
    IASSDStage("sa", 512, "ctr-aware", (1.6, 4.8), (16, 32), ((128, 128, 256), (128, 256, 256)),
               agg=256, conf=256, layer_input=2),
    IASSDStage("sa", 256, "ctr-aware", layer_input=3, agg=256),
    IASSDStage("vote", layer_input=4, vote_mlp=(128,)),
    IASSDStage("sa", -1, "d-fps", (4.8, 6.4), (16, 32), ((256, 256, 512), (256, 512, 1024)),
               agg=512, layer_input=3, ctr_input=5),
)


@dataclasses.dataclass(frozen=True)
class IASSDConfig:
    num_classes: int = 3
    point_features: int = 1
    mean_sizes: Tuple[Tuple[float, float, float], ...] = KITTI_MEAN_SIZES
    stages: Tuple[IASSDStage, ...] = KITTI_STAGES
    angle_bins: int = 12
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    extra_width: float = 1.0  # ASSIGN_METHOD EXTRA_WIDTH
    # loss weights (IA-SSD.yaml LOSS_CONFIG)
    vote_weight: float = 1.0
    corner_weight: float = 1.0
    ins_aware_weight: float = 1.0
    # post-processing
    score_thresh: float = 0.1
    nms_thresh: float = 0.01
    max_out: int = 128

    @property
    def box_code(self) -> int:
        return 6 + 2 * self.angle_bins


def init(cfg: IASSDConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    randn = detector3d._randn(generator)
    lin = vr._lin_init
    params: Params = {}
    widths = [cfg.point_features]  # the channels of each encoder entry
    for si, st in enumerate(cfg.stages):
        cin = widths[st.layer_input]
        if st.kind == "vote":
            params[f"vote{si}"], c = prc._mlp_stack_init(randn, cin, st.vote_mlp)
            params[f"vote{si}_off"] = lin(randn, c, 3, std=0.001)
            widths.append(cin)  # the vote keeps its input features
            continue
        c_out = 0
        for gi, mlp in enumerate(st.mlps):
            params[f"sa{si}_{gi}"], c = prc._mlp_stack_init(randn, cin + 3, mlp)
            c_out += c
        if not st.mlps:
            c_out = cin
        if st.agg:
            params[f"agg{si}"] = lin(randn, c_out, st.agg)
            c_out = st.agg
        if st.conf:
            params[f"conf{si}"] = lin(randn, c_out, st.conf)
            params[f"conf{si}_pred"] = lin(randn, st.conf, cfg.num_classes, std=0.01)
        widths.append(c_out)
    params["cls"], c = prc._mlp_stack_init(randn, widths[-1], cfg.cls_fc)
    params["cls_pred"] = lin(randn, c, cfg.num_classes, std=0.01)
    params["reg"], c = prc._mlp_stack_init(randn, widths[-1], cfg.reg_fc)
    params["reg_pred"] = lin(randn, c, cfg.box_code, std=0.001)
    return _to(params, device)


# --- the BinOri box coder ---------------------------------------------------


def binori_encode(gt: torch.Tensor, points: torch.Tensor, classes: torch.Tensor,
                  cfg: IASSDConfig):
    """PointResidual_BinOri_Coder.encode: [..., 7] boxes at [..., 3] points
    -> (residuals [..., 6], bin_id [...] int64, bin_res [...])."""
    ms = prc.mean_sizes_of(classes, cfg.mean_sizes)
    diag = torch.sqrt(ms[..., 0] ** 2 + ms[..., 1] ** 2)
    res = torch.stack([
        (gt[..., 0] - points[..., 0]) / diag, (gt[..., 1] - points[..., 1]) / diag,
        (gt[..., 2] - points[..., 2]) / ms[..., 2],
        torch.log(gt[..., 3].clamp_min(1e-5) / ms[..., 0]),
        torch.log(gt[..., 4].clamp_min(1e-5) / ms[..., 1]),
        torch.log(gt[..., 5].clamp_min(1e-5) / ms[..., 2])], -1)
    inter = 2 * np.pi / cfg.angle_bins
    rg = gt[..., 6].clamp(-np.pi + 1e-5, np.pi - 1e-5)
    bin_id = torch.floor((rg + np.pi) / inter).long()
    bin_res = ((rg + np.pi) - (bin_id * inter + inter / 2)) / (inter / 2)
    return res, bin_id, bin_res


def binori_decode(enc: torch.Tensor, points: torch.Tensor, classes: torch.Tensor,
                  cfg: IASSDConfig) -> torch.Tensor:
    """decode_torch -> [..., 7] boxes."""
    ms = prc.mean_sizes_of(classes, cfg.mean_sizes)
    diag = torch.sqrt(ms[..., 0] ** 2 + ms[..., 1] ** 2)
    nb = cfg.angle_bins
    inter = 2 * np.pi / nb
    bin_id = enc[..., 6:6 + nb].argmax(-1)
    bin_res = enc[..., 6 + nb:].gather(-1, bin_id[..., None])[..., 0]
    rg = bin_id * inter - np.pi + inter / 2 + bin_res * (inter / 2)
    return torch.stack([
        enc[..., 0] * diag + points[..., 0], enc[..., 1] * diag + points[..., 1],
        enc[..., 2] * ms[..., 2] + points[..., 2], torch.exp(enc[..., 3]) * ms[..., 0],
        torch.exp(enc[..., 4]) * ms[..., 1], torch.exp(enc[..., 5]) * ms[..., 2], rg], -1)


# --- the backbone -----------------------------------------------------------


def forward(params: Params, points: torch.Tensor, cfg: IASSDConfig,
            points_mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """points [B, N, 3 + point_features] -> {centers, centers_origin,
    ctr_offsets [B, M, 3], center_cls [B, M, K], center_reg [B, M, code],
    sa_ins: [(xyz, logits)] of the confidence stages, center_mask [B, M]}."""
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    enc_xyz, enc_feat, enc_mask = [points[..., :3]], [points[..., 3:]], [points_mask]
    sa_ins: List[Tuple[torch.Tensor, torch.Tensor]] = []
    last_conf = centers = centers_origin = offsets = None
    for si, st in enumerate(cfg.stages):
        xin, fin, min_ = (enc_xyz[st.layer_input], enc_feat[st.layer_input],
                          enc_mask[st.layer_input])
        if st.kind == "vote":
            off = prc.apply_stack(params[f"vote{si}"], fin)
            off = off @ params[f"vote{si}_off"]["w"] + params[f"vote{si}_off"]["b"]
            limit = torch.tensor(st.max_translate, dtype=off.dtype, device=off.device)
            offsets = torch.clamp(off, -limit, limit)
            centers_origin, centers = xin, xin + offsets
            enc_xyz.append(centers)
            enc_feat.append(fin)
            enc_mask.append(min_)
            continue
        idx = None
        if st.ctr_input >= 0:
            ctr, ctr_mask = enc_xyz[st.ctr_input], enc_mask[st.ctr_input]
        else:
            if st.sample == "ctr-aware":  # the top npoint predicted foreground scores
                score = torch.where(min_, torch.sigmoid(last_conf).amax(-1), -1.0)
                idx = detector3d.top_scores(score, st.npoint)
            else:  # d-fps
                idx = point_ops.masked_fps(xin, min_, st.npoint)
            ctr, ctr_mask = point_ops.gather_points(xin, idx), min_.gather(1, idx)
        if st.mlps:
            feat = torch.cat([prc.ball_group_mlp(ctr, xin, fin, min_, r, ns, params[f"sa{si}_{gi}"])
                              for gi, (r, ns) in enumerate(zip(st.radii, st.nsamples))], -1)
        else:  # a sampling-only stage carries the gathered features
            feat = point_ops.gather_points(fin, idx)
        if st.agg:
            feat = prc.apply_stack([params[f"agg{si}"]], feat)
        if st.conf:
            pp = params[f"conf{si}_pred"]
            last_conf = prc.apply_stack([params[f"conf{si}"]], feat) @ pp["w"] + pp["b"]
            sa_ins.append((ctr, last_conf))
        enc_xyz.append(ctr)
        enc_feat.append(feat)
        enc_mask.append(ctr_mask)
    center_feat = enc_feat[-1]
    cls = prc.apply_stack(params["cls"], center_feat) @ params["cls_pred"]["w"] + \
        params["cls_pred"]["b"]
    reg = prc.apply_stack(params["reg"], center_feat) @ params["reg_pred"]["w"] + \
        params["reg_pred"]["b"]
    return {"centers": centers, "centers_origin": centers_origin, "ctr_offsets": offsets,
            "center_cls": cls, "center_reg": reg, "sa_ins": sa_ins, "center_mask": enc_mask[-1]}


# --- targets and losses -----------------------------------------------------


def centerness(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IASSD_head.generate_center_ness_mask: the cube root of the product
    of the min / max distance ratios to opposite faces in the box frame;
    points [..., 3], boxes [..., 7] -> [...]."""
    local = vr.rotate_z(points - boxes[..., :3], -boxes[..., 6])
    half = boxes[..., 3:6] / 2
    d_pos, d_neg = half - local, half + local
    ratio = (torch.minimum(d_pos, d_neg) / torch.maximum(d_pos, d_neg).clamp_min(1e-6)
             ).clamp_min(0.0).prod(-1)
    return ratio.clamp_min(1e-8) ** (1.0 / 3.0)


@torch.no_grad()
def assign_center_targets(origin: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                          gt_valid: torch.Tensor, extra_width: float):
    """'extend_gt' with ASSIGN_TYPE centers_origin: a point is foreground
    inside a ground truth grown by ``extra_width`` a side; its class and box
    are the first such ground truth's -> (fg [B, M], cls [B, M], box
    [B, M, 7])."""
    grown = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6] + 2 * extra_width,
                       gt_boxes[..., 6:]], -1)
    inside = roi_pool3d.points_in_boxes(origin, grown) & gt_valid[:, :, None]
    gt_idx = inside.to(torch.uint8).argmax(1)
    return inside.any(1), gt_labels.long().gather(1, gt_idx), _gather_rows(gt_boxes, gt_idx)


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor, cfg: IASSDConfig,
                  points_mask: Optional[torch.Tensor] = None):
    """Centre classification (centerness-weighted) + the BinOri box + the
    corner, vote and per-stage instance-aware losses (IASSD_head.get_loss)
    -> (total, logs)."""
    out = forward(params, points, cfg, points_mask)
    fg, cls_t, box_t = assign_center_targets(out["centers_origin"], gt_boxes, gt_labels, gt_valid,
                                             cfg.extra_width)
    fgf = (fg & out["center_mask"]).float()
    nfg = fgf.sum().clamp_min(1.0)
    onehot = (detector3d._one_hot(cls_t, cfg.num_classes) * fgf[..., None]
              * centerness(out["centers_origin"], box_t)[..., None])
    p = torch.sigmoid(out["center_cls"]).clamp(1e-7, 1 - 1e-7)
    cls_loss = (-(onehot * torch.log(p) + (1 - onehot) * torch.log(1 - p))).sum() / nfg
    res_t, bin_t, binres_t = binori_encode(box_t, out["centers"], cls_t, cfg)
    reg, nb = out["center_reg"], cfg.angle_bins
    res_loss = (detector3d.smooth_l1(reg[..., :6] - res_t) * fgf[..., None]).sum() / nfg
    bin_ce = -F.log_softmax(reg[..., 6:6 + nb], -1).gather(-1, bin_t[..., None])[..., 0]
    bin_loss = (bin_ce * fgf).sum() / nfg
    binres_p = reg[..., 6 + nb:].gather(-1, bin_t[..., None])[..., 0]
    binres_loss = (detector3d.smooth_l1(binres_p - binres_t) * fgf).sum() / nfg
    dec = binori_decode(reg, out["centers"], cls_t, cfg)
    corner = (vr.corner_loss(dec, box_t) * fgf).sum() / nfg
    vote = (detector3d.smooth_l1(out["centers"] - box_t[..., :3]) * fgf[..., None]).sum() / nfg
    ins_losses = []
    for xyz_l, logits in out["sa_ins"]:
        fg_l, cls_l, _ = assign_center_targets(xyz_l, gt_boxes, gt_labels, gt_valid, 0.0)
        oh = detector3d._one_hot(cls_l, cfg.num_classes) * fg_l[..., None]
        pl = torch.sigmoid(logits).clamp(1e-7, 1 - 1e-7)
        pt = pl * oh + (1 - pl) * (1 - oh)
        al = 0.25 * oh + 0.75 * (1 - oh)
        ins_losses.append((-al * (1 - pt) ** 2 * torch.log(pt)).sum()
                          / fg_l.sum().float().clamp_min(1.0))
    ins_loss = sum(ins_losses) / max(len(ins_losses), 1)
    total = (cls_loss + res_loss + bin_loss + binres_loss + cfg.corner_weight * corner
             + cfg.vote_weight * vote + cfg.ins_aware_weight * ins_loss)
    return total, {"cls": cls_loss, "res": res_loss, "bin": bin_loss, "corner": corner,
                   "vote": vote, "ins": ins_loss}


def predict(params: Params, points: torch.Tensor, cfg: IASSDConfig,
            points_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Decode every centre + rotated NMS (IASSD post_processing), the batch
    at once; one dict a sample of tensors on the model's device: boxes,
    scores, labels, valid."""
    with torch.no_grad():
        out = forward(params, points, cfg, points_mask)
        probs = torch.sigmoid(out["center_cls"])
        scores, labels = probs.amax(-1) * out["center_mask"], probs.argmax(-1)
        boxes = binori_decode(out["center_reg"], out["centers"], labels, cfg)
        scores = torch.where(scores >= cfg.score_thresh, scores, 0.0)
        sel, valid = iou3d.nms_bev(boxes, scores, cfg.nms_thresh,
                                   min(cfg.max_out, boxes.shape[1]))
        s = scores.gather(1, sel)
        kept, lab = _gather_rows(boxes, sel), labels.gather(1, sel)
        return [{"boxes": kept[i], "scores": s[i], "labels": lab[i],
                 "valid": (valid & (s > 0))[i]} for i in range(boxes.shape[0])]

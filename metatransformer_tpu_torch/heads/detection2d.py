"""Two-stage 2D detection (the COCO track): FPN, RPN, RoIAlign and the
R-CNN box and mask heads.

Port of ``metatransformer_tpu/heads/detection2d.py``: mmdet's FPN neck,
RPNHead, Shared2FC / Shared4Conv1FC box heads and FCNMaskHead over the
ViT-Adapter pyramid, with the reference's static shapes kept: a fixed-size
top-k of anchors a level, a greedy NMS to a fixed number of proposals
(padded, score-masked), RoIAlign sampling every level and selecting each
box's, and losses weighting every proposal instead of sampling a subset.
Feature maps are NHWC and conv weights HWIO, as in the reference.

The discrete choices sit in small named functions: :func:`level_topk`,
:func:`nms_xyxy`, :func:`roi_levels`, :func:`rpn_assign`,
:func:`rcnn_assign` and :func:`top_class`. Each takes tensors that carry no
gradient and returns indices or masks, so a caller can record them from
one run and replay them in another.

Where XLA and torch differ, the port keeps XLA's semantics: ties in the
top-k and every argmax go to the lower index, and two ground truths that
share their best anchor in :func:`rpn_assign` resolve as XLA's scatter does
on the CPU, the later one winning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models.vit_adapter import _to, conv2d, max_pool_same, resize
from metatransformer_tpu_torch.ops.ms_deform_attn import bilinear_sample

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# FPN (mmdet FPN: lateral 1x1 + top-down sum + 3x3 out convs + extra pool)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FPNConfig:
    in_channels: Tuple[int, ...] = (768, 768, 768, 768)
    out_channels: int = 256
    num_outs: int = 5


def _randn(generator):
    return lambda *s: torch.randn(*s, generator=generator)


def fpn_init(cfg: FPNConfig, generator: torch.Generator,
             device: _device.Device = None) -> Params:
    """Seeded random parameters (drawn on the CPU, moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    randn, c = _randn(generator), cfg.out_channels
    p: Params = {}
    for i, cin in enumerate(cfg.in_channels):
        p[f"lateral{i}"] = {"w": randn(1, 1, cin, c) * cin**-0.5, "b": torch.zeros(c)}
        p[f"out{i}"] = {"w": randn(3, 3, c, c) * (9 * c) ** -0.5, "b": torch.zeros(c)}
    return _to(p, device)


def fpn_apply(params: Params, feats: Sequence[torch.Tensor], cfg: FPNConfig) -> List[torch.Tensor]:
    """c1 ... c4 (high to low resolution, NHWC) -> ``num_outs`` maps at
    strides 4 ... 64; the extra levels are ``reduce_window`` max with a
    window of 1 and stride 2, "SAME"."""
    lats = [conv2d(f, params[f"lateral{i}"]["w"], params[f"lateral{i}"]["b"])
            for i, f in enumerate(feats)]
    for i in range(len(lats) - 2, -1, -1):
        lats[i] = lats[i] + resize(lats[i + 1], lats[i].shape[1:3], "nearest")
    outs = [conv2d(x, params[f"out{i}"]["w"], params[f"out{i}"]["b"])
            for i, x in enumerate(lats)]
    while len(outs) < cfg.num_outs:
        outs.append(max_pool_same(outs[-1], k=1, stride=2))
    return outs


# ---------------------------------------------------------------------------
# boxes: XYXY <-> delta coding (mmdet DeltaXYWHBBoxCoder), IoU, NMS
# ---------------------------------------------------------------------------


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor, max_hw=None) -> torch.Tensor:
    """rois [..., 4] xyxy + deltas [..., 4] (dx, dy, dw, dh) -> xyxy,
    clipped to the image (``max_hw`` = (h, w)) where given."""
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    cx = rois[..., 0] + 0.5 * w
    cy = rois[..., 1] + 0.5 * h
    dw = deltas[..., 2].clamp(-4.0, 4.0)
    dh = deltas[..., 3].clamp(-4.0, 4.0)
    ncx = cx + deltas[..., 0] * w
    ncy = cy + deltas[..., 1] * h
    nw = w * torch.exp(dw)
    nh = h * torch.exp(dh)
    corners = [ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2]
    if max_hw is not None:
        hi = (max_hw[1], max_hw[0], max_hw[1], max_hw[0])
        corners = [c.clamp(0.0, float(m)) for c, m in zip(corners, hi)]
    return torch.stack(corners, -1)


def bbox2delta(rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    w = (rois[..., 2] - rois[..., 0]).clamp_min(1e-4)
    h = (rois[..., 3] - rois[..., 1]).clamp_min(1e-4)
    cx = rois[..., 0] + 0.5 * w
    cy = rois[..., 1] + 0.5 * h
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-4)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-4)
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    return torch.stack([(gcx - cx) / w, (gcy - cy) / h, torch.log(gw / w), torch.log(gh / h)], -1)


def bbox_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> IoU [..., N, M] (leading axes broadcast)."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp_min(1e-6)


def _gather_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """boxes [B, N, 4], idx [B, K] -> [B, K, 4]."""
    return boxes.gather(1, idx[..., None].expand(*idx.shape, boxes.shape[-1]))


def nms_xyxy(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float, max_out: int):
    """Greedy axis-aligned NMS over a batch, static output size: boxes
    [B, N, 4], scores [B, N] -> (idx [B, max_out], valid [B, max_out]).

    ``max_out`` greedy steps, each on the whole batch and on the device
    (no value is read back): the best live score is kept, and every box
    whose IoU with it exceeds ``iou_thr`` dies with it. Once no box is
    live, a step keeps index 0 and marks it invalid."""
    keep = bbox_iou_xyxy(boxes, boxes) <= iou_thr  # [B, N, N]
    live, n = scores, scores.shape[1]  # -inf where a box has died
    picks, oks = [], []
    for _ in range(max_out):
        best, j = live.max(-1)
        ok = best > float("-inf")
        picks.append(torch.where(ok, j, 0))
        oks.append(ok)
        row = keep.gather(1, j[:, None, None].expand(-1, 1, n))[:, 0]
        live = live.masked_fill(~(row & ok[:, None]), float("-inf"))
    return torch.stack(picks, 1), torch.stack(oks, 1)


# ---------------------------------------------------------------------------
# RPN (mmdet RPNHead: shared 3x3 conv + objectness/delta per anchor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    channels: int = 256
    anchor_scales: Tuple[float, ...] = (8.0,)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    nms_pre: int = 512  # per level, static top-k
    max_proposals: int = 256
    nms_thr: float = 0.7

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)


def rpn_init(cfg: RPNConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    device = _device.resolve(device)
    randn, c, a = _randn(generator), cfg.channels, cfg.num_anchors
    return _to({
        "conv": {"w": randn(3, 3, c, c) * (9 * c) ** -0.5, "b": torch.zeros(c)},
        "cls": {"w": randn(1, 1, c, a) * 1e-2, "b": torch.zeros(a)},
        "reg": {"w": randn(1, 1, c, 4 * a) * 1e-3, "b": torch.zeros(4 * a)},
    }, device)


def level_anchors(hw: Tuple[int, int], stride: int, cfg: RPNConfig) -> np.ndarray:
    """Anchor grid of one level -> [H*W*A, 4] xyxy, ordered (y, x, scale,
    ratio) as the reference's loops; the same float64 arithmetic, at once."""
    h, w = hw
    base = stride * np.asarray(cfg.anchor_scales)
    ratios = np.asarray(cfg.anchor_ratios)
    aw = (base[:, None] * np.sqrt(1.0 / ratios)[None, :]).reshape(-1)
    ah = (base[:, None] * np.sqrt(ratios)[None, :]).reshape(-1)
    y = ((np.arange(h) + 0.5) * stride)[:, None, None]
    x = ((np.arange(w) + 0.5) * stride)[None, :, None]
    shape = (h, w, aw.size)
    out = np.stack([np.broadcast_to(x - aw / 2, shape), np.broadcast_to(y - ah / 2, shape),
                    np.broadcast_to(x + aw / 2, shape), np.broadcast_to(y + ah / 2, shape)], -1)
    return out.reshape(-1, 4).astype(np.float32)


def rpn_apply(params: Params, fpn_feats: Sequence[torch.Tensor], cfg: RPNConfig):
    """-> per level (objectness [B, HWA], deltas [B, HWA, 4])."""
    outs = []
    for f in fpn_feats:
        b = f.shape[0]
        x = torch.relu(conv2d(f, params["conv"]["w"], params["conv"]["b"]))
        cls = conv2d(x, params["cls"]["w"], params["cls"]["b"]).reshape(b, -1)
        reg = conv2d(x, params["reg"]["w"], params["reg"]["b"]).reshape(b, -1, 4)
        outs.append((cls, reg))
    return outs


def level_topk(cls: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` highest objectness indices of each image [B, k], highest
    first, ties to the lower index (``lax.top_k``)."""
    return torch.sort(cls, dim=1, descending=True, stable=True).indices[:, :k]


def rpn_proposals(rpn_outs, anchors_per_level: Sequence[torch.Tensor], cfg: RPNConfig,
                  img_hw: Tuple[int, int]):
    """Top-k a level -> decode -> joint NMS -> fixed-size proposal set:
    (proposals [B, P, 4], scores [B, P], zero where NMS ran dry)."""
    all_boxes, all_scores = [], []
    for (cls, reg), anchors in zip(rpn_outs, anchors_per_level):
        idx = level_topk(cls, min(cfg.nms_pre, cls.shape[1]))
        boxes = delta2bbox(anchors[idx], _gather_boxes(reg, idx), max_hw=img_hw)
        all_boxes.append(boxes)
        all_scores.append(torch.sigmoid(cls.gather(1, idx)))
    boxes = torch.cat(all_boxes, 1)
    scores = torch.cat(all_scores, 1)
    idx, valid = nms_xyxy(boxes, scores, cfg.nms_thr, cfg.max_proposals)
    return _gather_boxes(boxes, idx), scores.gather(1, idx) * valid


# ---------------------------------------------------------------------------
# RoIAlign (mmdet SingleRoIExtractor: level by box scale, bilinear bins)
# ---------------------------------------------------------------------------


def roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: float = 56.0) -> torch.Tensor:
    """mmdet's level of each box [B, P]:
    clamp(floor(log2(sqrt(area) / finest_scale + 1e-6)), 0, L - 1)."""
    w = (rois[..., 2] - rois[..., 0]).clamp_min(1e-4)
    h = (rois[..., 3] - rois[..., 1]).clamp_min(1e-4)
    scale = torch.sqrt(w * h)
    return torch.floor(torch.log2(scale / finest_scale + 1e-6)).clamp(0, num_levels - 1).long()


def roi_align(
    fpn_feats: Sequence[torch.Tensor],  # levels at strides[:num_levels]
    rois: torch.Tensor,  # [B, P, 4] xyxy in image coordinates
    out_size: int = 7,
    strides: Sequence[int] = (4, 8, 16, 32),
    finest_scale: float = 56.0,
) -> torch.Tensor:
    """-> [B, P, out, out, C]: one bilinear sample at each bin centre, on
    every level (static shapes), each box taking its own level's."""
    b, p, _ = rois.shape
    w = (rois[..., 2] - rois[..., 0]).clamp_min(1e-4)
    h = (rois[..., 3] - rois[..., 1]).clamp_min(1e-4)
    lvl = roi_levels(rois, len(strides), finest_scale)
    g = (torch.arange(out_size, device=rois.device) + 0.5) / out_size
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    px = rois[..., 0:1] + gx.reshape(-1)[None, None] * w[..., None]  # [B, P, o*o]
    py = rois[..., 1:2] + gy.reshape(-1)[None, None] * h[..., None]
    out = None
    for li, f in enumerate(fpn_feats[: len(strides)]):
        fh, fw = f.shape[1], f.shape[2]
        coords = torch.stack([px / (fw * strides[li]), py / (fh * strides[li])], -1)
        vals = bilinear_sample(f, coords.reshape(b, -1, 2)).reshape(b, p, out_size * out_size, -1)
        out = vals if out is None else torch.where((lvl == li)[..., None, None], vals, out)
    return out.reshape(b, p, out_size, out_size, -1)


# ---------------------------------------------------------------------------
# R-CNN heads (Shared2FCBBoxHead / FCNMaskHead; cascade = staged box heads)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    num_classes: int = 80
    channels: int = 256
    roi_size: int = 7
    fc_dim: int = 1024
    num_stages: int = 1  # 3 for cascade
    stage_ious: Tuple[float, ...] = (0.5, 0.6, 0.7)
    mask_size: int = 14  # mask roi 14 -> 2x upsample -> 28
    with_mask: bool = True
    # "2fc" = Shared2FCBBoxHead; "4conv1fc" = Shared4Conv1FCBBoxHead (the
    # upgraded_mask_rcnn configs' head: 4 conv3x3 on the RoI map + 1 FC)
    bbox_head: str = "2fc"


def _conv3_init(randn, c):
    return {"w": randn(3, 3, c, c) * (9 * c) ** -0.5, "b": torch.zeros(c)}


def _fc_init(randn, cin, cout):
    return {"w": randn(cin, cout) * cin**-0.5, "b": torch.zeros(cout)}


def rcnn_init(cfg: RCNNConfig, generator: torch.Generator,
              device: _device.Device = None) -> Params:
    """The box head of every stage (cls std 0.01, reg std 0.001, as mmdet:
    near-zero deltas at init keep a cascade's refined boxes on its
    proposals) and, ``with_mask``, the mask head."""
    device = _device.resolve(device)
    randn = _randn(generator)
    c, flat = cfg.channels, cfg.channels * cfg.roi_size * cfg.roi_size
    p: Params = {"stages": []}
    for _ in range(cfg.num_stages):
        if cfg.bbox_head == "4conv1fc":
            stage = {"convs": [_conv3_init(randn, c) for _ in range(4)],
                     "fc1": _fc_init(randn, flat, cfg.fc_dim)}
        else:
            stage = {"fc1": _fc_init(randn, flat, cfg.fc_dim),
                     "fc2": _fc_init(randn, cfg.fc_dim, cfg.fc_dim)}
        stage["cls"] = {"w": randn(cfg.fc_dim, cfg.num_classes + 1) * 0.01,
                        "b": torch.zeros(cfg.num_classes + 1)}
        stage["reg"] = {"w": randn(cfg.fc_dim, 4) * 0.001, "b": torch.zeros(4)}  # class-agnostic
        p["stages"].append(stage)
    if cfg.with_mask:
        p["mask_convs"] = [_conv3_init(randn, c) for _ in range(4)]
        p["mask_out"] = {"w": randn(1, 1, c, cfg.num_classes) * c**-0.5,
                         "b": torch.zeros(cfg.num_classes)}
    return _to(p, device)


def _fc(x, p, mm):
    return enc.linear_at(x, p["w"], p["b"], mm)


def bbox_head_apply(stage_params: Params, roi_feats: torch.Tensor, mm: str):
    """[B, P, o, o, C] -> (cls_logits [B, P, C+1], deltas [B, P, 4]); ``mm``
    is the matmul precision of the FC layers (``core.encoder.linear_at``)."""
    b, p = roi_feats.shape[:2]
    if "convs" in stage_params:  # Shared4Conv1FCBBoxHead
        x = roi_feats.reshape(b * p, *roi_feats.shape[2:])
        for cp in stage_params["convs"]:
            x = torch.relu(conv2d(x, cp["w"], cp["b"]))
        x = torch.relu(_fc(x.reshape(b, p, -1), stage_params["fc1"], mm))
    else:
        x = torch.relu(_fc(roi_feats.reshape(b, p, -1), stage_params["fc1"], mm))
        x = torch.relu(_fc(x, stage_params["fc2"], mm))
    return _fc(x, stage_params["cls"], mm), _fc(x, stage_params["reg"], mm)


def mask_head_apply(params: Params, roi_feats: torch.Tensor):
    """[B, P, o, o, C] -> mask logits [B, P, 2o, 2o, num_classes]: four 3x3
    convs, a bilinear 2x upsample (the deconv's stand-in), a 1x1 conv, all
    in fp32 as the reference's (which takes a matmul precision and uses
    none)."""
    b, p, o, _, c = roi_feats.shape
    x = roi_feats.reshape(b * p, o, o, c)
    for cp in params["mask_convs"]:
        x = torch.relu(conv2d(x, cp["w"], cp["b"]))
    x = resize(x, (2 * o, 2 * o), "bilinear")
    x = conv2d(x, params["mask_out"]["w"], params["mask_out"]["b"])
    return x.reshape(b, p, 2 * o, 2 * o, -1)


def top_class(probs: torch.Tensor) -> torch.Tensor:
    """The most probable class of each box (the lower index on a tie)."""
    return probs.argmax(-1)


# ---------------------------------------------------------------------------
# training losses
# ---------------------------------------------------------------------------


def _scatter_last(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``target.at[idx].set(values)`` along axis 1 with XLA's CPU order on
    duplicate indices: of the updates to one place, the last stands. The
    earlier duplicates write into a spare column that is dropped."""
    g = idx.shape[1]
    later = torch.ones(g, g, dtype=torch.bool, device=idx.device).triu(1)
    shadowed = ((idx[:, :, None] == idx[:, None, :]) & later).any(-1)
    idx = torch.where(shadowed, target.shape[1], idx)
    padded = torch.cat([target, target[:, :1]], 1)
    return padded.scatter(1, idx, values)[:, :-1]


def rpn_assign(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               pos_thr: float = 0.7, neg_thr: float = 0.3):
    """mmdet's RPN assignment: IoU >= pos_thr positive (1), < neg_thr
    negative (0), between ignored (-1), and each valid ground truth's best
    anchor forced positive. anchors [A, 4], gt [B, G, 4] -> (labels [B, A],
    best_gt [B, A])."""
    iou = bbox_iou_xyxy(anchors[None], gt_boxes) * gt_valid[:, None, :]  # [B, A, G]
    best, best_gt = iou.max(-1)
    labels = torch.where(best >= pos_thr, 1, torch.where(best < neg_thr, 0, -1))
    best_anchor = iou.argmax(1)  # [B, G]
    g = torch.arange(gt_boxes.shape[1], device=gt_boxes.device).expand_as(best_anchor)
    labels = _scatter_last(labels, best_anchor,
                           torch.where(gt_valid, 1, labels.gather(1, best_anchor)))
    best_gt = _scatter_last(best_gt, best_anchor,
                            torch.where(gt_valid, g, best_gt.gather(1, best_anchor)))
    return labels, best_gt


def optax_sigmoid_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _per_image_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values * weights) / max(sum(weights), 1) over axis 1."""
    return (values * weights).sum(1) / weights.sum(1).float().clamp_min(1.0)


def rpn_loss(rpn_outs, anchors_per_level, gt_boxes, gt_valid,
             pos_thr: float = 0.7, neg_thr: float = 0.3):
    """Binary objectness CE over the assigned anchors + L1 on the positives'
    deltas; each a mean over images -> (loss, logs)."""
    cls_all = torch.cat([c for c, _ in rpn_outs], 1)  # [B, A]
    reg_all = torch.cat([r for _, r in rpn_outs], 1)  # [B, A, 4]
    anchors = torch.cat(list(anchors_per_level), 0)  # [A, 4]
    labels, best_gt = rpn_assign(anchors, gt_boxes, gt_valid, pos_thr, neg_thr)
    pos, valid = labels == 1, labels >= 0
    cls_loss = _per_image_mean(optax_sigmoid_ce(cls_all, pos.float()), valid)
    target = bbox2delta(anchors[None], _gather_boxes(gt_boxes, best_gt))
    reg_loss = _per_image_mean((reg_all - target).abs().sum(-1), pos)
    return cls_loss.mean() + reg_loss.mean(), {"rpn_cls": cls_loss.mean(),
                                               "rpn_reg": reg_loss.mean()}


def rcnn_assign(proposals: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                pos_iou: float = 0.5):
    """Each proposal's best ground truth and whether its IoU reaches
    ``pos_iou`` -> (pos [B, P], best_gt [B, P])."""
    iou = bbox_iou_xyxy(proposals, gt_boxes) * gt_valid[:, None, :]
    best, best_gt = iou.max(-1)
    return best >= pos_iou, best_gt


def rcnn_stage_loss(cls_logits, deltas, proposals, gt_boxes, gt_labels, gt_valid,
                    num_classes: int, pos_iou: float = 0.5):
    """One stage's RoI loss: CE over C+1 (background = C) on every proposal
    + L1 on the positives' deltas -> (loss, pos, best_gt)."""
    pos, best_gt = rcnn_assign(proposals, gt_boxes, gt_valid, pos_iou)
    labels = torch.where(pos, gt_labels.gather(1, best_gt).long(), num_classes)
    logp = F.log_softmax(cls_logits, -1)
    cls_loss = -logp.gather(-1, labels[..., None])[..., 0].mean(1)
    target = bbox2delta(proposals, _gather_boxes(gt_boxes, best_gt))
    reg_loss = _per_image_mean((deltas - target).abs().sum(-1), pos)
    return cls_loss.mean() + reg_loss.mean(), pos, best_gt

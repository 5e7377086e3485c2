"""Mask R-CNN / Cascade R-CNN over the ViT-Adapter pyramid (the COCO track).

Port of ``metatransformer_tpu/models/mask_rcnn.py``: ViT-Adapter backbone +
FPN (5 levels) + RPN + staged box heads + the FCN mask head, as the
reference's ``mask_rcnn_meta_transformer_adapter_base_fpn_3x_coco.py`` and
``cascade_rcnn/`` (3 stages, IoU 0.5 / 0.6 / 0.7, stage scores averaged at
test time). Every stage runs on the same fixed-size set of NMS'd
proposals; a cascade refines those P boxes stage by stage.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import detection2d as det2d
from metatransformer_tpu_torch.models import vit_adapter
from metatransformer_tpu_torch.ops.ms_deform_attn import bilinear_sample


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    backbone: vit_adapter.ViTAdapterConfig = vit_adapter.ViTAdapterConfig()
    fpn: det2d.FPNConfig = det2d.FPNConfig()
    rpn: det2d.RPNConfig = det2d.RPNConfig()
    rcnn: det2d.RCNNConfig = det2d.RCNNConfig()
    img_size: int = 512

    @property
    def cascade(self) -> bool:
        return self.rcnn.num_stages > 1


def init(cfg: MaskRCNNConfig, generator: torch.Generator,
         device: _device.Device = None) -> Dict[str, Any]:
    """Seeded random parameters {"backbone", "fpn", "rpn", "rcnn"} (drawn on
    the CPU; None: the card)."""
    device = _device.resolve(device)
    return {
        "backbone": vit_adapter.init(cfg.backbone, generator, device),
        "fpn": det2d.fpn_init(cfg.fpn, generator, device),
        "rpn": det2d.rpn_init(cfg.rpn, generator, device),
        "rcnn": det2d.rcnn_init(cfg.rcnn, generator, device),
    }


@functools.lru_cache(maxsize=8)
def _level_anchors(img_size: int, rpn: det2d.RPNConfig, device: torch.device) -> tuple:
    return tuple(torch.from_numpy(det2d.level_anchors((img_size // st, img_size // st), st, rpn))
                 .to(device) for st in rpn.strides)


def _anchors(cfg: MaskRCNNConfig, device) -> List[torch.Tensor]:
    """Each level's anchors on ``device``, made once a configuration."""
    return list(_level_anchors(cfg.img_size, cfg.rpn, torch.device(device)))


def _forward_common(params, images, cfg, precision):
    feats = vit_adapter.apply(params["backbone"], images, cfg.backbone, precision)
    fpn_feats = det2d.fpn_apply(params["fpn"], feats, cfg.fpn)
    rpn_outs = det2d.rpn_apply(params["rpn"], fpn_feats, cfg.rpn)
    anchors = _anchors(cfg, images.device)
    proposals, scores = det2d.rpn_proposals(
        rpn_outs, anchors, cfg.rpn, (cfg.img_size, cfg.img_size))
    return fpn_feats, rpn_outs, anchors, proposals, scores


def _refine(boxes, deltas, img_size: int):
    return det2d.delta2bbox(boxes, deltas, (img_size, img_size))


@torch.no_grad()
def forward_test(
    params: Dict[str, Any],
    images: torch.Tensor,  # [B, S, S, 3]
    cfg: MaskRCNNConfig,
    precision: enc.Precision = enc.FP32,
) -> Dict[str, torch.Tensor]:
    """-> dict(boxes [B, P, 4], scores [B, P], labels [B, P], masks
    [B, P, 2m, 2m, C] logits if ``with_mask``). A cascade averages the
    stages' class probabilities (cascade_rcnn's test behaviour)."""
    mm = precision.mm
    fpn_feats, _, _, boxes, _ = _forward_common(params, images, cfg, precision)
    strides = cfg.rpn.strides[:4]
    stage_probs = []
    for sp in params["rcnn"]["stages"]:
        roi = det2d.roi_align(fpn_feats, boxes, cfg.rcnn.roi_size, strides)
        cls, deltas = det2d.bbox_head_apply(sp, roi, mm)
        stage_probs.append(torch.softmax(cls, -1))
        boxes = _refine(boxes, deltas, cfg.img_size)
    probs = (sum(stage_probs) / len(stage_probs))[..., :-1]
    labels = det2d.top_class(probs)
    out = {"boxes": boxes, "scores": probs.gather(-1, labels[..., None])[..., 0],
           "labels": labels}
    if cfg.rcnn.with_mask:
        roi = det2d.roi_align(fpn_feats, boxes, cfg.rcnn.mask_size, strides)
        out["masks"] = det2d.mask_head_apply(params["rcnn"], roi)
    return out


def mask_targets(gt_masks: torch.Tensor, boxes: torch.Tensor, best_gt: torch.Tensor,
                 m: int, img_size: int) -> torch.Tensor:
    """Each box's ground-truth mask cropped on an m x m bilinear grid of
    bin centres -> [B, P, m, m]. The reference gathers the [B, P, S, S]
    masks by ``best_gt`` first (2 GiB at b = 2, P = 256, S = 1024); every
    mask is sampled at every box's points here and the box's own taken
    after, which gives the same values from [B, P * m * m, G]."""
    b, p = boxes.shape[:2]
    g = (torch.arange(m, device=boxes.device) + 0.5) / m
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-4)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-4)
    px = (boxes[..., 0:1] + gx.reshape(-1)[None, None] * w[..., None]) / img_size
    py = (boxes[..., 1:2] + gy.reshape(-1)[None, None] * h[..., None]) / img_size
    coords = torch.stack([px, py], -1).reshape(b, p * m * m, 2)
    every = bilinear_sample(gt_masks.float().permute(0, 2, 3, 1), coords)  # [B, P*m*m, G]
    every = every.reshape(b, p, m * m, -1)
    return every.gather(-1, best_gt[:, :, None, None].expand(b, p, m * m, 1)).reshape(b, p, m, m)


def mask_loss(mask_logits, boxes, gt_masks, gt_labels, pos, best_gt, img_size: int):
    """BCE of each positive box's class logits against its bilinear
    ground-truth crop, a mean over the positives' pixels."""
    b, p, m = mask_logits.shape[:3]
    crops = mask_targets(gt_masks, boxes, best_gt, m, img_size)
    lab = gt_labels.gather(1, best_gt).long()  # [B, P]
    ml = mask_logits.gather(-1, lab[:, :, None, None, None].expand(b, p, m, m, 1))[..., 0]
    bce = det2d.optax_sigmoid_ce(ml, crops)
    posf = pos.float()[..., None, None]
    return (bce * posf).sum() / (posf.sum() * m * m).clamp_min(1.0)


def forward_train(
    params: Dict[str, Any],
    images: torch.Tensor,
    gt_boxes: torch.Tensor,  # [B, G, 4] xyxy
    gt_labels: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G]
    cfg: MaskRCNNConfig,
    gt_masks: torch.Tensor = None,  # [B, G, S, S] {0, 1}, optional
    precision: enc.Precision = enc.FP32,
):
    """-> (total loss, logs): the RPN loss + each stage's RoI loss (+ the
    mask BCE on the last stage's positive boxes)."""
    mm = precision.mm
    fpn_feats, rpn_outs, anchors, proposals, _ = _forward_common(params, images, cfg, precision)
    total, logs = det2d.rpn_loss(rpn_outs, anchors, gt_boxes, gt_valid)
    strides = cfg.rpn.strides[:4]

    boxes = proposals.detach()
    pos = best_gt = None
    for si, sp in enumerate(params["rcnn"]["stages"]):
        roi = det2d.roi_align(fpn_feats, boxes, cfg.rcnn.roi_size, strides)
        cls, deltas = det2d.bbox_head_apply(sp, roi, mm)
        stage_loss, pos, best_gt = det2d.rcnn_stage_loss(
            cls, deltas, boxes, gt_boxes, gt_labels, gt_valid,
            cfg.rcnn.num_classes, cfg.rcnn.stage_ious[si])
        total = total + stage_loss
        logs[f"stage{si}"] = stage_loss
        # refine the proposals for the next stage (cascade training flow)
        boxes = _refine(boxes, deltas, cfg.img_size).detach()

    if cfg.rcnn.with_mask and gt_masks is not None:
        roi = det2d.roi_align(fpn_feats, boxes, cfg.rcnn.mask_size, strides)
        mask_logits = det2d.mask_head_apply(params["rcnn"], roi)
        loss = mask_loss(mask_logits, boxes, gt_masks, gt_labels, pos, best_gt, cfg.img_size)
        total = total + loss
        logs["mask"] = loss
    return total, logs

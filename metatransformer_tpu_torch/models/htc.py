"""HTC++: Hybrid Task Cascade over the ViT-Adapter FPN (the COCO track).

Port of ``metatransformer_tpu/models/htc.py`` (the reference's
``Image/detection/configs/htc++/``): mmdet's HybridTaskCascade over the
backbone, FPN and RPN of :mod:`.mask_rcnn`:

1. interleaved execution: every cascade stage runs its box AND its mask
   head;
2. mask information flow: stage i's mask features receive a 1x1
   projection of stage i-1's;
3. a fused semantic branch whose stride-8 feature map is RoI-cropped and
   added to the box and mask RoI features, trained with a per-pixel CE
   over the stuff + thing classes;
4. stage losses weighted (1, 0.5, 0.25).

The proposal plumbing is :mod:`.mask_rcnn`'s (a fixed NMS'd set of P boxes
that the cascade refines), and so is the mask loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import detection2d as det2d
from metatransformer_tpu_torch.models import mask_rcnn, vit_adapter
from metatransformer_tpu_torch.models.vit_adapter import _to, conv2d, resize


@dataclasses.dataclass(frozen=True)
class HTCConfig:
    backbone: vit_adapter.ViTAdapterConfig = vit_adapter.ViTAdapterConfig()
    fpn: det2d.FPNConfig = det2d.FPNConfig()
    rpn: det2d.RPNConfig = det2d.RPNConfig()
    rcnn: det2d.RCNNConfig = det2d.RCNNConfig(num_stages=3, with_mask=True)
    img_size: int = 512
    semantic_classes: int = 183  # COCO-stuff (htc semantic branch)
    semantic_convs: int = 4
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)
    semantic_weight: float = 0.2

    @property
    def mask_rcnn(self) -> mask_rcnn.MaskRCNNConfig:
        """The shared backbone, FPN, RPN and box heads as a Mask R-CNN."""
        return mask_rcnn.MaskRCNNConfig(backbone=self.backbone, fpn=self.fpn, rpn=self.rpn,
                                        rcnn=self.rcnn, img_size=self.img_size)


def _conv_init(randn, cin, cout, k=3):
    return {"w": randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin)), "b": torch.zeros(cout)}


def init(cfg: HTCConfig, generator: torch.Generator,
         device: _device.Device = None) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU; None: the card): the
    Mask R-CNN tree without its mask head, each stage's mask head with its
    info-flow projection (from stage 1 on) and the semantic branch."""
    device = _device.resolve(device)
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    params: Dict[str, Any] = {
        "backbone": vit_adapter.init(cfg.backbone, generator, device),
        "fpn": det2d.fpn_init(cfg.fpn, generator, device),
        "rpn": det2d.rpn_init(cfg.rpn, generator, device),
        "rcnn": det2d.rcnn_init(dataclasses.replace(cfg.rcnn, with_mask=False), generator,
                                device),
    }
    c = cfg.rcnn.channels
    heads: Dict[str, Any] = {"mask_stages": []}
    for si in range(cfg.rcnn.num_stages):
        stage = {"convs": [_conv_init(randn, c, c) for _ in range(4)],
                 "out": _conv_init(randn, c, cfg.rcnn.num_classes, k=1)}
        if si > 0:
            stage["info"] = _conv_init(randn, c, c, k=1)
        heads["mask_stages"].append(stage)
    heads["sem_lateral"] = [_conv_init(randn, cfg.fpn.out_channels, c, k=1)
                            for _ in range(cfg.fpn.num_outs)]
    heads["sem_convs"] = [_conv_init(randn, c, c) for _ in range(cfg.semantic_convs)]
    heads["sem_out"] = _conv_init(randn, c, cfg.semantic_classes, k=1)
    params.update(_to(heads, device))
    return params


def semantic_branch(params, fpn_feats, cfg: HTCConfig):
    """Every FPN level fused at stride 8 -> (semantic feature [B, H/8, W/8,
    C], logits [B, H/8, W/8, S]) (mmdet's FusedSemanticHead)."""
    target_hw = tuple(fpn_feats[1].shape[1:3])  # the stride-8 level
    fused = None
    for p, f in zip(params["sem_lateral"], fpn_feats):
        x = conv2d(f, p["w"], p["b"])
        if tuple(x.shape[1:3]) != target_hw:
            x = resize(x, target_hw, "bilinear")
        fused = x if fused is None else fused + x
    for p in params["sem_convs"]:
        fused = torch.relu(conv2d(fused, p["w"], p["b"]))
    return fused, conv2d(fused, params["sem_out"]["w"], params["sem_out"]["b"])


def _sem_roi(sem_feat, boxes, out_size, img_size):
    """One-level RoIAlign crop of the semantic feature (htc's
    semantic_roi_extractor: one level, stride 8)."""
    return det2d.roi_align([sem_feat], boxes, out_size, [img_size // sem_feat.shape[1]])


def _mask_stage_apply(stage, roi_feats, prev_feat):
    """One HTC mask stage with info flow -> (mask logits [B, P, 2o, 2o,
    C_cls], its last conv feature for the next stage's flow). Convs in
    fp32, as the reference's."""
    b, p, o, _, c = roi_feats.shape
    x = roi_feats.reshape(b * p, o, o, c)
    if prev_feat is not None and "info" in stage:
        x = x + conv2d(prev_feat, stage["info"]["w"], stage["info"]["b"])
    for cp in stage["convs"]:
        x = torch.relu(conv2d(x, cp["w"], cp["b"]))
    up = resize(x, (2 * o, 2 * o), "bilinear")
    logits = conv2d(up, stage["out"]["w"], stage["out"]["b"])
    return logits.reshape(b, p, 2 * o, 2 * o, -1), x


def _rois(fpn_feats, sem_feat, boxes, size, cfg: HTCConfig):
    """Box RoIs of the FPN plus those of the semantic feature."""
    roi = det2d.roi_align(fpn_feats, boxes, size, cfg.rpn.strides[:4])
    return roi + _sem_roi(sem_feat, boxes, size, cfg.img_size)


def semantic_loss(sem_logits: torch.Tensor, semantic_labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel CE of the stride-8 logits against the labels resized there
    by ``jax.image.resize(..., "nearest")``; 255 is ignored (0 when every
    pixel is)."""
    b, hs, ws, s = sem_logits.shape
    lab = resize(semantic_labels.float()[..., None], (hs, ws), "nearest")[..., 0].long()
    valid = lab != 255
    ce = F.cross_entropy(sem_logits.reshape(-1, s), torch.where(valid, lab, 0).reshape(-1),
                         reduction="none")
    return (ce * valid.reshape(-1)).sum() / valid.sum().clamp_min(1)


def forward_train(
    params: Dict[str, Any],
    images: torch.Tensor,
    gt_boxes: torch.Tensor,  # [B, G, 4] xyxy
    gt_labels: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G]
    cfg: HTCConfig,
    gt_masks: torch.Tensor = None,  # [B, G, S, S]
    semantic_labels: torch.Tensor = None,  # [B, S, S] int (255 = ignore)
    precision: enc.Precision = enc.FP32,
):
    """-> (total loss, logs): the RPN loss + each stage's interleaved box
    and mask losses (weighted) + the auxiliary semantic CE."""
    mm = precision.mm
    fpn_feats, rpn_outs, anchors, proposals, _ = mask_rcnn._forward_common(
        params, images, cfg.mask_rcnn, precision)
    total, logs = det2d.rpn_loss(rpn_outs, anchors, gt_boxes, gt_valid)

    sem_feat, sem_logits = semantic_branch(params, fpn_feats, cfg)
    if semantic_labels is not None:
        sem_loss = semantic_loss(sem_logits, semantic_labels)
        total = total + cfg.semantic_weight * sem_loss
        logs["semantic"] = sem_loss

    boxes = proposals.detach()
    prev_mask_feat = None
    for si, sp in enumerate(params["rcnn"]["stages"]):
        wgt = cfg.stage_loss_weights[si]
        cls, deltas = det2d.bbox_head_apply(
            sp, _rois(fpn_feats, sem_feat, boxes, cfg.rcnn.roi_size, cfg), mm)
        stage_loss, pos, best_gt = det2d.rcnn_stage_loss(
            cls, deltas, boxes, gt_boxes, gt_labels, gt_valid,
            cfg.rcnn.num_classes, cfg.rcnn.stage_ious[si])
        total = total + wgt * stage_loss
        logs[f"stage{si}_bbox"] = stage_loss

        # the interleaved mask head at EVERY stage, with info flow
        if gt_masks is not None:
            mlogits, prev_mask_feat = _mask_stage_apply(
                params["mask_stages"][si],
                _rois(fpn_feats, sem_feat, boxes, cfg.rcnn.mask_size, cfg), prev_mask_feat)
            mloss = mask_rcnn.mask_loss(mlogits, boxes, gt_masks, gt_labels, pos, best_gt,
                                        cfg.img_size)
            total = total + wgt * mloss
            logs[f"stage{si}_mask"] = mloss

        boxes = mask_rcnn._refine(boxes, deltas, cfg.img_size).detach()
    return total, logs


@torch.no_grad()
def forward_test(
    params: Dict[str, Any],
    images: torch.Tensor,
    cfg: HTCConfig,
    precision: enc.Precision = enc.FP32,
) -> Dict[str, torch.Tensor]:
    """Cascade-averaged class scores; masks from the last stage through the
    whole info-flow chain on the final boxes (htc's test behaviour); the
    stride-8 semantic logits."""
    mm = precision.mm
    fpn_feats, _, _, boxes, _ = mask_rcnn._forward_common(
        params, images, cfg.mask_rcnn, precision)
    sem_feat, sem_logits = semantic_branch(params, fpn_feats, cfg)
    stage_probs = []
    for sp in params["rcnn"]["stages"]:
        cls, deltas = det2d.bbox_head_apply(
            sp, _rois(fpn_feats, sem_feat, boxes, cfg.rcnn.roi_size, cfg), mm)
        stage_probs.append(torch.softmax(cls, -1))
        boxes = mask_rcnn._refine(boxes, deltas, cfg.img_size)
    probs = (sum(stage_probs) / len(stage_probs))[..., :-1]
    labels = det2d.top_class(probs)
    prev = None
    for si in range(cfg.rcnn.num_stages):
        mlogits, prev = _mask_stage_apply(
            params["mask_stages"][si],
            _rois(fpn_feats, sem_feat, boxes, cfg.rcnn.mask_size, cfg), prev)
    return {"boxes": boxes, "scores": probs.gather(-1, labels[..., None])[..., 0],
            "labels": labels, "semantic": sem_logits, "masks": mlogits}

"""Part-A2: the part-aware two-stage 3D detector with a sparse U-Net.

Port of ``metatransformer_tpu/models/part_a2.py`` (pcdet's
``detectors/PartA2_net.py``):

- UNetV2 (``backbones_3d/spconv_unet.py``): SECOND's VoxelBackBone8x as
  the encoder, then UR decoder blocks (a lateral submanifold conv, the
  concat with the decoder path, a merge conv plus the sum-folded concat)
  with inverse sparse convs back to each finer stored active set
  (:func:`..ops.sparse_conv.inverse_sparse_conv3d`);
- PointIntraPartOffsetHead: a foreground logit and the intra-object part
  location in [0, 1]^3 for every voxel of the decoder's output;
- SECOND's anchor head on the encoder's BEV map: the 3x3 BEV convs are
  :func:`.detector3d.conv3x3_gemm`, the three 1x1 heads
  :func:`.vit_adapter.conv2d` (cuDNN on the card);
- PartA2FCHead: RoI-aware pooling of (decoder feature, part, sigmoid(seg))
  by Voxel R-CNN's deterministic grid pool on the stride-1 voxel list, and
  the shared-FC refinement.

Part targets are the closed-form box-frame coordinates of each voxel
centre (:func:`part_targets`, no gradient). The proposal, target and loss
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
from metatransformer_tpu_torch.ops import sparse_conv as sp

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PartA2Config:
    stage1: second.SECONDConfig = second.SECONDConfig(
        widths=(16, 16, 32, 64, 64, 128), bev_channels=(128, 256), up_channels=256)
    num_rois: int = 128
    fg_per: int = 64
    grid_size: int = 6  # RoI part pooling grid
    pool_mlp: int = 32
    shared_fc: Tuple[int, ...] = (256, 256)
    cls_fc: Tuple[int, ...] = (256, 256)
    reg_fc: Tuple[int, ...] = (256, 256)
    seg_weight: float = 1.0
    part_weight: float = 1.0
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
    def unet_out(self) -> int:
        return self.stage1.widths[0]  # the decoder returns to the stem width


def _decoder_plan(cfg: PartA2Config):
    """(name, lateral channels, bottom channels, out channels) a level
    (spconv_unet.py:110-132): stride 8 -> 4 -> 2 -> 1, then the final
    submanifold conv at stride 1."""
    w = cfg.stage1.widths
    return (("up4", w[4], w[4], w[3]), ("up3", w[3], w[3], w[2]), ("up2", w[2], w[2], w[0]),
            ("up1", w[1], w[0], w[0]))


def init(cfg: PartA2Config, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    params: Params = {"stage1": second.init_cpu(cfg.stage1, generator)}
    randn = detector3d._randn(generator)
    for name, cl, cb, co in _decoder_plan(cfg):
        params[f"{name}_t"] = second._subm_init(randn, cl, cl)
        params[f"{name}_m"] = second._subm_init(randn, cl + cb, cl)
        params[f"{name}_inv"] = second._subm_init(randn, cl, co)
    params["seg"] = vr._lin_init(randn, cfg.unet_out, 1, std=0.01)
    params["part"] = vr._lin_init(randn, cfg.unet_out, 3, std=0.01)
    # the RoI head: a pre-MLP on (decoder feature, part (3), seg (1)), then the grid pool
    params["pre_pool"] = vr._lin_init(randn, cfg.unet_out + 4, cfg.pool_mlp)
    params["agg_pool"] = vr._lin_init(randn, cfg.pool_mlp + 3, cfg.pool_mlp)
    vr._refine_init(randn, params, cfg.grid_size**3 * cfg.pool_mlp, cfg)
    return _to(params, device)


# --- the U-Net decoder ------------------------------------------------------


def _ur_block(params: Params, name: str, lateral: sp.SparseTensor,
              bottom: sp.SparseTensor) -> sp.SparseTensor:
    """UR_block_forward (spconv_unet.py:135-143): the lateral transform, the
    concat with the decoder path, the merge conv, plus the concat's channels
    sum-folded to the merge's width (channel_reduction)."""
    rb = sp.build_lookup(lateral)
    xt = second._block(lateral, params[f"{name}_t"], rb)
    cat = dataclasses.replace(xt, features=torch.cat([bottom.features, xt.features], -1))
    pm = params[f"{name}_m"]
    xm = sp.batch_norm_relu(sp.subm_conv3d(cat, pm["w"], rb), pm["bn_scale"], pm["bn_bias"])
    n, cc = cat.features.shape
    co = xm.features.shape[1]
    folded = cat.features.reshape(n, co, cc // co).sum(2)
    return dataclasses.replace(xm, features=xm.features + folded)


def _inverse(params: Params, name: str, x: sp.SparseTensor, fine: sp.SparseTensor,
             padding) -> sp.SparseTensor:
    p = params[f"{name}_inv"]
    x = sp.inverse_sparse_conv3d(x, fine, p["w"], (2, 2, 2), padding)
    return sp.batch_norm_relu(x, p["bn_scale"], p["bn_bias"])


def unet_forward(params: Params, st: sp.SparseTensor, cfg: PartA2Config):
    """-> (the encoder's stride-8 tensor, the decoder's features on the input
    active set) (UNetV2.forward)."""
    out, ms = second.voxel_backbone_8x_ms(params["stage1"], st)
    x1, x2, x3, x4 = ms["x_conv1"], ms["x_conv2"], ms["x_conv3"], ms["x_conv4"]
    x = _inverse(params, "up4", _ur_block(params, "up4", x4, x4), x3, (0, 1, 1))
    x = _inverse(params, "up3", _ur_block(params, "up3", x3, x), x2, (1, 1, 1))
    x = _inverse(params, "up2", _ur_block(params, "up2", x2, x), x1, (1, 1, 1))
    x = _ur_block(params, "up1", x1, x)
    p = params["up1_inv"]
    x = sp.batch_norm_relu(sp.subm_conv3d(x, p["w"], sp.build_lookup(x)), p["bn_scale"],
                           p["bn_bias"])
    return out, x


# --- the part head ----------------------------------------------------------


@torch.no_grad()
def part_targets(st: sp.SparseTensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 cfg: PartA2Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each voxel's (foreground [N], part location in [0, 1]^3 [N, 3])
    (point_intra_part_head.assign_targets): the voxel centre in the frame of
    the first valid ground truth that holds it."""
    s1 = cfg.stage1
    dtype, dev = gt_boxes.dtype, gt_boxes.device
    pcr = torch.tensor(s1.pc_range[:3], dtype=dtype, device=dev)
    vsz = torch.tensor(s1.voxel_size, dtype=dtype, device=dev)
    xyz = (st.coords[:, 1:].flip(-1).to(dtype) + 0.5) * vsz + pcr  # [N, 3]
    bidx = st.coords[:, 0]
    gt, gv = gt_boxes[bidx], gt_valid[bidx]  # [N, G, 7], [N, G]
    local = vr.rotate_z(xyz[:, None, :] - gt[..., :3], -gt[..., 6])  # [N, G, 3]
    inside = (local.abs() <= gt[..., 3:6] / 2).all(-1) & gv & st.valid[:, None]
    gi = inside.to(torch.uint8).argmax(-1)  # the first valid box that holds it
    sel = local.gather(1, gi[:, None, None].expand(-1, 1, 3))[:, 0]
    dims = gt[..., 3:6].gather(1, gi[:, None, None].expand(-1, 1, 3))[:, 0]
    return inside.any(-1), (sel / dims.clamp_min(1e-5) + 0.5).clamp(0.0, 1.0)


def forward(params: Params, points: torch.Tensor, cfg: PartA2Config,
            points_mask: Optional[torch.Tensor] = None):
    """points -> (the anchor head's predictions, the decoder's voxel tensor,
    seg logits [N], part predictions [N, 3])."""
    s1 = cfg.stage1
    enc, dec = unet_forward(params, second.voxelize(points, s1, points_mask), cfg)
    feat = detector3d.bev_backbone(params["stage1"], second.height_compression(enc), s1)
    preds = detector3d.anchor_head(params["stage1"], feat, s1)
    seg = (dec.features @ params["seg"]["w"] + params["seg"]["b"])[:, 0]
    part = torch.sigmoid(dec.features @ params["part"]["w"] + params["part"]["b"])
    return preds, dec, seg, part


def roi_part_pool(params: Params, dec: sp.SparseTensor, seg: torch.Tensor, part: torch.Tensor,
                  rois: torch.Tensor, cfg: PartA2Config) -> torch.Tensor:
    """RoI-aware pooling of (features, part, sigmoid(seg)) on the stride-1
    voxel list -> [B, R, G^3 * pool_mlp] (partA2_head's roiaware pooling, by
    Voxel R-CNN's grid pool: 8 template offsets within two voxels)."""
    feats = torch.cat([dec.features, part, torch.sigmoid(seg)[:, None]], -1)
    aug = dataclasses.replace(dec, features=feats)
    vcfg = vr.VoxelRCNNConfig(
        stage1=cfg.stage1, grid_size=cfg.grid_size,
        pool_layers=(("x_dec", vr.PoolLayerConfig(1, float(cfg.stage1.voxel_size[0]) * 2.0,
                                                  nsample=8, mlp=cfg.pool_mlp)),))
    p = {"pre_x_dec": params["pre_pool"], "agg_x_dec": params["agg_pool"]}
    return vr.roi_grid_pool(p, {"x_dec": aug}, rois, vcfg)


def as_voxel_rcnn(cfg: PartA2Config) -> vr.VoxelRCNNConfig:
    """The Voxel R-CNN config the proposals and RoI targets run under, as
    the reference builds it: stage 1, the proposal NMS, ``num_rois`` and
    ``fg_per`` from ``cfg``, the other target constants Voxel R-CNN's."""
    return vr.VoxelRCNNConfig(stage1=cfg.stage1, proposal_nms_thresh=cfg.proposal_nms_thresh,
                              proposal_pre=cfg.proposal_pre, num_rois=cfg.num_rois,
                              fg_per=cfg.fg_per)


def training_loss(params: Params, points: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, anchors: torch.Tensor, cfg: PartA2Config,
                  points_mask: Optional[torch.Tensor] = None):
    """loss_rpn + the seg focal loss + the part smooth-L1 + loss_rcnn
    (PartA2_net.get_training_loss)."""
    preds, dec, seg, part = forward(params, points, cfg, points_mask)
    rpn_loss, rpn_logs = second.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg.stage1)
    fg, part_t = part_targets(dec, gt_boxes, gt_valid, cfg)
    fgf = fg.to(seg.dtype)
    nfg = fgf.sum().clamp_min(1.0)
    p = torch.sigmoid(seg).clamp(1e-7, 1 - 1e-7)
    pt = p * fgf + (1 - p) * (1 - fgf)
    alpha = 0.25 * fgf + 0.75 * (1 - fgf)
    seg_loss = (-alpha * (1 - pt) ** 2 * torch.log(pt) * dec.valid.to(seg.dtype)).sum() / nfg
    part_loss = (detector3d.smooth_l1(part - part_t) * fgf[:, None]).sum() / nfg

    vcfg = as_voxel_rcnn(cfg)
    rois, _, roi_valid = vr.propose(vr._detached(preds), anchors, vcfg)
    targets = vr.sample_rois_for_rcnn(rois, roi_valid, gt_boxes, gt_valid, vcfg)
    pooled = roi_part_pool(params, dec, seg, part, targets["rois"], cfg)
    rcnn_cls, rcnn_reg = vr.refine(params, pooled, cfg)
    cls_loss, reg_loss, corner = vr.rcnn_losses(rcnn_cls, rcnn_reg, targets)
    total = (rpn_loss + cfg.seg_weight * seg_loss + cfg.part_weight * part_loss
             + cfg.rcnn_cls_weight * cls_loss + cfg.rcnn_reg_weight * reg_loss
             + cfg.rcnn_corner_weight * corner)
    return total, {**{f"rpn_{k}": v for k, v in rpn_logs.items()}, "seg": seg_loss,
                   "part": part_loss, "rcnn_cls": cls_loss, "rcnn_reg": reg_loss,
                   "rcnn_corner": corner}


def predict(params: Params, points: torch.Tensor, anchors: torch.Tensor, cfg: PartA2Config,
            score_thr: float = 0.1, iou_thr: float = 0.1, max_out: int = 128,
            points_mask: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Two-stage inference: propose -> part pool -> refine -> the final NMS;
    one dict a sample of tensors on the model's device."""
    with torch.no_grad():
        preds, dec, seg, part = forward(params, points, cfg, points_mask)
        rois, _, roi_valid = vr.propose(preds, anchors, as_voxel_rcnn(cfg))
        pooled = roi_part_pool(params, dec, seg, part, rois, cfg)
        rcnn_cls, rcnn_reg = vr.refine(params, pooled, cfg)
        return vr.final_nms(vr.decode_refined(rois, rcnn_reg), rcnn_cls, roi_valid, score_thr,
                            iou_thr, max_out)

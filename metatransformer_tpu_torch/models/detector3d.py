"""PointPillars-style 3D detector.

Port of ``metatransformer_tpu/models/detector3d.py``: pcdet's
``Detector3DTemplate`` topology instantiated as PointPillar: PillarVFE ->
PointPillarScatter -> BaseBEVBackbone (downsampling blocks, 1x1 ups, concat)
-> AnchorHeadSingle (class / 7-dof box residual / direction bins) with the
ResidualCoder; focal class loss, smooth-L1 box loss, direction CE, and a
sigmoid + top-k + rotated NMS predict. Feature maps are NHWC and conv
weights HWIO, as in the reference; the 3x3 BEV convs are one GEMM over
their patches (:func:`conv3x3_gemm`), the 1x1 ups and heads the dense
prediction slice's :func:`..models.vit_adapter.conv2d`, the norms its
``group_norm``.

The discrete choices sit in small functions that take no gradient:
:func:`assign_targets` and :func:`top_scores` (a stable top-k: ties to the
lower index, as ``lax.top_k``); the NMS is :func:`..ops.iou3d.nms_bev`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.heads.detection2d import _scatter_last
from metatransformer_tpu_torch.models.vit_adapter import _same_pads, _to, conv2d, group_norm, resize
from metatransformer_tpu_torch.ops import iou3d, voxelize

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Per-class anchor generation; entry i of each tuple is class i
    (pcdet ANCHOR_GENERATOR_CONFIG)."""

    sizes: Tuple[Tuple[float, float, float], ...] = ((3.9, 1.6, 1.56),)  # car
    rotations: Tuple[float, ...] = (0.0, 1.5708)
    z_centers: Tuple[float, ...] = (-1.0,)
    matched_thrs: Tuple[float, ...] = (0.6,)
    unmatched_thrs: Tuple[float, ...] = (0.45,)

    @property
    def per_cell(self) -> int:
        return len(self.sizes) * len(self.rotations)

    @property
    def num_classes(self) -> int:
        return len(self.sizes)

    @property
    def z_center(self) -> float:  # single-class convenience
        return self.z_centers[0]


# KITTI car / pedestrian / cyclist (pointpillar.yaml anchor table)
KITTI_3CLASS = AnchorConfig(
    sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73)),
    rotations=(0.0, 1.5708),
    z_centers=(-1.78, -0.6, -0.6),
    matched_thrs=(0.6, 0.5, 0.5),
    unmatched_thrs=(0.45, 0.35, 0.35),
)


@dataclasses.dataclass(frozen=True)
class Detector3DConfig:
    vfe: voxelize.PillarVFEConfig = voxelize.PillarVFEConfig()
    bev_channels: Tuple[int, ...] = (64, 128, 256)
    bev_strides: Tuple[int, ...] = (2, 2, 2)
    up_channels: int = 128
    anchors: AnchorConfig = AnchorConfig()
    num_classes: int = 1
    dir_bins: int = 2

    @property
    def feature_stride(self) -> int:
        return self.bev_strides[0]  # every up returns to the first block's stride

    @property
    def box_code(self) -> int:
        return 7


# --- ResidualCoder (pcdet box_coder_utils.ResidualCoder) -------------------


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    xg, yg, zg, dxg, dyg, dzg, rg = boxes.unbind(-1)
    diag = torch.sqrt(dxa**2 + dya**2)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                        torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                        rg - ra], -1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    dx, dy, dz, ddx, ddy, ddz, dr = deltas.unbind(-1)
    diag = torch.sqrt(dxa**2 + dya**2)
    return torch.stack([dx * diag + xa, dy * diag + ya, dz * dza + za, torch.exp(ddx) * dxa,
                        torch.exp(ddy) * dya, torch.exp(ddz) * dza, dr + ra], -1)


def _anchor_grid(fx: int, fy: int, r, anchors: AnchorConfig, per_class_z: bool) -> np.ndarray:
    xs = np.linspace(r[0], r[3], fx, endpoint=False) + (r[3] - r[0]) / fx / 2
    ys = np.linspace(r[1], r[4], fy, endpoint=False) + (r[4] - r[1]) / fy / 2
    out = []
    for y in ys:
        for x in xs:
            for ci, (l, w, h) in enumerate(anchors.sizes):
                z = anchors.z_centers[ci] if per_class_z else anchors.z_center
                for rot in anchors.rotations:
                    out.append([x, y, z, l, w, h, rot])
    return np.asarray(out, np.float32)


def generate_anchors(cfg: Detector3DConfig) -> np.ndarray:
    """The dense anchor grid at the BEV feature stride -> [A_total, 7].
    Per-cell order: sizes (classes) x rotations; per-class z centres."""
    nx, ny, _ = cfg.vfe.voxel.grid_size
    return _anchor_grid(nx // cfg.feature_stride, ny // cfg.feature_stride,
                        cfg.vfe.voxel.pc_range, cfg.anchors, per_class_z=True)


def anchor_class_ids(acfg: AnchorConfig, total: int) -> np.ndarray:
    """The class of each anchor in generate_anchors order -> [A_total]."""
    return (np.arange(total) // len(acfg.rotations)) % len(acfg.sizes)


# --- BEV backbone -----------------------------------------------------------


def _randn(generator):
    return lambda *s: torch.randn(*s, generator=generator)


def _bev_block_init(randn, cin, cout, n_convs=3):
    return [{"w": randn(3, 3, cin if i == 0 else cout, cout)
                  * np.sqrt(2.0 / (9 * (cin if i == 0 else cout))),
             "gn_scale": torch.ones(cout), "gn_bias": torch.zeros(cout)}
            for i in range(n_convs)]


def _up_init(randn, cout, up_channels):
    return {"w": randn(1, 1, cout, up_channels) * cout**-0.5,
            "gn_scale": torch.ones(up_channels), "gn_bias": torch.zeros(up_channels)}


def _head_init(randn, c_head, cfg) -> Params:
    a = cfg.anchors.per_cell
    return {
        "cls_w": randn(1, 1, c_head, a * cfg.num_classes) * 1e-2,
        # focal-loss prior: p ~ 0.01
        "cls_b": torch.full((a * cfg.num_classes,), -math.log(99.0)),
        "box_w": randn(1, 1, c_head, a * cfg.box_code) * 1e-3,
        "box_b": torch.zeros(a * cfg.box_code),
        "dir_w": randn(1, 1, c_head, a * cfg.dir_bins) * 1e-2,
        "dir_b": torch.zeros(a * cfg.dir_bins),
    }


def init(cfg: Detector3DConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    randn = _randn(generator)
    params: Params = {"vfe": voxelize.pillar_vfe_init(cfg.vfe, generator, "cpu")}
    cin = cfg.vfe.channels
    for i, cout in enumerate(cfg.bev_channels):
        params[f"block{i}"] = _bev_block_init(randn, cin, cout)
        params[f"up{i}"] = _up_init(randn, cout, cfg.up_channels)
        cin = cout
    params.update(_head_init(randn, cfg.up_channels * len(cfg.bev_channels), cfg))
    return _to(params, device)


def _pad_same_3x3(x: torch.Tensor, stride: int):
    """NHWC ``x`` padded as XLA's "SAME" for a 3x3 window -> (padded,
    (ho, wo), (top, left))."""
    h, wd = x.shape[1:3]
    top, bottom = _same_pads(h, 3, stride)
    left, right = _same_pads(wd, 3, stride)
    return (F.pad(x, (0, 0, left, right, top, bottom)), (-(-h // stride), -(-wd // stride)),
            (top, left))


def _patch_views(xp: torch.Tensor, ho: int, wo: int, stride: int) -> List[torch.Tensor]:
    """The nine strided [B, ho, wo, C] views of the padded input that the
    3x3 taps read, in HWIO's (i, j) order."""
    return [xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(3) for j in range(3)]


class _Conv3x3Gemm(torch.autograd.Function):
    """The patch GEMM with a backward that keeps only ``x``: it gathers the
    patches again for dW and adds dpatches back into one padded buffer,
    tap by tap, for dx (col2im), where autograd through the gather would
    keep the 9x patches and build a padded zero tensor a tap."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        xp, (ho, wo), _ = _pad_same_3x3(x, stride)
        return torch.cat(_patch_views(xp, ho, wo, stride), -1) @ w.reshape(-1, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, c = ctx.stride, x.shape[-1]
        xp, (ho, wo), (top, left) = _pad_same_3x3(x, s)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            cols = torch.cat(_patch_views(xp, ho, wo, s), -1).reshape(-1, 9 * c)
            dw = (cols.T @ g.reshape(-1, g.shape[-1])).reshape(w.shape)
            del cols
        if ctx.needs_input_grad[0]:
            dcols = g @ w.reshape(9 * c, -1).T
            dxp = torch.zeros_like(xp)
            for k, view in enumerate(_patch_views(dxp, ho, wo, s)):
                view += dcols[..., k * c:(k + 1) * c]
            dx = dxp[:, top:top + x.shape[1], left:left + x.shape[2]]
        return dx, dw, None


def conv3x3_gemm(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x``, HWIO 3x3 ``w`` -> NHWC with XLA's "SAME" padding, as
    :func:`..models.vit_adapter.conv2d`, computed as one matmul over the
    gathered 3x3 patches; every 3x3 conv of :func:`bev_backbone` runs here.
    On an H100 in fp32 (TF32 off) cuDNN runs SECOND's first BEV conv
    (256 -> 128 channels at 200 x 176) as an FFT convolution of 33,024
    per-frequency products, 192-374 ms at b = 1-4 with or without its
    algorithm search against 0.93-3.37 ms here, with a larger fp32 error
    in its backward (``scripts/bench_bev_conv.py``). The product is one cuBLAS
    GEMM; the patches (9 x the input at stride 1) live only inside the
    forward and the backward (:class:`_Conv3x3Gemm`)."""
    return _Conv3x3Gemm.apply(x, w, stride)


def bev_backbone(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """BaseBEVBackbone: NHWC [B, H, W, C] -> the concat of every block's
    up, resized to the first's size."""
    ups, target_hw = [], None
    for i, (_, stride) in enumerate(zip(cfg.bev_channels, cfg.bev_strides)):
        for j, blk in enumerate(params[f"block{i}"]):
            x = conv3x3_gemm(x, blk["w"], stride if j == 0 else 1)
            x = torch.relu(group_norm(x, blk["gn_scale"], blk["gn_bias"]))
        up = params[f"up{i}"]
        u = torch.relu(group_norm(conv2d(x, up["w"]), up["gn_scale"], up["gn_bias"]))
        if target_hw is None:
            target_hw = tuple(u.shape[1:3])
        elif tuple(u.shape[1:3]) != target_hw:
            u = resize(u, target_hw, "bilinear")
        ups.append(u)
    return torch.cat(ups, -1)


def anchor_head(params: Params, feat: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """AnchorHeadSingle: -> {cls_logits [B, A, C], box_deltas [B, A, 7],
    dir_logits [B, A, bins]}."""
    b = feat.shape[0]
    cls = conv2d(feat, params["cls_w"], params["cls_b"])
    box = conv2d(feat, params["box_w"], params["box_b"])
    dirc = conv2d(feat, params["dir_w"], params["dir_b"])
    return {"cls_logits": cls.reshape(b, -1, cfg.num_classes),
            "box_deltas": box.reshape(b, -1, cfg.box_code),
            "dir_logits": dirc.reshape(b, -1, cfg.dir_bins)}


def forward(params: Params, points: torch.Tensor, cfg: Detector3DConfig,
            points_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """points [B, N, in_features] -> the anchor head's predictions over the
    dense anchor grid."""
    bev = voxelize.pillar_vfe_apply(params["vfe"], points, cfg.vfe, points_mask)
    return anchor_head(params, bev_backbone(params, bev, cfg), cfg)


# --- target assignment and losses -------------------------------------------


@torch.no_grad()
def assign_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   matched_thr, unmatched_thr, gt_labels: Optional[torch.Tensor] = None,
                   anchor_cls: Optional[torch.Tensor] = None):
    """BEV-IoU anchor assignment (AxisAlignedTargetAssigner), batched:
    anchors [A, 7], gt [B, G, 7], gt_valid [B, G]; thresholds scalars or
    per anchor [A]. Where both ``gt_labels`` [B, G] and ``anchor_cls`` [A]
    are given, each anchor is matched only against ground truths of its
    class. -> (labels [B, A] in {-1 ignore, 0 background, 1 foreground},
    matched_gt_idx [B, A]).

    Each valid, class-compatible ground truth forces its best anchor to
    foreground. Two ground truths that share their best anchor resolve as
    XLA's scatter does on the CPU: the later one wins, even where it is a
    padding row that writes the anchor's old label back."""
    iou = iou3d.boxes_iou3d(anchors[None], gt_boxes)  # [B, A, G]
    keep = gt_valid[:, None, :]
    if gt_labels is not None and anchor_cls is not None:
        keep = keep & (gt_labels[:, None, :] == anchor_cls[None, :, None])
    iou = torch.where(keep, iou, -1.0)
    best_iou = iou.amax(-1)
    best_gt = iou.argmax(-1)  # the first index among ties, as jnp.argmax
    labels = torch.where(best_iou >= matched_thr, 1, torch.where(best_iou < unmatched_thr, 0, -1))
    force = gt_valid & keep.any(1)  # [B, G]
    best_anchor = iou.argmax(1)  # [B, G]
    labels = _scatter_last(labels, best_anchor,
                           torch.where(force, 1, labels.gather(1, best_anchor)))
    g = gt_boxes.shape[1]
    gidx = torch.arange(g, device=anchors.device).expand_as(best_anchor)
    best_gt = _scatter_last(best_gt, best_anchor,
                            torch.where(force, gidx, best_gt.gather(1, best_anchor)))
    return labels, best_gt


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax**2 / beta, ax - 0.5 * beta)


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: a label outside [0, n) is a row of zeros."""
    return (labels[..., None] == torch.arange(n, device=labels.device)).float()


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, C], idx [B, A] -> [B, A, C]."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def detection_loss(preds: Dict[str, torch.Tensor], anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_valid: torch.Tensor, cfg,
                   cls_weight: float = 1.0, box_weight: float = 2.0, dir_weight: float = 0.2,
                   gt_labels: Optional[torch.Tensor] = None):
    """Focal class loss + smooth-L1 box loss + direction-bin CE (the anchor
    head's losses), each a mean over the batch of per-sample sums over
    the foreground count. Multi-class: per-class assignment with per-class
    thresholds and one-hot focal targets over [A, num_classes].
    -> (total, {"cls", "box", "dir"})."""
    a_total = anchors.shape[0]
    dev = anchors.device
    multiclass = cfg.num_classes > 1
    if gt_labels is None:
        gt_labels = torch.zeros(gt_valid.shape, dtype=torch.long, device=dev)
    gt_labels = gt_labels.long()
    acls = torch.as_tensor(anchor_class_ids(cfg.anchors, a_total), device=dev)
    m_thr = torch.tensor(cfg.anchors.matched_thrs, dtype=torch.float32, device=dev)[acls]
    u_thr = torch.tensor(cfg.anchors.unmatched_thrs, dtype=torch.float32, device=dev)[acls]
    labels, gt_idx = assign_targets(anchors, gt_boxes, gt_valid, m_thr, u_thr,
                                    gt_labels if multiclass else None,
                                    acls if multiclass else None)
    fg, valid = labels == 1, labels >= 0
    n_fg = fg.sum(-1).float().clamp_min(1.0)  # [B]
    # focal loss (alpha 0.25, gamma 2), one-hot over num_classes
    p = torch.sigmoid(preds["cls_logits"])  # [B, A, C]
    t = _one_hot(gt_labels.gather(1, gt_idx), cfg.num_classes) * fg[..., None].float()
    pt = p * t + (1 - p) * (1 - t)
    alpha_t = 0.25 * t + 0.75 * (1 - t)
    ce = -torch.log(pt.clamp_min(1e-7))
    cls_loss = (alpha_t * (1 - pt) ** 2 * ce * valid[..., None]).sum((1, 2)) / n_fg
    # background and padding rows may hold zero-size boxes, whose encoding
    # is log(0): such rows take the anchor itself (delta 0)
    matched = torch.where(fg[..., None], _gather_rows(gt_boxes, gt_idx), anchors)
    target = encode_boxes(matched, anchors.expand_as(matched))
    box_deltas = preds["box_deltas"]
    # the sin-difference trick for the heading (pcdet add_sin_difference)
    box_err = torch.cat([box_deltas[..., :6] - target[..., :6],
                         torch.sin(box_deltas[..., 6] - target[..., 6])[..., None]], -1)
    box_loss = (smooth_l1(box_err) * fg[..., None]).sum((1, 2)) / n_fg
    dir_target = (torch.floor(matched[..., 6] / math.pi) % cfg.dir_bins).long()
    dir_ce = -F.log_softmax(preds["dir_logits"], -1).gather(-1, dir_target[..., None])[..., 0]
    dir_loss = (dir_ce * fg).sum(-1) / n_fg
    cl, bl, dl = cls_loss.mean(), box_loss.mean(), dir_loss.mean()
    total = cls_weight * cl + box_weight * bl + dir_weight * dl
    return total, {"cls": cl, "box": bl, "dir": dl}


@torch.no_grad()
def top_scores(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` highest scores' indices of each sample [B, k], highest
    first, ties to the lower index (``lax.top_k``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]


def predict(preds: Dict[str, torch.Tensor], anchors: torch.Tensor, cfg,
            score_thr: float = 0.1, iou_thr: float = 0.5, max_out: int = 128,
            nms_pre: int = 1024) -> List[Dict[str, torch.Tensor]]:
    """Post-processing: sigmoid -> the top ``nms_pre`` scores (pcdet
    NMS_PRE_MAXSIZE) -> decode -> direction bins -> rotated NMS. pcdet's
    default (MULTI_CLASSES_NMS False): the score is the max over classes,
    the label its argmax, one NMS for all. -> one dict a sample of tensors
    on the predictions' device: boxes [max_out, 7], scores, labels, valid
    [max_out]."""
    with torch.no_grad():
        probs = torch.sigmoid(preds["cls_logits"])  # [B, A, C]
        scores_all, labels_all = probs.amax(-1), probs.argmax(-1)
        k = min(nms_pre, scores_all.shape[1])
        top = top_scores(scores_all, k)  # [B, k]
        top_s = scores_all.gather(1, top)
        boxes = decode_boxes(_gather_rows(preds["box_deltas"], top), anchors[top])
        dir_bin = _gather_rows(preds["dir_logits"], top).argmax(-1)
        boxes = torch.cat([boxes[..., :6], (boxes[..., 6] + math.pi * dir_bin)[..., None]], -1)
        scores = torch.where(top_s >= score_thr, top_s, 0.0)
        idx, valid = iou3d.nms_bev(boxes, scores, iou_thr, max_out)
        sel_scores = scores.gather(1, idx)
        return [{"boxes": _gather_rows(boxes, idx)[i], "scores": sel_scores[i],
                 "labels": labels_all.gather(1, top).gather(1, idx)[i],
                 "valid": (valid & (sel_scores > 0))[i]}
                for i in range(boxes.shape[0])]

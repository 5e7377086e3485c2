"""CaDDN: the monocular camera 3D detector on categorical depth.

Port of ``metatransformer_tpu/models/caddn.py`` (pcdet's
``detectors/caddn.py``): a depth distribution network classifies each
feature pixel into LID depth bins; the frustum features are the outer
product of the reduced image features and the depth probabilities
(``ffn/depth_ffn.py``); every voxel centre of the lidar grid samples them
through the camera calibration (``f2v/frustum_grid_generator.py``); Z folds
into the channels and SECOND's BEV backbone and anchor head detect. Losses:
the anchor head's and a balanced focal CE on the depth bins.

As in the reference, the image backbone is a strided conv + GroupNorm
stack (:func:`..models.vit_adapter.conv2d`, ``group_norm``), not the
pretrained DeepLabV3, and the frustum sample is the nearest depth bin with
bilinear weights in (u, v) as explicit gathers, not ``grid_sample`` (which
would interpolate all three axes). The BEV backbone is
:func:`.detector3d.bev_backbone` (its 3x3 convs on the patch GEMM).

The rounding edges are the floors: :func:`depth_to_bin` floors a square
root, and :func:`frustum_floors` floors the pixel coordinates and the bins
of the voxel centres. Both take no gradient, so a caller can record them
from one run and replay them in another. At KITTI width the voxel grid is
280 x 376 x 25 x 64 fp32, 674 MB a sample; the sample runs a sample at a
time, and its backward is an ``index_add`` over the four corners.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models import detector3d
from metatransformer_tpu_torch.models.vit_adapter import _to, conv2d, group_norm
from metatransformer_tpu_torch.ops.gates import gated_relu

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CaDDNConfig:
    image_hw: Tuple[int, int] = (375, 1242)  # KITTI
    # DISCRETIZE (caddn.yaml): LID bins
    depth_min: float = 2.0
    depth_max: float = 46.8
    num_bins: int = 80
    # the image backbone and the frustum
    stem: Tuple[int, ...] = (32, 64, 128)  # stride-2 conv stack
    frustum_ch: int = 64  # CHANNEL_REDUCE out_channels
    # the voxel grid (X, Y, Z) over pc_range
    pc_range: Tuple[float, ...] = (2.0, -30.08, -3.0, 46.8, 30.08, 1.0)
    grid_size: Tuple[int, int, int] = (280, 376, 25)
    # BEV + head (detector3d's BaseBEVBackbone layout)
    bev_channels: Tuple[int, ...] = (64, 128)
    bev_strides: Tuple[int, int] = (1, 2)
    up_channels: int = 128
    bev_layer_num: int = 2
    anchors: detector3d.AnchorConfig = detector3d.AnchorConfig()
    num_classes: int = 1
    dir_bins: int = 2
    # losses
    depth_weight: float = 3.0
    fg_weight: float = 13.0
    bg_weight: float = 1.0

    @property
    def feat_stride(self) -> int:
        return 2 ** len(self.stem)

    @property
    def feat_hw(self) -> Tuple[int, int]:
        s = self.feat_stride
        return (-(-self.image_hw[0] // s), -(-self.image_hw[1] // s))

    @property
    def box_code(self) -> int:
        return 7

    @property
    def bev_hw(self) -> Tuple[int, int]:
        return (self.grid_size[1] // self.bev_strides[0], self.grid_size[0] // self.bev_strides[0])


# --- LID depth discretisation -----------------------------------------------


def _lid_bins(depth: torch.Tensor, cfg: CaDDNConfig) -> torch.Tensor:
    bin_size = 2 * (cfg.depth_max - cfg.depth_min) / (cfg.num_bins * (1 + cfg.num_bins))
    idx = -0.5 + 0.5 * torch.sqrt((1 + 8 * (depth - cfg.depth_min) / bin_size).clamp_min(0.0))
    idx = torch.floor(idx).long()
    return torch.where((idx < 0) | (idx >= cfg.num_bins) | ~torch.isfinite(depth),
                       cfg.num_bins, idx)


@torch.no_grad()
def depth_to_bin(depth: torch.Tensor, cfg: CaDDNConfig) -> torch.Tensor:
    """Continuous depth -> LID bin (transform_utils.bin_depths, mode LID);
    a depth out of range is bin ``num_bins``, the overflow class."""
    return _lid_bins(depth, cfg)


def bin_to_depth(idx: torch.Tensor, cfg: CaDDNConfig) -> torch.Tensor:
    """LID bin -> its centre depth (the inverse of :func:`depth_to_bin`)."""
    bin_size = 2 * (cfg.depth_max - cfg.depth_min) / (cfg.num_bins * (1 + cfg.num_bins))
    i = idx.float()
    return cfg.depth_min + bin_size / 2 * (i**2 + 2 * i + 0.5)


# --- parameters -------------------------------------------------------------


def _conv_init(randn, cin, cout):
    return {"w": randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin)), "b": torch.zeros(cout),
            "gn_scale": torch.ones(cout), "gn_bias": torch.zeros(cout)}


def init(cfg: CaDDNConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    randn = detector3d._randn(generator)
    params: Params = {}
    cin = 3
    for i, c in enumerate(cfg.stem):
        params[f"stem{i}"] = _conv_init(randn, cin, c)
        cin = c
    params["depth_head"] = {"w": randn(1, 1, cin, cfg.num_bins + 1) * cin**-0.5,
                            "b": torch.zeros(cfg.num_bins + 1)}
    params["reduce"] = {"w": randn(1, 1, cin, cfg.frustum_ch) * cin**-0.5,
                        "b": torch.zeros(cfg.frustum_ch)}
    cin = cfg.frustum_ch * cfg.grid_size[2]  # Z folded into the channels
    for i, cout in enumerate(cfg.bev_channels):
        params[f"block{i}"] = detector3d._bev_block_init(randn, cin, cout, cfg.bev_layer_num)
        params[f"up{i}"] = detector3d._up_init(randn, cout, cfg.up_channels)
        cin = cout
    params.update(detector3d._head_init(randn, cfg.up_channels * len(cfg.bev_channels), cfg))
    return _to(params, device)


# --- the frustum --------------------------------------------------------------


def image_backbone(params: Params, images: torch.Tensor, cfg: CaDDNConfig):
    """[B, H, W, 3] -> (features [B, H/s, W/s, C], depth_logits
    [B, H/s, W/s, D+1])."""
    x = images
    for i in range(len(cfg.stem)):
        p = params[f"stem{i}"]
        x = gated_relu(group_norm(conv2d(x, p["w"], p["b"], stride=2), p["gn_scale"],
                                  p["gn_bias"]))
    logits = conv2d(x, params["depth_head"]["w"], params["depth_head"]["b"])
    return gated_relu(conv2d(x, params["reduce"]["w"], params["reduce"]["b"])), logits


def frustum_features(feats: torch.Tensor, depth_logits: torch.Tensor) -> torch.Tensor:
    """depth_ffn.create_frustum_features -> [B, D, Hf, Wf, C]: the depth
    probabilities (overflow bin dropped) times the image features."""
    probs = torch.softmax(depth_logits, -1)[..., :-1]
    return torch.einsum("bhwd,bhwc->bdhwc", probs, feats)


def voxel_centres(cfg: CaDDNConfig, device, dtype=torch.float32) -> torch.Tensor:
    """Every voxel centre of the grid in lidar homogeneous coordinates
    [X * Y * Z, 4], X slowest."""
    r = cfg.pc_range
    axes = [r[i] + (torch.arange(g, device=device, dtype=dtype) + 0.5) * ((r[i + 3] - r[i]) / g)
            for i, g in enumerate(cfg.grid_size)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return torch.cat([grid, torch.ones_like(grid[:, :1])], -1)


def _projected(lidar_to_cam: torch.Tensor, cam_to_img: torch.Tensor, cfg: CaDDNConfig):
    """(depth, u / stride - 0.5, v / stride - 0.5) of every voxel centre,
    each [B, N]."""
    pts = voxel_centres(cfg, lidar_to_cam.device, lidar_to_cam.dtype)
    img = pts @ lidar_to_cam.transpose(1, 2) @ cam_to_img.transpose(1, 2)  # [B, N, 3]
    depth = img[..., 2]
    s = cfg.feat_stride
    return (depth, img[..., 0] / depth.clamp_min(1e-6) / s - 0.5,
            img[..., 1] / depth.clamp_min(1e-6) / s - 0.5)


@torch.no_grad()
def frustum_floors(lidar_to_cam: torch.Tensor, cam_to_img: torch.Tensor,
                   cfg: CaDDNConfig) -> Tuple[torch.Tensor, ...]:
    """The discrete half of the frustum sample (its rounding edges), each
    [B, N] over the voxel centres: (the depth bin, the floors u0 and v0 of
    the feature-pixel coordinates, inside the frustum)."""
    hf, wf = cfg.feat_hw
    depth, uf, vf = _projected(lidar_to_cam, cam_to_img, cfg)
    db = _lid_bins(depth, cfg)
    inside = ((depth > 0) & (db < cfg.num_bins) & (uf > -1) & (uf < wf) & (vf > -1)
              & (vf < hf))
    return (db.clamp(0, cfg.num_bins - 1), torch.floor(uf).long().clamp(0, wf - 1),
            torch.floor(vf).long().clamp(0, hf - 1), inside)


def frustum_to_voxel(frustum: torch.Tensor, lidar_to_cam: torch.Tensor,
                     cam_to_img: torch.Tensor, cfg: CaDDNConfig) -> torch.Tensor:
    """Sample the frustum volume [B, D, Hf, Wf, C] at every voxel centre ->
    [B, X, Y, Z, C] (frustum_grid_generator + grid_sample): the nearest
    depth bin, bilinear in (u, v); zero outside the frustum. A sample at a
    time."""
    b, d, hf, wf, c = frustum.shape
    db, u0, v0, inside = frustum_floors(lidar_to_cam, cam_to_img, cfg)
    with torch.no_grad():
        _, uf, vf = _projected(lidar_to_cam, cam_to_img, cfg)
    u1, v1 = (u0 + 1).clamp(0, wf - 1), (v0 + 1).clamp(0, hf - 1)
    wu = (uf - u0).clamp(0.0, 1.0)
    wv = (vf - v0).clamp(0.0, 1.0)
    outs = []
    for i in range(b):
        vol = frustum[i].reshape(d * hf * wf, c)
        base = db[i] * hf
        out = None
        for v, u, wgt in ((v0[i], u0[i], (1 - wu[i]) * (1 - wv[i])),
                          (v0[i], u1[i], wu[i] * (1 - wv[i])),
                          (v1[i], u0[i], (1 - wu[i]) * wv[i]),
                          (v1[i], u1[i], wu[i] * wv[i])):
            term = vol.index_select(0, (base + v) * wf + u) * wgt[:, None]
            out = term if out is None else out + term
        outs.append(out * inside[i, :, None])
    return torch.stack(outs).reshape(b, *cfg.grid_size, c)


def forward(params: Params, images: torch.Tensor, lidar_to_cam: torch.Tensor,
            cam_to_img: torch.Tensor, cfg: CaDDNConfig):
    """-> (the anchor head's predictions over the BEV grid, depth_logits)."""
    feats, depth_logits = image_backbone(params, images, cfg)
    vox = frustum_to_voxel(frustum_features(feats, depth_logits), lidar_to_cam, cam_to_img, cfg)
    b, gx, gy, gz, c = vox.shape
    bev = vox.permute(0, 2, 1, 3, 4).reshape(b, gy, gx, gz * c)  # height compression
    feat = detector3d.bev_backbone(params, bev, cfg)
    return detector3d.anchor_head(params, feat, cfg), depth_logits


def depth_loss(depth_logits: torch.Tensor, depth_maps: torch.Tensor, fg_mask: torch.Tensor,
               cfg: CaDDNConfig) -> torch.Tensor:
    """Focal CE on the LID bins with foreground / background balancing
    (ddn_loss, balancer.py: weights 13 and 1, over the summed weights)."""
    target = depth_to_bin(depth_maps, cfg)
    ce = -F.log_softmax(depth_logits, -1).gather(-1, target[..., None])[..., 0]
    focal = (1 - torch.exp(-ce)) ** 2 * ce
    w = torch.where(fg_mask, cfg.fg_weight, cfg.bg_weight)
    return (focal * w).sum() / w.sum().clamp_min(1.0)


def generate_anchors(cfg: CaDDNConfig) -> np.ndarray:
    """The anchors of every BEV cell -> [A, 7] (x, y, z, l, w, h, r): y
    slowest, then x, class, rotation; each class at its own z centre."""
    fy, fx = cfg.bev_hw
    r = cfg.pc_range
    xs = np.linspace(r[0], r[3], fx, endpoint=False) + (r[3] - r[0]) / fx / 2
    ys = np.linspace(r[1], r[4], fy, endpoint=False) + (r[4] - r[1]) / fy / 2
    a = cfg.anchors
    per_cell = np.asarray([[a.z_centers[ci], l, w, h, rot] for ci, (l, w, h) in enumerate(a.sizes)
                           for rot in a.rotations])
    k = len(per_cell)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    xy = np.stack([xx, yy], -1).reshape(-1, 1, 2).repeat(k, 1)
    cells = np.broadcast_to(per_cell, (fy * fx, k, 5))
    return np.concatenate([xy, cells], -1).reshape(-1, 7).astype(np.float32)


def training_loss(params: Params, images: torch.Tensor, lidar_to_cam: torch.Tensor,
                  cam_to_img: torch.Tensor, depth_maps: torch.Tensor, fg_mask: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                  cfg: CaDDNConfig):
    """loss_rpn + depth_weight x loss_depth (caddn.get_training_loss) ->
    (total, logs)."""
    preds, depth_logits = forward(params, images, lidar_to_cam, cam_to_img, cfg)
    rpn, logs = detector3d.detection_loss(preds, anchors, gt_boxes, gt_valid, cfg)
    dl = depth_loss(depth_logits, depth_maps, fg_mask, cfg)
    return rpn + cfg.depth_weight * dl, {**logs, "depth": dl}

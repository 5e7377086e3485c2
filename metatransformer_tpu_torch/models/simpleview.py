"""SimpleView (MVModel): 6-view depth-projection classification.

Port of ``metatransformer_tpu/models/simpleview.py``
(``PointCloud/openpoints/models/backbone/simpleview.py`` and
``simpleview_util.py``):

- PCViews: six fixed camera poses (four 90-degree yaw steps, top and
  bottom) at z = -1.4; each cloud rotated into every view and
  perspective-projected;
- points2depth: each point's depth splatted on a ``size_xy`` ceil patch
  (1 x 1, as ``get_img``) with weight 1 / depth, summed by two
  ``index_add_`` over the flattened (view, pixel) axis and normalised by
  the summed weight. On a CUDA device the sums run in no fixed order, so
  the image's last bits vary from run to run. Each tap's pixel is
  :func:`view_pixels`, a named function without gradient, so a caller can
  record and replay it;
- the image trunk: a 3x3 stem and the four BasicBlock stages of a narrow
  ResNet-18 (widths c .. 8c, stride 2 from stage 2), then the global
  average;
- MVFC fusion: a per-view BatchNorm of the features, the V features
  flattened, linear -> BN -> ReLU -> linear logits.

BatchNorm is tier 1's train-mode batch statistics (:mod:`.point_baselines`).
Every conv is XLA's "SAME" conv (asymmetric padding at stride 2) on cuDNN
(:func:`.vit_adapter.conv2d`, TF32 off): on an H100 the recipe's step at
b = 32 (192 depth images of 128^2, 16-128 channels) takes 96.73-97.01 ms
with its 3x3 convs on cuDNN against 127.75-128.01 ms on
:func:`.detector3d.conv3x3_gemm`'s patch GEMM (``chip_smoke.py``
``_simpleview_conv_times``). Registered as ``SimpleView``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _init_on, _randn, _register_entries, _relu,
)
from metatransformer_tpu_torch.models.point_multiview import euler2mat
from metatransformer_tpu_torch.models.vit_adapter import conv2d

TRANS = -1.4
_VIEW_ANGLES = np.asarray([[0 * np.pi / 2, 0, np.pi / 2], [1 * np.pi / 2, 0, np.pi / 2],
                           [2 * np.pi / 2, 0, np.pi / 2], [3 * np.pi / 2, 0, np.pi / 2],
                           [0, -np.pi / 2, np.pi / 2], [0, np.pi / 2, np.pi / 2]], np.float32)


@dataclasses.dataclass(frozen=True)
class SimpleViewConfig:
    num_classes: int = 15  # ScanObjectNN, the reference's default
    channels: int = 16
    resolution: int = 128
    size_xy: int = 1  # the splat patch (get_img uses 1 x 1)
    blocks_per_stage: int = 2


@torch.no_grad()
def view_pixels(x: torch.Tensor, y: torch.Tensor, depth: torch.Tensor, resolution: int,
                size_xy: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The discrete half of the splat: pixel coordinates x, y and depth
    [V, N] -> (the flat pixel of each tap [V, N, s, s], which taps land on
    the canvas in front of the camera). A point within rounding of a pixel
    edge can land either side on another device."""
    h = w = resolution
    s = size_xy
    taps = torch.arange(-s / 2, s / 2, dtype=x.dtype, device=x.device)  # [-2, -1, 0, 1] at s = 4
    ex = torch.ceil(x[:, :, None, None] + taps[None, None, :, None])
    ey = torch.ceil(y[:, :, None, None] + taps[None, None, None, :])
    ex, ey = torch.broadcast_tensors(ex, ey)
    mask = ((ex >= 0) & (ex <= h - 1) & (ey >= 0) & (ey <= w - 1)
            & (depth[:, :, None, None] >= 0))
    # jnp's float % is a floor modulo: torch.remainder, not fmod
    cell = torch.remainder(ex, h).long() * w + torch.remainder(ey, w).long()
    return torch.where(mask, cell, 0), mask  # a masked tap adds 0; its index kept in range


def project_views(points: torch.Tensor, resolution: int, size_xy: int = 1) -> torch.Tensor:
    """[B, N, 3] -> depth images [B*6, R, R] (PCViews.get_img +
    points2depth)."""
    b, n, _ = points.shape
    dev, dt = points.device, points.dtype
    rot = euler2mat(torch.as_tensor(_VIEW_ANGLES, device=dev)).transpose(1, 2).to(dt)
    # point_transform: points @ rot - translation, view-major within a cloud
    pts = points.repeat_interleave(6, 0) @ rot.repeat(b, 1, 1)
    pts = pts - torch.tensor([0.0, 0.0, TRANS], dtype=dt, device=dev)
    h = w = resolution
    eps = 1e-12
    depth = pts[..., 2]
    x = (pts[..., 0] / (depth + eps) * (w / h) + 1) * h / 2
    y = (pts[..., 1] / (depth + eps) + 1) * w / 2
    cell, mask = view_pixels(x, y, depth, resolution, size_xy)
    val = depth[:, :, None, None].expand(cell.shape)
    weight = mask.to(dt) / (val + eps)
    slot = (cell + (torch.arange(b * 6, device=dev) * (h * w))[:, None, None, None]).reshape(-1)
    ws = torch.zeros(b * 6 * h * w, dtype=dt, device=dev).index_add_(0, slot, weight.reshape(-1))
    vs = torch.zeros_like(ws).index_add_(0, slot, (val * weight).reshape(-1))
    return (vs / torch.where(ws == 0, 1.0, ws)).reshape(b * 6, h, w)


def _conv_init(randn, k: int, cin: int, cout: int) -> Params:
    return {"w": randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin)),
            "bn_scale": torch.ones(cout), "bn_bias": torch.zeros(cout)}


def _conv(p: Params, x: torch.Tensor, stride: int = 1, act: bool = True) -> torch.Tensor:
    y = _bn(conv2d(x, p["w"], stride=stride), p["bn_scale"], p["bn_bias"])
    return _relu(y) if act else y


def _basic_block_init(randn, cin: int, cout: int) -> Params:
    p = {"c1": _conv_init(randn, 3, cin, cout), "c2": _conv_init(randn, 3, cout, cout)}
    if cin != cout:
        p["down"] = _conv_init(randn, 1, cin, cout)
    return p


def _basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = _conv(p["c2"], _conv(p["c1"], x, stride), 1, act=False)
    sc = _conv(p["down"], x, stride, act=False) if "down" in p else x
    return _relu(h + sc)


def init(cfg: SimpleViewConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    def build():
        randn = _randn(generator)
        c = cfg.channels
        params: Params = {"stem": _conv_init(randn, 3, 1, c)}
        cin = c
        for si, mult in enumerate((1, 2, 4, 8)):
            cout = c * mult
            params[f"stage{si}"] = [_basic_block_init(randn, cin if bi == 0 else cout, cout)
                                    for bi in range(cfg.blocks_per_stage)]
            cin = cout
        f = cin  # 8c
        params["fuse_bn_scale"], params["fuse_bn_bias"] = torch.ones(f), torch.zeros(f)
        params["fc1"] = {"w": randn(6 * f, f) * np.sqrt(1.0 / (6 * f)), "b": torch.zeros(f),
                         "bn_scale": torch.ones(f), "bn_bias": torch.zeros(f)}
        params["fc2"] = {"w": randn(f, cfg.num_classes) * np.sqrt(1.0 / f),
                         "b": torch.zeros(cfg.num_classes)}
        return params

    return _init_on(device, build)


def forward(params: Params, points: torch.Tensor, cfg: SimpleViewConfig) -> torch.Tensor:
    b = points.shape[0]
    x = project_views(points[..., :3], cfg.resolution, cfg.size_xy)[..., None]  # [B*6, R, R, 1]
    x = _conv(params["stem"], x)
    for si in range(4):
        for bi, blk in enumerate(params[f"stage{si}"]):
            x = _basic_block(blk, x, 2 if (si > 0 and bi == 0) else 1)
    # MVFC: a per-view BN, the views flattened, fc-bn-relu-fc
    feat = _bn(x.mean((1, 2)), params["fuse_bn_scale"], params["fuse_bn_bias"]).reshape(b, -1)
    f1 = params["fc1"]
    h = _relu(_bn(feat @ f1["w"] + f1["b"], f1["bn_scale"], f1["bn_bias"]))
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def _register() -> None:
    _register_entries({"SimpleView": (init, forward, SimpleViewConfig)})


_register()

"""PointTransformer segmentation U-Net (PTSeg), the S3DIS vector-attention
baseline.

Port of ``metatransformer_tpu/models/point_transformer_seg.py``
(``PointCloud/openpoints/models/backbone/pointtransformer.py``), in the
dense batch layout [B, N, C]:

- vector attention over the kNN neighbourhood: per-neighbour weight
  vectors over ``share_planes`` groups, the position encoding added to
  the logits and the values, a softmax over the neighbours;
- TransitionDown: FPS (:func:`..ops.point_ops.furthest_point_sample`, the
  FPS kernel on the card) + kNN group + linear + max
  (:func:`.point_baselines.pool_max`); TransitionUp: 3-NN interpolation
  fusion, with the global-pool variant for the bottleneck;
- five stages at strides 1, 4, 4, 4, 4 and a symmetric decoder.

BatchNorm is tier 1's train-mode batch statistics; every ReLU takes its
gradient through :func:`..ops.gates.act_gate`. Registered as
``PointTransformerSeg``: ``forward(params, points [B, N, 3], cfg,
features=None) -> [B, N, num_classes]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _dense_init, _init_on, _randn, _register_entries, _relu, pool_max,
)
from metatransformer_tpu_torch.ops import point_interp, point_ops as po


@dataclasses.dataclass(frozen=True)
class PointTransformerSegConfig:
    """A 5-stage encoder (strides 1, 4, 4, 4, 4) and a symmetric decoder.
    ``blocks[i]`` counts a stage's blocks with its transition's slot, so
    blocks = 2 is a transition and one attention block."""

    num_classes: int = 13
    in_channels: int = 3  # feature channels (the S3DIS recipe: 6)
    width: int = 32
    blocks: Tuple[int, ...] = (2, 2, 2, 2, 2)
    strides: Tuple[int, ...] = (1, 4, 4, 4, 4)
    nsample: Tuple[int, ...] = (8, 16, 16, 16, 16)
    share_planes: int = 8

    @property
    def planes(self) -> Tuple[int, ...]:
        return tuple(self.width * 2**i for i in range(len(self.blocks)))


def _linear_init(randn, cin: int, cout: int) -> Params:
    return {"w": randn(cin, cout) * np.sqrt(2.0 / cin)}


def _bn_relu(x, p: Params):
    return _relu(_bn(x @ p["w"], p["bn_scale"], p["bn_bias"]))


def _pt_layer_init(randn, c: int, s: int) -> Params:
    return {
        "q": _linear_init(randn, c, c),
        "k": _linear_init(randn, c, c),
        "v": _linear_init(randn, c, c),
        # linear_p: Linear(3, 3) + BN + ReLU + Linear(3, c)
        "p1": _dense_init(randn, 3, 3),
        "p2": _linear_init(randn, 3, c),
        # linear_w: BN + ReLU, Linear(c, c / s), BN + ReLU, Linear(c / s, c / s)
        "w_bn0_scale": torch.ones(c),
        "w_bn0_bias": torch.zeros(c),
        "w1": _dense_init(randn, c, c // s),
        "w2": _linear_init(randn, c // s, c // s),
    }


def _pt_layer(p: Params, xyz, x, nidx, s: int):
    """Vector attention over the kNN neighbourhood."""
    q, k, v = x @ p["q"]["w"], x @ p["k"]["w"], x @ p["v"]["w"]
    kj, vj = po.gather_points(k, nidx), po.gather_points(v, nidx)  # [B, N, K, C]
    pr = po.gather_points(xyz, nidx) - xyz[:, :, None, :]
    pr = _bn_relu(pr, p["p1"]) @ p["p2"]["w"]  # [B, N, K, C]
    w = _relu(_bn(kj - q[:, :, None, :] + pr, p["w_bn0_scale"], p["w_bn0_bias"]))
    w = torch.softmax(_bn_relu(w, p["w1"]) @ p["w2"]["w"], dim=2)  # over the neighbours
    b, n, kk, c = vj.shape
    agg = (vj + pr).reshape(b, n, kk, s, c // s) * w[:, :, :, None, :]
    return agg.sum(2).reshape(b, n, c)


def _pt_block_init(randn, c: int, s: int) -> Params:
    return {"lin1": _dense_init(randn, c, c), "attn": _pt_layer_init(randn, c, s),
            "bn2_scale": torch.ones(c), "bn2_bias": torch.zeros(c),
            "lin3": _dense_init(randn, c, c)}


def _pt_block(p: Params, xyz, x, nidx, s: int):
    """The residual vector-attention block."""
    h = _bn_relu(x, p["lin1"])
    h = _relu(_bn(_pt_layer(p["attn"], xyz, h, nidx, s), p["bn2_scale"], p["bn2_bias"]))
    h = _bn(h @ p["lin3"]["w"], p["lin3"]["bn_scale"], p["lin3"]["bn_bias"])
    return _relu(x + h)


def init(cfg: PointTransformerSegConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    def build():
        randn = _randn(generator)
        params: Params = {}
        s, cin, planes = cfg.share_planes, cfg.in_channels, cfg.planes
        for i, c in enumerate(planes):
            # a strided stage groups 3 + cin, a stride-1 stage is a linear
            params[f"enc{i}_down"] = _dense_init(randn, cin + 3 if cfg.strides[i] != 1 else cin, c)
            params[f"enc{i}_blocks"] = [_pt_block_init(randn, c, s)
                                        for _ in range(cfg.blocks[i] - 1)]
            cin = c
        top = len(planes) - 1
        params["dec_head_lin2"] = _dense_init(randn, planes[top], planes[top])
        params["dec_head_lin1"] = _dense_init(randn, 2 * planes[top], planes[top])
        params["dec_head_blocks"] = [_pt_block_init(randn, planes[top], s)]
        for i in range(top - 1, -1, -1):
            params[f"dec{i}_lin1"] = _dense_init(randn, planes[i], planes[i])
            params[f"dec{i}_lin2"] = _dense_init(randn, planes[i + 1], planes[i])
            params[f"dec{i}_blocks"] = [_pt_block_init(randn, planes[i], s)]
        params["cls1"] = _dense_init(randn, planes[0], planes[0])
        params["cls2"] = {"w": randn(planes[0], cfg.num_classes) * np.sqrt(1.0 / planes[0]),
                          "b": torch.zeros(cfg.num_classes)}
        return params

    return _init_on(device, build)


def _knn_idx(xyz, k: int):
    return po.knn(xyz, xyz, min(k, xyz.shape[1]))[1]


def forward(params: Params, points: torch.Tensor, cfg: PointTransformerSegConfig,
            features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B, N, 3] (features [B, N, in_channels], else the
    coordinates) -> per-point logits [B, N, num_classes]."""
    xyz = points[..., :3]
    x = xyz if features is None else features
    s = cfg.share_planes

    stages, n = [], xyz.shape[1]
    for i in range(len(cfg.planes)):
        dn = params[f"enc{i}_down"]
        if cfg.strides[i] != 1:
            m = max(n // cfg.strides[i], 4)
            centers = po.gather_points(xyz, po.furthest_point_sample(xyz, m))
            _, nidx = po.knn(centers, xyz, min(cfg.nsample[i], n))
            dp, fj = po.group_points(centers, xyz, nidx, x)
            x = pool_max(_bn_relu(torch.cat([dp, fj], -1), dn), 2)
            xyz, n = centers, m
        else:
            x = _bn_relu(x, dn)
        nidx = _knn_idx(xyz, cfg.nsample[i])
        for blk in params[f"enc{i}_blocks"]:
            x = _pt_block(blk, xyz, x, nidx, s)
        stages.append((xyz, x))

    top = len(cfg.planes) - 1
    xyz_c, x_c = stages[top]
    # the bottleneck's TransitionUp: concat a broadcast global summary
    g = _bn_relu(x_c.mean(1), params["dec_head_lin2"])
    x_c = _bn_relu(torch.cat([x_c, g[:, None, :].expand_as(x_c)], -1), params["dec_head_lin1"])
    nidx = _knn_idx(xyz_c, cfg.nsample[top])
    for blk in params["dec_head_blocks"]:
        x_c = _pt_block(blk, xyz_c, x_c, nidx, s)
    for i in range(top - 1, -1, -1):
        xyz_f, x_f = stages[i]
        up = point_interp.three_interpolation(xyz_f, xyz_c, _bn_relu(x_c, params[f"dec{i}_lin2"]))
        x_c = _bn_relu(x_f, params[f"dec{i}_lin1"]) + up
        xyz_c = xyz_f
        nidx = _knn_idx(xyz_c, cfg.nsample[i])
        for blk in params[f"dec{i}_blocks"]:
            x_c = _pt_block(blk, xyz_c, x_c, nidx, s)

    h = _bn_relu(x_c, params["cls1"])
    return h @ params["cls2"]["w"] + params["cls2"]["b"]


def _register() -> None:
    _register_entries({"PointTransformerSeg": (init, forward, PointTransformerSegConfig)})


_register()

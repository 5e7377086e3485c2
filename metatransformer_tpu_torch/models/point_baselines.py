"""The point-cloud baseline zoo, tier 1: PointNet++ (MSG), DGCNN, PointMLP
and PointNeXt.

Port of ``metatransformer_tpu/models/point_baselines.py`` (the reference's
vendored comparison baselines, ``PointCloud/openpoints/models/backbone/
{pointnetv2,dgcnn,pointmlp,pointnext}.py``):

- FPS, ball query, kNN and grouping are :mod:`..ops.point_ops` (FPS is the
  hand-written CUDA kernel on the card);
- BatchNorm is train-mode batch statistics over every axis but the
  channels, with the population variance and eps 1e-3, in training and in
  evaluation alike (no running statistics), as the reference's pure
  function;
- a per-point "1x1 conv" is a matmul over the channel axis;
- every max-pool is :func:`pool_max`: the value of ``amax``, whose gradient
  goes to the elements :func:`max_winners` names and splits a tie evenly,
  as ``jnp.max`` (a ball query repeats its first hit in empty slots);
- every ReLU and leaky ReLU is :func:`_relu` / :func:`_lrelu`, the gradient
  through :func:`..ops.gates.act_gate`.

Which element wins a near-tie is a choice at a rounding edge, as on which
side of 0 an activation's input falls: each flip between fp32 on two
devices or against float64 moves the gradient of a whole BatchNorm
channel. So it sits in :func:`max_winners`, without gradient, where a check
can record and replay it.

All four register in :data:`..utils.registry.MODELS` with one classifier
contract: ``forward(params, points [B, N, 3], cfg) -> logits [B, C]``; each
``*_init(cfg, generator, device)`` draws from a ``torch.Generator`` on the
CPU and moves the tree to ``device`` (None: the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.vit_adapter import _to
from metatransformer_tpu_torch.ops import point_ops as po
from metatransformer_tpu_torch.ops.gates import gated

Params = Dict[str, Any]


def _randn(generator: torch.Generator):
    return lambda *s: torch.randn(*s, generator=generator)


def _dense_init(randn, cin: int, cout: int) -> Params:
    return {"w": randn(cin, cout) * np.sqrt(2.0 / cin), "bn_scale": torch.ones(cout),
            "bn_bias": torch.zeros(cout)}


def _bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-3
        ) -> torch.Tensor:
    """BatchNorm1d with train-mode statistics over every axis but channels."""
    axes = tuple(range(x.dim() - 1))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def max_winners(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Where ``x`` reaches its maximum along ``dim``, every tie included:
    a bool mask of ``x``'s shape. No gradient."""
    with torch.no_grad():
        return x == x.amax(dim, keepdim=True)


class _PoolMax(torch.autograd.Function):
    """``amax`` whose backward splits the gradient evenly over the given
    winners; it keeps only the bool mask."""

    @staticmethod
    def forward(ctx, x, winners, dim):
        ctx.save_for_backward(winners)
        ctx.dim = dim
        return x.amax(dim)

    @staticmethod
    def backward(ctx, g):
        (winners,) = ctx.saved_tensors
        w = winners.to(g.dtype)
        return g.unsqueeze(ctx.dim) * w / w.sum(ctx.dim, keepdim=True), None, None


def pool_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The max-pool over ``dim``: ``x.amax(dim)``, the gradient to
    :func:`max_winners`."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.amax(dim)
    dim = dim % x.dim()
    return _PoolMax.apply(x, max_winners(x.detach(), dim), dim)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``torch.relu``, the gradient through ``gates.act_gate``."""
    return gated(x, 0.0)


def _mlp(x: torch.Tensor, stack: List[Params], act=_relu) -> torch.Tensor:
    for p in stack:
        x = act(_bn(x @ p["w"], p["bn_scale"], p["bn_bias"]))
    return x


def _mlp_init(randn, cin: int, widths) -> List[Params]:
    stack = []
    for w in widths:
        stack.append(_dense_init(randn, cin, w))
        cin = w
    return stack


def _head_init(randn, cin: int, fcs, num_classes: int) -> Params:
    last = fcs[-1] if fcs else cin
    return {"fcs": _mlp_init(randn, cin, fcs),
            "out_w": randn(last, num_classes) * np.sqrt(1.0 / last),
            "out_b": torch.zeros(num_classes)}


def _head(x: torch.Tensor, params: Params) -> torch.Tensor:
    return _mlp(x, params["fcs"]) @ params["out_w"] + params["out_b"]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """``F.leaky_relu(x, 0.2)``, the gradient through ``gates.act_gate``."""
    return gated(x, 0.2)


def _init_on(device: _device.Device, build) -> Params:
    """``build()``'s tree (drawn on the CPU) on ``device`` (None: the card)."""
    device = _device.resolve(device)
    return _to(build(), device)


# ---------------------------------------------------------------------------
# PointNet++ (MSG): openpoints/models/backbone/pointnetv2.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SAMSGStage:
    npoint: int
    radii: Tuple[float, ...]
    nsamples: Tuple[int, ...]
    mlps: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class PointNet2Config:
    """The classic MSG classification assembly (pointnetv2.py
    PointNet2Encoder: SA stages -> global SA -> FC head)."""

    num_classes: int = 40
    stages: Tuple[SAMSGStage, ...] = (
        SAMSGStage(512, (0.1, 0.2, 0.4), (16, 32, 128),
                   ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
        SAMSGStage(128, (0.2, 0.4, 0.8), (32, 64, 128),
                   ((64, 64, 128), (128, 128, 256), (128, 128, 256))),
    )
    global_mlp: Tuple[int, ...] = (256, 512, 1024)
    head_fcs: Tuple[int, ...] = (512, 256)


def pointnet2_init(cfg: PointNet2Config, generator: torch.Generator,
                   device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {}
        cin = 0  # the first stage groups xyz only
        for si, st in enumerate(cfg.stages):
            params[f"sa{si}"] = [_mlp_init(randn, cin + 3, mlp) for mlp in st.mlps]
            cin = sum(m[-1] for m in st.mlps)
        params["global"] = _mlp_init(randn, cin + 3, cfg.global_mlp)
        params["head"] = _head_init(randn, cfg.global_mlp[-1], cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def _sa_msg(branches, st: SAMSGStage, xyz, feats):
    """One multi-scale-grouping set-abstraction level."""
    centers = po.gather_points(xyz, po.furthest_point_sample(xyz, st.npoint))
    outs = []
    for branch, radius, k in zip(branches, st.radii, st.nsamples):
        dp, fj = po.group_points(centers, xyz, po.ball_query(centers, xyz, radius, k), feats)
        g = dp if fj is None else torch.cat([dp, fj], -1)
        outs.append(pool_max(_mlp(g, branch), 2))
    return centers, torch.cat(outs, -1)


def pointnet2_forward(params: Params, points: torch.Tensor, cfg: PointNet2Config) -> torch.Tensor:
    xyz, feats = points[..., :3], None
    for si, st in enumerate(cfg.stages):
        xyz, feats = _sa_msg(params[f"sa{si}"], st, xyz, feats)
    # the global SA: group_all -> MLP -> max (pointnetv2's group_all stage)
    g = torch.cat([xyz - xyz.mean(1, keepdim=True), feats], -1)
    return _head(pool_max(_mlp(g, params["global"]), 1), params["head"])


# ---------------------------------------------------------------------------
# DGCNN: openpoints/models/backbone/dgcnn.py (the EdgeConv stack)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DGCNNConfig:
    num_classes: int = 40
    k: int = 20
    edge_channels: Tuple[int, ...] = (64, 64, 128, 256)
    emb_dim: int = 1024
    head_fcs: Tuple[int, ...] = (512, 256)


def dgcnn_init(cfg: DGCNNConfig, generator: torch.Generator,
               device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {}
        cin = 3
        for i, c in enumerate(cfg.edge_channels):
            params[f"edge{i}"] = _dense_init(randn, 2 * cin, c)
            cin = c
        params["emb"] = _dense_init(randn, sum(cfg.edge_channels), cfg.emb_dim)
        params["head"] = _head_init(randn, 2 * cfg.emb_dim, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def _edge_conv(p: Params, x: torch.Tensor, k: int) -> torch.Tensor:
    """EdgeConv: a dynamic kNN graph in feature space (self included),
    h([x_j - x_i, x_i]), max over the neighbours (dgcnn.py
    get_graph_feature + conv)."""
    _, idx = po.knn(x, x, k)
    xj = po.gather_points(x, idx)  # [B, N, k, C]
    xi = x[:, :, None, :].expand_as(xj)
    e = _lrelu(_bn(torch.cat([xj - xi, xi], -1) @ p["w"], p["bn_scale"], p["bn_bias"]))
    return pool_max(e, 2)


def dgcnn_forward(params: Params, points: torch.Tensor, cfg: DGCNNConfig) -> torch.Tensor:
    x = points[..., :3]
    outs = []
    for i in range(len(cfg.edge_channels)):
        x = _edge_conv(params[f"edge{i}"], x, cfg.k)
        outs.append(x)
    p = params["emb"]
    h = _lrelu(_bn(torch.cat(outs, -1) @ p["w"], p["bn_scale"], p["bn_bias"]))
    return _head(torch.cat([pool_max(h, 1), h.mean(1)], -1), params["head"])


# ---------------------------------------------------------------------------
# PointMLP: openpoints/models/backbone/pointmlp.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointMLPConfig:
    """Geometric-affine grouping, residual point-MLP pre / pos blocks a
    stage, FPS stride-2 downsampling (the pointMLP-elite geometry)."""

    num_classes: int = 40
    embed_dim: int = 32
    k: int = 24
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    pre_blocks: int = 1
    pos_blocks: int = 1
    head_fcs: Tuple[int, ...] = (512, 256)


def _res_block_init(randn, c: int) -> Params:
    return {"fc1": _dense_init(randn, c, c), "fc2": _dense_init(randn, c, c)}


def _res_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _relu(_bn(x @ p["fc1"]["w"], p["fc1"]["bn_scale"], p["fc1"]["bn_bias"]))
    return _relu(x + _bn(h @ p["fc2"]["w"], p["fc2"]["bn_scale"], p["fc2"]["bn_bias"]))


def pointmlp_init(cfg: PointMLPConfig, generator: torch.Generator,
                  device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {"embed": _dense_init(randn, 3, cfg.embed_dim)}
        cin = cfg.embed_dim
        for si, c in enumerate(cfg.stage_channels):
            params[f"affine{si}"] = {"alpha": torch.ones(1, 1, 1, cin),
                                     "beta": torch.zeros(1, 1, 1, cin)}
            params[f"transfer{si}"] = _dense_init(randn, 2 * cin, c)
            params[f"pre{si}"] = [_res_block_init(randn, c) for _ in range(cfg.pre_blocks)]
            params[f"pos{si}"] = [_res_block_init(randn, c) for _ in range(cfg.pos_blocks)]
            cin = c
        params["head"] = _head_init(randn, cin, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def pointmlp_forward(params: Params, points: torch.Tensor, cfg: PointMLPConfig) -> torch.Tensor:
    xyz = points[..., :3]
    p = params["embed"]
    x = _relu(_bn(xyz @ p["w"], p["bn_scale"], p["bn_bias"]))
    n = xyz.shape[1]
    for si in range(len(cfg.stage_channels)):
        m = max(n // 2, 4)
        idx = po.furthest_point_sample(xyz, m)
        centers = po.gather_points(xyz, idx)
        center_f = po.gather_points(x, idx)  # [B, M, C]
        _, nidx = po.knn(centers, xyz, cfg.k)
        fj = po.gather_points(x, nidx)  # [B, M, K, C]
        # the geometric affine: the neighbourhood normalised by its std
        # about the centre feature, learnable alpha / beta (LocalGrouper)
        diff = fj - center_f[:, :, None, :]
        std = diff.std(dim=(1, 2, 3), keepdim=True, correction=0)
        aff = params[f"affine{si}"]
        g = aff["alpha"] * diff / (std + 1e-5) + aff["beta"]
        g = torch.cat([g, center_f[:, :, None, :].expand_as(fj)], -1)
        t = params[f"transfer{si}"]
        g = _relu(_bn(g @ t["w"], t["bn_scale"], t["bn_bias"]))
        for blk in params[f"pre{si}"]:
            b_, m_, k_, c_ = g.shape
            g = _res_block(blk, g.reshape(b_ * m_, k_, c_)).reshape(b_, m_, k_, c_)
        x = pool_max(g, 2)
        for blk in params[f"pos{si}"]:
            x = _res_block(blk, x)
        xyz, n = centers, m
    return _head(pool_max(x, 1), params["head"])


# ---------------------------------------------------------------------------
# PointNeXt: openpoints/models/backbone/pointnext.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointNeXtConfig:
    """The PointNeXt-S assembly: an MLP stem, 4 SA-downsample stages each
    followed by InvResMLP blocks (an expansion-4 inverted residual with a
    grouped spatial max), the radius doubling a stage."""

    num_classes: int = 40
    stem_dim: int = 32
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    blocks_per_stage: int = 1
    base_radius: float = 0.15
    k: int = 32
    expansion: int = 4
    head_fcs: Tuple[int, ...] = (512, 256)


def _invres_init(randn, c: int, expansion: int) -> Params:
    return {"local": _dense_init(randn, c + 3, c), "fc1": _dense_init(randn, c, c * expansion),
            "fc2": _dense_init(randn, c * expansion, c)}


def pointnext_init(cfg: PointNeXtConfig, generator: torch.Generator,
                   device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {"stem": _dense_init(randn, 3, cfg.stem_dim)}
        cin = cfg.stem_dim
        for si, c in enumerate(cfg.stage_channels):
            params[f"down{si}"] = _dense_init(randn, cin + 3, c)
            params[f"blocks{si}"] = [_invres_init(randn, c, cfg.expansion)
                                     for _ in range(cfg.blocks_per_stage)]
            cin = c
        params["head"] = _head_init(randn, cin, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def _group_mlp_max(p: Params, centers, xyz, x, radius: float, k: int) -> torch.Tensor:
    """Ball-group (dp, f_j) around ``centers``, one BN'd ReLU layer, max over
    the group."""
    dp, fj = po.group_points(centers, xyz, po.ball_query(centers, xyz, radius, k), x)
    g = _relu(_bn(torch.cat([dp, fj], -1) @ p["w"], p["bn_scale"], p["bn_bias"]))
    return pool_max(g, 2)


def _invres_block(p: Params, xyz, x, radius: float, k: int) -> torch.Tensor:
    """InvResMLP: local grouped aggregation + the expansion MLP, residual."""
    h = _group_mlp_max(p["local"], xyz, xyz, x, radius, k)
    h = _relu(_bn(h @ p["fc1"]["w"], p["fc1"]["bn_scale"], p["fc1"]["bn_bias"]))
    return _relu(x + _bn(h @ p["fc2"]["w"], p["fc2"]["bn_scale"], p["fc2"]["bn_bias"]))


def pointnext_forward(params: Params, points: torch.Tensor, cfg: PointNeXtConfig) -> torch.Tensor:
    xyz = points[..., :3]
    p = params["stem"]
    x = _relu(_bn(xyz @ p["w"], p["bn_scale"], p["bn_bias"]))
    n = xyz.shape[1]
    radius = cfg.base_radius
    for si in range(len(cfg.stage_channels)):
        m = max(n // 2, 4)
        centers = po.gather_points(xyz, po.furthest_point_sample(xyz, m))
        x = _group_mlp_max(params[f"down{si}"], centers, xyz, x, radius, cfg.k)
        xyz, n = centers, m
        radius *= 2.0
        for blk in params[f"blocks{si}"]:
            x = _invres_block(blk, xyz, x, radius, cfg.k)
    return _head(pool_max(x, 1), params["head"])


# ---------------------------------------------------------------------------
# registry entries (openpoints MODELS.register_module parity)
# ---------------------------------------------------------------------------


def _register_entries(entries: Dict[str, tuple]) -> None:
    """``{name: (init, forward, Config)}`` into :data:`..utils.registry.MODELS`."""
    import types

    from metatransformer_tpu_torch.utils.registry import MODELS

    for name, (init, forward, config) in entries.items():
        if name not in MODELS._entries:
            MODELS._entries[name] = types.SimpleNamespace(init=init, forward=forward,
                                                          Config=config)


def _register() -> None:
    _register_entries({
        "PointNet2Encoder": (pointnet2_init, pointnet2_forward, PointNet2Config),
        "DGCNN": (dgcnn_init, dgcnn_forward, DGCNNConfig),
        "PointMLP": (pointmlp_init, pointmlp_forward, PointMLPConfig),
        "PointNeXt": (pointnext_init, pointnext_forward, PointNeXtConfig),
    })


_register()

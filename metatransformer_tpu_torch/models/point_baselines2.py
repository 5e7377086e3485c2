"""The point-cloud baseline zoo, tier 2: PointNet (with its STN and the
feature-transform regulariser), PCT, PointViT (Pix4Point) and DeepGCN.

Port of ``metatransformer_tpu/models/point_baselines2.py``
(``PointCloud/openpoints/models/backbone/{pointnet,pct,pointvit,
deepgcn}.py``), on tier 1's substrate (:mod:`.point_baselines`): FPS, kNN
and grouping from :mod:`..ops.point_ops`, per-point "1x1 convs" as
channel-axis matmuls, train-mode BatchNorm statistics.

- DeepGCN's stochastic dilated kNN is the deterministic dilation it decays
  to at evaluation (every d-th of the k d nearest), as in the reference.
- PointViT runs the point tokenizer and :func:`..core.encoder.encode` at
  its own width, FP32 (the reference's default policy): at T = 257 and
  FP32 the encoder's route is "xla" (``_resolve_impl``; the fused
  sublayers need BF16), so of the kernels it launches FPS only. Its
  positional MLP uses ``jax.nn.gelu``'s default, the tanh GELU.

All four register in :data:`..utils.registry.MODELS` with tier 1's
contract, ``forward(params, points [B, N, 3], cfg) -> logits [B, C]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _dense_init, _head, _head_init, _init_on, _lrelu, _mlp, _mlp_init, _randn,
    _register_entries, _relu, pool_max,
)
from metatransformer_tpu_torch.ops import point_ops as po
from metatransformer_tpu_torch.tokenizers import point as point_tok

# ---------------------------------------------------------------------------
# PointNet (classic): openpoints/models/backbone/pointnet.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointNetConfig:
    """STN3d input transform -> 64-64 shared MLP -> STNkd(64) feature
    transform -> 64-128-1024 shared MLP -> global max (pointnet.py
    PointNetEncoder.forward_cls_feat)."""

    num_classes: int = 40
    input_transform: bool = True
    feature_transform: bool = True
    head_fcs: Tuple[int, ...] = (512, 256)


def _stn_init(randn, k: int) -> Params:
    """STN3d / STNkd: a 64-128-1024 point MLP, the global max, 512-256 FCs,
    then a k x k regression that starts at the identity (zero weights, an
    identity bias)."""
    return {"convs": _mlp_init(randn, k, (64, 128, 1024)),
            "fcs": _mlp_init(randn, 1024, (512, 256)),
            "out_w": torch.zeros(256, k * k), "out_b": torch.eye(k).reshape(k * k)}


def _stn(params: Params, x: torch.Tensor, k: int) -> torch.Tensor:
    """x [B, N, k] -> the transform [B, k, k]."""
    h = _mlp(pool_max(_mlp(x, params["convs"]), 1), params["fcs"])
    return (h @ params["out_w"] + params["out_b"]).reshape(-1, k, k)


def pointnet_init(cfg: PointNetConfig, generator: torch.Generator,
                  device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {}
        if cfg.input_transform:
            params["stn"] = _stn_init(randn, 3)
        params["mlp0"] = _mlp_init(randn, 3, (64, 64))
        if cfg.feature_transform:
            params["fstn"] = _stn_init(randn, 64)
        params["mlp1"] = _mlp_init(randn, 64, (64, 128, 1024))
        params["head"] = _head_init(randn, 1024, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def _pointnet_mlp0(params: Params, points: torch.Tensor, cfg: PointNetConfig) -> torch.Tensor:
    x = points[..., :3]
    if cfg.input_transform:
        x = torch.einsum("bnk,bkj->bnj", x, _stn(params["stn"], x, 3))
    return _mlp(x, params["mlp0"])


def pointnet_forward(params: Params, points: torch.Tensor, cfg: PointNetConfig) -> torch.Tensor:
    x = _pointnet_mlp0(params, points, cfg)
    if cfg.feature_transform:
        x = torch.einsum("bnk,bkj->bnj", x, _stn(params["fstn"], x, 64))
    return _head(pool_max(_mlp(x, params["mlp1"]), 1), params["head"])


def pointnet_feature_transform_regularizer(params: Params, points: torch.Tensor,
                                           cfg: PointNetConfig) -> torch.Tensor:
    """||I - A A^T||^2 on the 64-d feature transform (the classic PointNet
    regulariser; weight 1e-3 in the original recipe)."""
    a = _stn(params["fstn"], _pointnet_mlp0(params, points, cfg), 64)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return ((eye - a @ a.transpose(1, 2)) ** 2).sum((1, 2)).mean()


# ---------------------------------------------------------------------------
# PCT: openpoints/models/backbone/pct.py (the offset-attention stack)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PCTConfig:
    """The Pct assembly: a 3-64-64 point MLP, two FPS + kNN neighbour
    embedding stages (512 / 32 then 256 / 32) each with a Local_op (two 1x1
    convs and a max over k), 4 chained SA layers whose outputs concat with
    the stage-2 feature into a 1024-d fuse conv, the global max and a
    leaky-ReLU FC head."""

    num_classes: int = 40
    stem: Tuple[int, ...] = (64, 64)
    stage_points: Tuple[int, ...] = (512, 256)
    stage_channels: Tuple[int, ...] = (128, 256)
    k: int = 32
    num_sa: int = 4
    fuse_dim: int = 1024
    head_fcs: Tuple[int, ...] = (512, 256)


def _sa_layer_init(randn, c: int) -> Params:
    return {"qk_w": randn(c, c // 4) * np.sqrt(1.0 / c),  # q and k share weights (pct.py)
            "v_w": randn(c, c) * np.sqrt(1.0 / c), "v_b": torch.zeros(c),
            "trans": _dense_init(randn, c, c)}


def _sa_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """PCT self-attention: shared q / k at c / 4, softmax over keys, then an
    L1 renormalisation over queries, residual through a BN'd transform."""
    q = x @ p["qk_w"]  # [B, N, c/4]; k is the same product
    v = x @ p["v_w"] + p["v_b"]  # [B, N, c]
    attn = torch.softmax(torch.einsum("bnd,bmd->bnm", q, q), dim=2)  # over keys
    attn = attn / (1e-9 + attn.sum(1, keepdim=True))  # L1 over queries
    r = torch.einsum("bnm,bnc->bmc", attn, v)  # token m aggregates the queries
    t = p["trans"]
    return x + _relu(_bn(r @ t["w"], t["bn_scale"], t["bn_bias"]))


def pct_init(cfg: PCTConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {"stem": _mlp_init(randn, 3, cfg.stem)}
        cin = cfg.stem[-1]
        for si, c in enumerate(cfg.stage_channels):
            # Local_op's input is concat(f_j - f_c, f_c): 2 cin
            params[f"local{si}"] = _mlp_init(randn, 2 * cin, (c, c))
            cin = c
        params["sa_in"] = _mlp_init(randn, cin, (cin, cin))
        params["sa"] = [_sa_layer_init(randn, cin) for _ in range(cfg.num_sa)]
        params["fuse"] = _dense_init(randn, cin * cfg.num_sa + cin, cfg.fuse_dim)
        params["head"] = _head_init(randn, cfg.fuse_dim, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def pct_forward(params: Params, points: torch.Tensor, cfg: PCTConfig) -> torch.Tensor:
    xyz = points[..., :3]
    x = _mlp(xyz, params["stem"])
    for si, m in enumerate(cfg.stage_points):
        idx = po.furthest_point_sample(xyz, m)
        centers = po.gather_points(xyz, idx)
        center_f = po.gather_points(x, idx)[:, :, None, :]  # [B, M, 1, C]
        _, nidx = po.knn(centers, xyz, cfg.k)
        fj = po.gather_points(x, nidx)  # [B, M, K, C]
        g = torch.cat([fj - center_f, center_f.expand_as(fj)], -1)
        x = pool_max(_mlp(g, params[f"local{si}"]), 2)  # Local_op's max over the neighbourhood
        xyz = centers
    h = _mlp(x, params["sa_in"])
    sa_outs = []
    for p in params["sa"]:
        h = _sa_layer(p, h)
        sa_outs.append(h)
    f = params["fuse"]
    h = _lrelu(_bn(torch.cat(sa_outs + [x], -1) @ f["w"], f["bn_scale"], f["bn_bias"]))
    pooled = pool_max(h, 1)
    hd = params["head"]
    for p in hd["fcs"]:
        pooled = _lrelu(_bn(pooled @ p["w"], p["bn_scale"], p["bn_bias"]))
    return pooled @ hd["out_w"] + hd["out_b"]


# ---------------------------------------------------------------------------
# PointViT (Pix4Point): openpoints/models/backbone/pointvit.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointViTConfig:
    """PointPatchEmbed tokens and a cls token, a 3-128-dim positional MLP
    added at every block, a trainable ViT stack, the 'cls,max' global
    feature: the trainable twin of the frozen Meta-Transformer backbone."""

    num_classes: int = 40
    dim: int = 384
    depth: int = 12
    num_heads: int = 6
    num_groups: int = 256
    group_size: int = 32
    head_fcs: Tuple[int, ...] = (256,)

    @property
    def encoder(self) -> enc.EncoderConfig:
        return enc.EncoderConfig(dim=self.dim, depth=self.depth, num_heads=self.num_heads,
                                 ln_eps=1e-6)

    @property
    def tokenizer(self) -> point_tok.PointTokenizerConfig:
        return point_tok.PointTokenizerConfig(sample_ratio=self.num_groups / 1024.0,
                                              group_size=self.group_size, embed_dim=self.dim,
                                              feature_type="fj")


def _pos_mlp_init(randn, d: int) -> Params:
    return {"w1": randn(3, 128) * np.sqrt(2.0 / 3), "b1": torch.zeros(128),
            "w2": randn(128, d) * np.sqrt(1.0 / 128), "b2": torch.zeros(d)}


def _vit_tail_init(randn, generator, cfg_encoder: enc.EncoderConfig, d: int, head_fcs,
                   num_classes: int) -> Params:
    """The encoder, the final LayerNorm and the head of the two point ViTs."""
    return {"encoder": enc.init(cfg_encoder, generator, "cpu"),
            "final_ln_scale": torch.ones(d), "final_ln_bias": torch.zeros(d),
            "head": _head_init(randn, 2 * d, head_fcs, num_classes)}


def pointvit_init(cfg: PointViTConfig, generator: torch.Generator,
                  device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        d = cfg.dim
        return {"tokenizer": point_tok.init(cfg.tokenizer, generator, "cpu"),
                "cls_token": randn(1, 1, d) * 0.02, "cls_pos": randn(1, 1, d) * 0.02,
                "pos_mlp": _pos_mlp_init(randn, d),
                **_vit_tail_init(randn, generator, cfg.encoder, d, cfg.head_fcs,
                                 cfg.num_classes)}

    return _init_on(device, build)


def _point_vit(params: Params, centers: torch.Tensor, tokens: torch.Tensor,
               ecfg: enc.EncoderConfig) -> torch.Tensor:
    """Tokens [B, M, D] at their centres -> the 'cls,max' feature [B, 2D]:
    the cls token, the positional MLP added at every block, the encoder,
    the final LayerNorm."""
    b, d = tokens.shape[0], ecfg.dim
    pm = params["pos_mlp"]
    pos = F.gelu(centers @ pm["w1"] + pm["b1"], approximate="tanh") @ pm["w2"] + pm["b2"]
    x = torch.cat([params["cls_token"].expand(b, 1, d), tokens], 1)
    pos = torch.cat([params["cls_pos"].expand(b, 1, d), pos], 1)
    x = enc.encode(params["encoder"], x, ecfg, pos=pos, pos_each_block=True)
    x = enc.layer_norm(x, params["final_ln_scale"], params["final_ln_bias"], 1e-6)
    return torch.cat([x[:, 0], pool_max(x[:, 1:], 1)], -1)


def pointvit_forward(params: Params, points: torch.Tensor, cfg: PointViTConfig) -> torch.Tensor:
    centers, tokens = point_tok.apply(params["tokenizer"], points[..., :3], cfg.tokenizer)
    return _head(_point_vit(params, centers, tokens, cfg.encoder), params["head"])


# ---------------------------------------------------------------------------
# DeepGCN: openpoints/models/backbone/deepgcn.py (residual dilated EdgeConv)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeepGCNConfig:
    """The ResGCN assembly: an EdgeConv head on the xyz kNN graph,
    n_blocks - 1 residual dynamic EdgeConv blocks with dilation 1 + i, the
    concat of every block's output into a leaky-ReLU fusion conv, the
    concat(max, avg) pool."""

    num_classes: int = 40
    channels: int = 64
    emb_dim: int = 1024
    n_blocks: int = 7
    k: int = 16
    head_fcs: Tuple[int, ...] = (512, 256)


def _dilated_knn(x: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """Every d-th of the k d nearest neighbours (graph_conv.DilatedKNN at
    evaluation)."""
    return po.knn(x, x, k * d)[1][..., ::d]


def _edge_conv_block(p: Params, x: torch.Tensor, nidx: torch.Tensor) -> torch.Tensor:
    """EdgeConv h([x_i, x_j - x_i]), max over the neighbours."""
    xj = po.gather_points(x, nidx)  # [B, N, k, C]
    xi = x[:, :, None, :].expand_as(xj)
    return pool_max(_relu(_bn(torch.cat([xi, xj - xi], -1) @ p["w"], p["bn_scale"],
                              p["bn_bias"])), 2)


def deepgcn_init(cfg: DeepGCNConfig, generator: torch.Generator,
                 device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        c = cfg.channels
        params: Params = {"head_conv": _dense_init(randn, 2 * 3, c)}
        for i in range(cfg.n_blocks - 1):
            params[f"block{i}"] = _dense_init(randn, 2 * c, c)
        params["fusion"] = _dense_init(randn, c * cfg.n_blocks, cfg.emb_dim)
        params["head"] = _head_init(randn, 2 * cfg.emb_dim, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def deepgcn_forward(params: Params, points: torch.Tensor, cfg: DeepGCNConfig) -> torch.Tensor:
    xyz = points[..., :3]
    feats = [_edge_conv_block(params["head_conv"], xyz, _dilated_knn(xyz, cfg.k, 1))]
    for i in range(cfg.n_blocks - 1):
        # a dynamic graph in feature space, the dilation growing a block
        h = _edge_conv_block(params[f"block{i}"], feats[-1],
                             _dilated_knn(feats[-1], cfg.k, 1 + i))
        feats.append(feats[-1] + h)  # ResDynBlock's residual
    f = params["fusion"]
    h = _lrelu(_bn(torch.cat(feats, -1) @ f["w"], f["bn_scale"], f["bn_bias"]))
    return _head(torch.cat([pool_max(h, 1), h.mean(1)], -1), params["head"])


def _register() -> None:
    _register_entries({
        "PointNetEncoder": (pointnet_init, pointnet_forward, PointNetConfig),
        "PCT": (pct_init, pct_forward, PCTConfig),
        "PointViT": (pointvit_init, pointvit_forward, PointViTConfig),
        "DeepGCN": (deepgcn_init, deepgcn_forward, DeepGCNConfig),
    })


_register()

"""The point-cloud baseline zoo, tier 4: BallDGCNN, GroupPointNet and
ViTGraph.

Port of ``metatransformer_tpu/models/point_baselines3.py``
(``PointCloud/openpoints/models/backbone/{ball_dgcnn,grouppointnet,
graphvit3d}.py``):

- BallDGCNN: DGCNN over one static neighbour graph from a ball query on
  xyz, a channel-doubling EdgeConv stack, a dense concat fusion and the
  max + avg class feature;
- GroupPointNet: an FPS downsample and a kNN group, a PointNet conv stack
  over (dp, grouped features), the max over neighbours and max + avg over
  centres;
- ViTGraph: PointViT with the group embedding at a smaller width projected
  up to the encoder's (768 at T = 257, FP32: the encoder's "xla" route).

Conventions are tier 1's (:mod:`.point_baselines`): conv-act-norm order
where the reference uses it, train-mode batch statistics, one classifier
contract ``forward(params, points, cfg) -> logits``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _dense_init, _head, _head_init, _init_on, _lrelu, _randn, _register_entries,
    pool_max,
)
from metatransformer_tpu_torch.models.point_baselines2 import (
    _point_vit, _pos_mlp_init, _vit_tail_init,
)
from metatransformer_tpu_torch.ops import point_ops as po
from metatransformer_tpu_torch.tokenizers import point as point_tok

# kaiming normal, bias-free (model_init in both reference files): tier 1's dense init
_conv_init = _dense_init


def _conv_act_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """create_convblock's 'conv-act-norm' order with leakyrelu(0.2)."""
    return _bn(_lrelu(x @ p["w"]), p["bn_scale"], p["bn_bias"])


# ---------------------------------------------------------------------------
# BallDGCNN: ball_dgcnn.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BallDGCNNConfig:
    num_classes: int = 40
    in_channels: int = 3
    channels: int = 64
    embed_dim: int = 1024
    n_blocks: int = 5
    k: int = 20
    radius: float = 0.1
    group: str = "ballquery"  # "ballquery" | "knn"
    head_fcs: Tuple[int, ...] = (512, 256)

    @property
    def block_channels(self) -> Tuple[int, ...]:
        # the head emits `channels`; each of the n_blocks - 2 EdgeConvs
        # doubles its input's width after emitting it
        outs, c = [self.channels], self.channels
        for _ in range(self.n_blocks - 2):
            outs.append(c)
            c *= 2
        return tuple(outs)


def balldgcnn_init(cfg: BallDGCNNConfig, generator: torch.Generator,
                   device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        outs = cfg.block_channels
        # EdgeConv over concat(x, x_j - x): 2 cin inputs
        params: Params = {"blocks": [], "head_conv": _conv_init(randn, 2 * cfg.in_channels,
                                                               outs[0])}
        cin = outs[0]
        for c in outs[1:]:
            params["blocks"].append(_conv_init(randn, 2 * cin, c))
            cin = c
        params["fusion"] = _conv_init(randn, sum(outs), cfg.embed_dim)
        params["head"] = _head_init(randn, 2 * cfg.embed_dim, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def _edge_conv(p: Params, x: torch.Tensor, nidx: torch.Tensor) -> torch.Tensor:
    """EdgeConv (graph_conv.py): conv(concat(x_i, x_j - x_i)), then the max
    over the neighbours."""
    xj = po.gather_points(x, nidx)  # [B, N, K, C]
    xi = x[:, :, None, :].expand_as(xj)
    return pool_max(_conv_act_norm(p, torch.cat([xi, xj - xi], -1)), 2)


def balldgcnn_forward(params: Params, points: torch.Tensor, cfg: BallDGCNNConfig
                      ) -> torch.Tensor:
    x = points[..., :cfg.in_channels]
    xyz = points[..., :3]
    if cfg.group == "ballquery":
        nidx = po.ball_query(xyz, xyz, cfg.radius, cfg.k)
    else:
        nidx = po.knn(xyz, xyz, cfg.k)[1]
    feats = [_edge_conv(params["head_conv"], x, nidx)]
    for bp in params["blocks"]:
        feats.append(_edge_conv(bp, feats[-1], nidx))
    fused = _conv_act_norm(params["fusion"], torch.cat(feats, -1))
    return _head(torch.cat([pool_max(fused, 1), fused.mean(1)], -1), params["head"])


# ---------------------------------------------------------------------------
# GroupPointNet: grouppointnet.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupPointNetConfig:
    num_classes: int = 40
    in_channels: int = 3
    channels: int = 64
    n_blocks: int = 5
    sample_ratio: float = 0.25
    k: int = 20
    head_fcs: Tuple[int, ...] = (256,)


def grouppointnet_init(cfg: GroupPointNetConfig, generator: torch.Generator,
                       device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        params: Params = {"backbone": []}
        cin = 2 * cfg.in_channels  # concat(dp, grouped features)
        for _ in range(cfg.n_blocks - 2):
            params["backbone"].append(_conv_init(randn, cin, cfg.channels))
            cin = cfg.channels
        params["head"] = _head_init(randn, 2 * cfg.channels, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def grouppointnet_forward(params: Params, points: torch.Tensor, cfg: GroupPointNetConfig
                          ) -> torch.Tensor:
    xyz = points[..., :3]
    f = points[..., :cfg.in_channels]
    n = xyz.shape[1]
    m = max(int(n * cfg.sample_ratio), 1)
    centers = po.gather_points(xyz, po.furthest_point_sample(xyz, m))
    _, nidx = po.knn(centers, xyz, min(cfg.k, n))
    dp, fj = po.group_points(centers, xyz, nidx, f, relative_xyz=True)
    h = torch.cat([dp, fj], -1)  # [B, M, K, 2 cin]
    for bp in params["backbone"]:
        h = _conv_act_norm(bp, h)
    h = pool_max(h, 2)  # the max over the neighbours
    return _head(torch.cat([pool_max(h, 1), h.mean(1)], -1), params["head"])


# ---------------------------------------------------------------------------
# ViTGraph: graphvit3d.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ViTGraphConfig:
    """PointViT with a narrow group embedding and a projection (graphvit3d:
    embed_dim 256 projected up to encoder_dim 768)."""

    num_classes: int = 40
    encoder_dim: int = 768
    embed_dim: int = 256
    depth: int = 12
    num_heads: int = 12
    num_groups: int = 256
    group_size: int = 32
    head_fcs: Tuple[int, ...] = (256,)

    @property
    def encoder(self) -> enc.EncoderConfig:
        return enc.EncoderConfig(dim=self.encoder_dim, depth=self.depth,
                                 num_heads=self.num_heads, ln_eps=1e-6)

    @property
    def tokenizer(self) -> point_tok.PointTokenizerConfig:
        return point_tok.PointTokenizerConfig(sample_ratio=self.num_groups / 1024.0,
                                              group_size=self.group_size,
                                              embed_dim=self.embed_dim, feature_type="fj")


def vitgraph_init(cfg: ViTGraphConfig, generator: torch.Generator,
                  device: _device.Device = None) -> Params:
    def build():
        randn = _randn(generator)
        d = cfg.encoder_dim
        lim = np.sqrt(6.0 / (cfg.embed_dim + d))
        return {"tokenizer": point_tok.init(cfg.tokenizer, generator, "cpu"),
                "proj": {"w": (torch.rand(cfg.embed_dim, d, generator=generator) * 2 - 1) * lim,
                         "b": torch.zeros(d)},
                "cls_token": torch.zeros(1, 1, d),  # zeros init
                "cls_pos": randn(1, 1, d) * 0.02,
                "pos_mlp": _pos_mlp_init(randn, d),
                **_vit_tail_init(randn, generator, cfg.encoder, d, cfg.head_fcs,
                                 cfg.num_classes)}

    return _init_on(device, build)


def vitgraph_forward(params: Params, points: torch.Tensor, cfg: ViTGraphConfig) -> torch.Tensor:
    centers, tokens = point_tok.apply(params["tokenizer"], points[..., :3], cfg.tokenizer)
    tokens = tokens @ params["proj"]["w"] + params["proj"]["b"]
    return _head(_point_vit(params, centers, tokens, cfg.encoder), params["head"])


def _register() -> None:
    _register_entries({
        "BallDGCNN": (balldgcnn_init, balldgcnn_forward, BallDGCNNConfig),
        "GroupPointNet": (grouppointnet_init, grouppointnet_forward, GroupPointNetConfig),
        "ViTGraph": (vitgraph_init, vitgraph_forward, ViTGraphConfig),
    })


_register()

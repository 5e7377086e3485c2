"""BAAF-Net: bilateral augmentation and adaptive fusion segmentation.

Port of ``metatransformer_tpu/models/baafnet.py``
(``PointCloud/openpoints/models/backbone/baafnet.py``):

- BilateralAugmentation: the local geometric context [p, p_rel] and the
  semantic context [f, f_rel]; semantic xyz offsets shift the neighbour
  coordinates, the augmented 9-d geometry predicts feature offsets back,
  and both augmented contexts are encoded to d / 2 each;
- MixedLocalAggregation: a per-channel softmax over the k neighbours, the
  weighted sum beside the max (:func:`.point_baselines.pool_max`), then
  2d -> d -> 2d MLPs;
- the encoder: a feature embedding and one bilateral block a level, with
  FPS 4x downsampling between them (:func:`..ops.point_ops.furthest_point_sample`,
  the FPS kernel on the card) and each level's 1-NN upsampling indices;
- the adaptive fusion decoder: one branch a depth, each brought back to
  full resolution through nearest-neighbour upsampling and MLPs; a learned
  scalar weight a branch, a softmax across branches, the weighted sum ->
  the classifier.

BatchNorm is tier 1's train-mode batch statistics; every ReLU and leaky
ReLU (0.2) takes its gradient through :func:`..ops.gates.act_gate`.
Registered as ``BAAFNet``: ``forward(params, points [B, N, 3], cfg,
features=None) -> [B, N, num_classes]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _init_on, _lrelu, _randn, _register_entries, _relu, pool_max,
)
from metatransformer_tpu_torch.ops import point_ops as po


@dataclasses.dataclass(frozen=True)
class BAAFNetConfig:
    num_classes: int = 13
    d_in: int = 3
    k: int = 16
    ds_ratio: int = 4
    # dims[0] = the embedding's base; block i maps 2 dims[i] -> 2 dims[i + 1]
    dims: Tuple[int, ...] = (8, 16, 64, 128, 256)

    @property
    def num_layers(self) -> int:
        return len(self.dims) - 1


def _mlp_init(randn, cin: int, cout: int, bn: bool = True) -> Params:
    p = {"w": randn(cin, cout) * np.sqrt(2.0 / cin), "b": torch.zeros(cout)}
    if bn:
        p["bn_scale"] = torch.ones(cout)
        p["bn_bias"] = torch.zeros(cout)
    return p


def _mlp(p: Params, x, act: Optional[str] = "relu"):
    h = x @ p["w"] + p["b"]
    if "bn_scale" in p:
        h = _bn(h, p["bn_scale"], p["bn_bias"])
    if act == "relu":
        return _relu(h)
    if act == "lrelu":
        return _lrelu(h)
    return h


def _embed_context(x, x_knn):
    xe = x[:, :, None, :].expand_as(x_knn)
    return torch.cat([xe, x_knn - xe], -1)


def _bilateral_augmentation(p: Params, pts, f, k: int):
    """-> (the augmented local context [B, N, k, d_out], the shifted
    neighbour coordinates)."""
    _, nidx = po.knn(pts, pts, min(k, pts.shape[1]))
    f = _mlp(p["mlp0"], f)  # d_out / 2
    p_knn = po.gather_points(pts, nidx)
    f_knn = po.gather_points(f, nidx)
    lgc = _embed_context(pts, p_knn)  # 6
    lsc = _embed_context(f, f_knn)  # d_out
    p_knn_tilde = _mlp(p["mlp1"], lsc) + p_knn
    lgc_aug = torch.cat([lgc, p_knn_tilde], -1)  # 9
    f_knn_tilde = _mlp(p["mlp2"], lgc_aug) + f_knn
    lsc_aug = torch.cat([lsc, f_knn_tilde], -1)  # 3 d_out / 2
    return torch.cat([_mlp(p["mlp3"], lgc_aug), _mlp(p["mlp4"], lsc_aug)], -1), p_knn_tilde


def _mixed_local_aggregation(p: Params, alc):
    """[B, N, k, d] -> [B, N, 2d]."""
    w = torch.softmax(_mlp(p["mlp0"], alc, act=None), dim=2)
    pooled = torch.cat([(alc * w).sum(2), pool_max(alc, 2)], -1)
    return _mlp(p["mlp2"], _mlp(p["mlp1"], pooled), act="lrelu")


def init(cfg: BAAFNetConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    def build():
        randn = _randn(generator)
        d, n_layers = cfg.dims, cfg.num_layers
        params: Params = {"embed": _mlp_init(randn, cfg.d_in, 2 * d[0])}
        for i in range(n_layers):
            params[f"bcb{i}_ba"] = {
                "mlp0": _mlp_init(randn, 2 * d[i], d[i + 1] // 2),
                "mlp1": _mlp_init(randn, d[i + 1], 3),
                "mlp2": _mlp_init(randn, 9, d[i + 1] // 2),
                "mlp3": _mlp_init(randn, 9, d[i + 1] // 2),
                "mlp4": _mlp_init(randn, 3 * d[i + 1] // 2, d[i + 1] // 2),
            }
            params[f"bcb{i}_mla"] = {
                "mlp0": _mlp_init(randn, d[i + 1], d[i + 1], bn=False),
                "mlp1": _mlp_init(randn, 2 * d[i + 1], d[i + 1]),
                "mlp2": _mlp_init(randn, d[i + 1], 2 * d[i + 1]),
            }
        for n in range(n_layers):
            top = n_layers - n
            params[f"dec{n}_mlp"] = _mlp_init(randn, 2 * d[top], 2 * d[top])
            recon = []
            for j in range(top):
                d_in = 2 * (d[top - j] + d[top - 1 - j])
                if j + 1 == top:
                    # the last step fuses the full-resolution block-0 output
                    # (2 dims[1]) with the upsampled 2 dims[1] branch
                    d_in = 4 * d[1]
                recon.append(_mlp_init(randn, d_in, 2 * d[top - 1 - j]))
            params[f"dec{n}_recon"] = recon
            params[f"dec{n}_weight"] = _mlp_init(randn, 2 * d[0], 1, bn=False)
        params["cls0"] = _mlp_init(randn, 2 * d[0], 64)
        params["cls1"] = _mlp_init(randn, 64, 32)
        params["cls2"] = _mlp_init(randn, 32, cfg.num_classes, bn=False)
        return params

    return _init_on(device, build)


def forward(params: Params, points: torch.Tensor, cfg: BAAFNetConfig,
            features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B, N, 3] (features [B, N, d_in], else the coordinates) ->
    per-point logits [B, N, num_classes]."""
    pts = points[..., :3]
    f = _mlp(params["embed"], pts if features is None else features, act="lrelu")
    n_layers = cfg.num_layers

    f_enc: List[torch.Tensor] = []
    us_idx: List[torch.Tensor] = []
    n = pts.shape[1]
    for i in range(n_layers):
        alc, _ = _bilateral_augmentation(params[f"bcb{i}_ba"], pts, f, cfg.k)
        f = _mixed_local_aggregation(params[f"bcb{i}_mla"], alc)
        if i == 0:
            f_enc.append(f)
        m = max(n // cfg.ds_ratio, 4)
        ds = po.furthest_point_sample(pts, m)
        p_ds = po.gather_points(pts, ds)
        f = po.gather_points(f, ds)
        f_enc.append(f)
        _, nn1 = po.knn(pts, p_ds, 1)  # each fine point's nearest coarse one
        us_idx.append(nn1[..., 0])
        pts, n = p_ds, m

    branches, weights = [], []
    for dec in range(n_layers):
        f = _mlp(params[f"dec{dec}_mlp"], f_enc[-1 - dec])
        for j in range(n_layers - dec):
            up = po.gather_points(f, us_idx[-j - dec - 1])
            f = _mlp(params[f"dec{dec}_recon"][j], torch.cat([f_enc[-j - dec - 2], up], -1))
        branches.append(f)
        weights.append(_mlp(params[f"dec{dec}_weight"], f, act=None))
    w = torch.softmax(torch.cat(weights, -1), dim=-1)
    f = sum(b * w[..., i:i + 1] for i, b in enumerate(branches))
    h = _mlp(params["cls1"], _mlp(params["cls0"], f))
    return _mlp(params["cls2"], h, act=None)


def _register() -> None:
    _register_entries({"BAAFNet": (init, forward, BAAFNetConfig)})


_register()

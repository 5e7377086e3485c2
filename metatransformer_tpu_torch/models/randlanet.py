"""RandLA-Net: random-sampling large-scale point segmentation.

Port of ``metatransformer_tpu/models/randlanet.py``
(``PointCloud/openpoints/models/backbone/randlenet.py``):

- random decimation: one permutation of the points up front, each encoder
  stage keeps the first N / 4^i of them. The reference draws it from
  ``jax.random.PRNGKey(0)`` when no key is passed, and its recipe passes
  none, so every step uses one fixed permutation. JAX's draw cannot be
  reproduced without JAX: :func:`forward` takes the permutation as
  ``perm``, and without one draws it from a ``torch.Generator`` seeded 0
  on the points' device (one fixed permutation a device, as the
  reference's is one fixed permutation);
- LocalSpatialEncoding: [centre, neighbour, centre - neighbour, distance]
  lifted to d features, concatenated with the broadcast point features;
- AttentivePooling: a per-channel softmax over the k neighbours, a
  weighted sum and a shared MLP;
- LocalFeatureAggregation: mlp1 -> (LSE -> pool) x 2 -> mlp2 + shortcut,
  a leaky-ReLU (0.01) residual;
- the decoder: 1-NN upsampling from the coarse set to the next finer
  prefix, a skip concat and a shared MLP; the inverse permutation at the
  end.

BatchNorm is tier 1's train-mode batch statistics; every ReLU and leaky
ReLU (slopes 0.2 and 0.01) takes its gradient through
:func:`..ops.gates.act_gate`. Registered as ``RandLANet``:
``forward(params, points [B, N, 3], cfg, features=None, perm=None) ->
[B, N, num_classes]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _dense_init, _init_on, _randn, _register_entries, _relu,
)
from metatransformer_tpu_torch.ops import point_ops as po
from metatransformer_tpu_torch.ops.gates import gated


@dataclasses.dataclass(frozen=True)
class RandLANetConfig:
    num_classes: int = 13
    d_in: int = 3
    num_neighbors: int = 16
    decimation: int = 4
    enc_dims: Tuple[int, ...] = (16, 64, 128, 256)  # LFA d_out per stage
    head_dims: Tuple[int, ...] = (64, 32)


def _lin_init(randn, cin: int, cout: int) -> Params:
    return {"w": randn(cin, cout) * np.sqrt(2.0 / cin)}


def _lse(p: Params, coords, feats, nidx, ndist):
    """[B, N, K, d] spatial encoding concat the broadcast features."""
    nj = po.gather_points(coords, nidx)  # [B, N, K, 3]
    ci = coords[:, :, None, :].expand_as(nj)
    geo = torch.cat([ci, nj, ci - nj, ndist[..., None]], -1)
    m = p["mlp"]
    geo = _relu(_bn(geo @ m["w"], m["bn_scale"], m["bn_bias"]))
    fx = feats[:, :, None, :].expand(*geo.shape[:3], feats.shape[-1])
    return torch.cat([geo, fx], -1)


def _att_pool(p: Params, x):
    """x [B, N, K, C] -> [B, N, C]: a softmax over the neighbours."""
    scores = torch.softmax(x @ p["score"]["w"], dim=2)
    f = (scores * x).sum(2)
    m = p["mlp"]
    return _relu(_bn(f @ m["w"], m["bn_scale"], m["bn_bias"]))


def _lfa_init(randn, d_in: int, d_out: int) -> Params:
    return {
        "mlp1": _lin_init(randn, d_in, d_out // 2),
        "lse1": {"mlp": _dense_init(randn, 10, d_out // 2)},
        "pool1": {"score": _lin_init(randn, d_out, d_out),
                  "mlp": _dense_init(randn, d_out, d_out // 2)},
        "lse2": {"mlp": _dense_init(randn, 10, d_out // 2)},
        "pool2": {"score": _lin_init(randn, d_out, d_out),
                  "mlp": _dense_init(randn, d_out, d_out)},
        "mlp2": _lin_init(randn, d_out, 2 * d_out),
        "shortcut": _dense_init(randn, d_in, 2 * d_out),
    }


def _lfa(p: Params, coords, feats, k: int):
    ndist, nidx = po.knn(coords, coords, min(k, coords.shape[1]))
    x = gated(feats @ p["mlp1"]["w"], 0.2)
    x = _att_pool(p["pool1"], _lse(p["lse1"], coords, x, nidx, ndist))
    x = _att_pool(p["pool2"], _lse(p["lse2"], coords, x, nidx, ndist))
    x = x @ p["mlp2"]["w"]
    sc = p["shortcut"]
    short = _bn(feats @ sc["w"], sc["bn_scale"], sc["bn_bias"])
    return gated(x + short, 0.01)


def init(cfg: RandLANetConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    def build():
        randn = _randn(generator)
        params: Params = {"fc_start": _dense_init(randn, cfg.d_in, 8)}
        cin, skip_dims, in_dims = 8, [], []
        for i, d in enumerate(cfg.enc_dims):
            in_dims.append(cin)
            params[f"lfa{i}"] = _lfa_init(randn, cin, d)
            cin = 2 * d
            skip_dims.append(cin)
        params["mid"] = _lin_init(randn, cin, cin)
        # the decoder's outputs are the encoder's input widths, reversed
        for i, (skip, cout) in enumerate(zip(reversed(skip_dims), reversed(in_dims))):
            params[f"dec{i}"] = _dense_init(randn, cin + skip, cout)
            cin = cout
        for i, h in enumerate(cfg.head_dims):
            params[f"head{i}"] = _dense_init(randn, cin, h)
            cin = h
        params["out"] = {"w": randn(cin, cfg.num_classes) * np.sqrt(1.0 / cin),
                         "b": torch.zeros(cfg.num_classes)}
        return params

    return _init_on(device, build)


def default_perm(n: int, device) -> torch.Tensor:
    """The permutation :func:`forward` takes without one: ``randperm`` of a
    ``torch.Generator`` seeded 0 on ``device``."""
    return torch.randperm(n, generator=torch.Generator(device).manual_seed(0), device=device)


def forward(params: Params, points: torch.Tensor, cfg: RandLANetConfig,
            features: Optional[torch.Tensor] = None,
            perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B, N, 3] (features [B, N, d_in], else the coordinates) ->
    per-point logits [B, N, num_classes]; ``perm`` [N] the decimation's
    permutation (None: :func:`default_perm`)."""
    coords = points[..., :3]
    n = coords.shape[1]
    x_in = coords if features is None else features
    perm = default_perm(n, coords.device) if perm is None else perm.to(coords.device)
    coords, x = coords[:, perm], x_in[:, perm]

    fs = params["fc_start"]
    x = gated(_bn(x @ fs["w"], fs["bn_scale"], fs["bn_bias"]), 0.2)

    skips, coords_stack, cur = [], [], n
    for i in range(len(cfg.enc_dims)):
        x = _lfa(params[f"lfa{i}"], coords[:, :cur], x, cfg.num_neighbors)
        skips.append(x)
        coords_stack.append(coords[:, :cur])
        cur = max(cur // cfg.decimation, 4)
        x = x[:, :cur]

    x = _relu(x @ params["mid"]["w"])
    for i in range(len(cfg.enc_dims)):
        fine = coords_stack[-1 - i]
        # 1-NN upsampling from the coarse prefix to the finer one
        _, nn1 = po.knn(fine, fine[:, :x.shape[1]], 1)
        h = torch.cat([po.gather_points(x, nn1[..., 0]), skips[-1 - i]], -1)
        dc = params[f"dec{i}"]
        x = _relu(_bn(h @ dc["w"], dc["bn_scale"], dc["bn_bias"]))

    x = x[:, torch.argsort(perm)]  # back to the input order
    for i in range(len(cfg.head_dims)):
        hp = params[f"head{i}"]
        x = _relu(_bn(x @ hp["w"], hp["bn_scale"], hp["bn_bias"]))
    return x @ params["out"]["w"] + params["out"]["b"]


def _register() -> None:
    _register_entries({"RandLANet": (init, forward, RandLANetConfig)})


_register()

"""CurveNet: curve-guided point feature aggregation, the classification
assembly.

Port of ``metatransformer_tpu/models/curvenet.py``
(``PointCloud/openpoints/models/backbone/curvenet.py``):

- the walk: ``curve_num`` agents walk ``curve_length`` steps over the kNN
  graph; each step scores the current node's neighbours with an agent MLP
  conditioned on a momentum-mixed curve descriptor, gates them by the
  cosine between the incoming direction and each hop (detached), and
  commits by a deterministic straight-through one-hot (no Gumbel noise, as
  the reference). The step's choice is :func:`walk_choice`, a named
  function without gradient, so a caller can record and replay it: a
  near-tie of the logits can choose differently on another device;
- CurveAggregation: inter / intra curve softmax attention mixing the
  curves' summaries back into every point;
- CurveGrouping: the sigmoid start-point scores and their top
  ``curve_num`` (:func:`curve_starts`, also named and without gradient);
- LPFA: [centre, neighbour, neighbour - centre] geometry lifted to
  features; the initial layer max-pools, later ones add the feature
  difference and mean-pool;
- CIC: bottleneck conv -> curve grouping and aggregation -> LPFA ->
  expansion conv + shortcut, after a FPS + ball-group max-pool where the
  stage downsamples.

BatchNorm and the head are tier 1's (:mod:`.point_baselines`). Registered
as ``CurveNet``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _bn, _dense_init, _head, _head_init, _init_on, _lrelu, _randn, _register_entries,
    pool_max,
)
from metatransformer_tpu_torch.ops import point_ops as po


@dataclasses.dataclass(frozen=True)
class CICStage:
    npoint: int  # points after this stage (a max-pool when fewer than the input)
    radius: float
    k: int
    out_channels: int
    curve: Optional[Tuple[int, int]] = None  # (curve_num, curve_length)


@dataclasses.dataclass(frozen=True)
class CurveNetConfig:
    """The classification assembly: the LPFA embedding and 2 CICs a stage
    (bottleneck ratios 2 then 4) and the global head."""

    num_classes: int = 40
    embed_dim: int = 32
    k: int = 32
    stages: Tuple[CICStage, ...] = (
        CICStage(1024, 0.2, 32, 64, (100, 5)),
        CICStage(256, 0.4, 32, 128, (100, 5)),
        CICStage(64, 0.8, 32, 256, None),
        CICStage(16, 1.2, 15, 512, None),
    )
    head_fcs: Tuple[int, ...] = (512, 256)


# ---------------------------------------------------------------------------
# the walk (curve grouping)
# ---------------------------------------------------------------------------


def _walk_init(randn, c: int) -> Params:
    return {"agent": _dense_init(randn, 2 * c, 1),  # Conv2d(2c -> 1) + BN
            "momentum": _dense_init(randn, 2 * c, 2)}  # Conv1d(2c -> 2) + BN


@torch.no_grad()
def walk_choice(soft: torch.Tensor) -> torch.Tensor:
    """The neighbour each curve steps to: the argmax of the step's softmax
    [B, CN, K] (ties to the first, as ``jnp.argmax``) -> [B, CN]."""
    return soft.argmax(-1)


def _st_onehot(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic straight-through 'gumbel' one-hot -> (one-hot with
    the softmax's gradient, the chosen slot)."""
    soft = torch.softmax(logits, -1)
    choice = walk_choice(soft)
    hard = F.one_hot(choice, logits.shape[-1]).to(soft.dtype)
    return hard - soft.detach() + soft, choice


def _cos_gate(incoming: torch.Tensor, hops: torch.Tensor) -> torch.Tensor:
    """Crossover suppression: clamp(1 + cos, 0, 1), detached."""
    incoming, hops = incoming.detach(), hops.detach()
    dot = (incoming[..., None, :] * hops).sum(-1)
    n1 = torch.linalg.vector_norm(incoming, dim=-1)[..., None]
    n2 = torch.linalg.vector_norm(hops, dim=-1)
    return (1.0 + dot / (n1 * n2).clamp_min(1e-8)).clamp(0.0, 1.0)


def _walk(params: Params, x: torch.Tensor, adj: torch.Tensor, start_idx: torch.Tensor,
          curve_length: int) -> torch.Tensor:
    """x [B, N, C], adj [B, N, K] (self excluded), start_idx [B, CN] ->
    curves [B, CN, curve_length, C]."""
    m, a = params["momentum"], params["agent"]
    cur, cur_f = start_idx, po.gather_points(x, start_idx)
    pre_f, steps = cur_f, []
    for step in range(curve_length):
        pick_idx = po.gather_points(adj, cur)  # [B, CN, K]
        pick_v = po.gather_points(x, pick_idx)  # [B, CN, K, C]
        if step == 0:
            pre = cur_f
        else:
            w = torch.softmax(_bn(torch.cat([cur_f, pre_f], -1) @ m["w"], m["bn_scale"],
                                  m["bn_bias"]), -1)  # [B, CN, 2]
            pre = w[..., 0:1] * cur_f + w[..., 1:2] * pre_f
        cat = torch.cat([pick_v, pre[:, :, None, :].expand_as(pick_v)], -1)
        logits = _bn(cat @ a["w"], a["bn_scale"], a["bn_bias"])[..., 0]
        if step > 0:
            logits = logits * _cos_gate(cur_f - pre, pick_v - cur_f[:, :, None, :])
        onehot, choice = _st_onehot(logits)  # [B, CN, K]
        new_f = (pick_v * onehot[..., None]).sum(2)
        cur = pick_idx.gather(-1, choice[..., None])[..., 0]
        cur_f, pre_f = new_f, pre
        steps.append(new_f)
    return torch.stack(steps, 2)


# ---------------------------------------------------------------------------
# curve aggregation
# ---------------------------------------------------------------------------


def _curve_agg_init(randn, c: int) -> Params:
    mid = c // 2
    return {"a": randn(c, mid) * c**-0.5, "b": randn(c, mid) * c**-0.5,
            "c": randn(c, mid) * c**-0.5, "n": randn(mid, mid) * mid**-0.5,
            "l": randn(mid, mid) * mid**-0.5, "d": _dense_init(randn, 2 * mid, c),
            "line_att": randn(c, 1) * c**-0.5}


def _curve_agg(p: Params, x: torch.Tensor, curves: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], curves [B, CN, L, C]."""
    att = (curves @ p["line_att"])[..., 0]  # [B, CN, L]
    inter = (curves * torch.softmax(att, -1)[..., None]).sum(2)
    intra = (curves * torch.softmax(att, 1)[..., None]).sum(1)
    inter_m, intra_m, xl = inter @ p["a"], intra @ p["b"], x @ p["c"]
    w_inter = torch.softmax(torch.einsum("bnm,bcm->bnc", xl, inter_m), -1)
    w_intra = torch.softmax(torch.einsum("bnm,blm->bnl", xl, intra_m), -1)
    f_inter = torch.einsum("bnc,bcm->bnm", w_inter, inter_m @ p["n"])
    f_intra = torch.einsum("bnl,blm->bnm", w_intra, intra_m @ p["l"])
    d = p["d"]
    mix = torch.cat([f_inter, f_intra], -1)
    return _lrelu(x + _bn(mix @ d["w"], d["bn_scale"], d["bn_bias"]))


# ---------------------------------------------------------------------------
# LPFA
# ---------------------------------------------------------------------------


def _lpfa_init(randn, cin: int, cout: int, mlp_num: int, initial: bool) -> Params:
    p: Params = {}
    if not initial:
        p["xyz2feat"] = _dense_init(randn, 9, cin)
    mlps, c = [], 9 if initial else cin
    for _ in range(mlp_num):
        mlps.append(_dense_init(randn, c, cout))
        c = cout
    p["mlps"] = mlps
    return p


def _lpfa(p: Params, x: Optional[torch.Tensor], xyz: torch.Tensor, nidx: torch.Tensor,
          initial: bool) -> torch.Tensor:
    nj = po.gather_points(xyz, nidx)  # [B, N, K, 3]
    ci = xyz[:, :, None, :].expand_as(nj)
    geo = torch.cat([ci, nj, nj - ci], -1)  # [centre, neighbour, neighbour - centre]
    if initial:
        h = geo
    else:
        xf = p["xyz2feat"]
        geo_f = _bn(geo @ xf["w"], xf["bn_scale"], xf["bn_bias"])
        h = _lrelu(po.gather_points(x, nidx) - x[:, :, None, :] + geo_f)
    for m in p["mlps"]:
        h = _lrelu(_bn(h @ m["w"], m["bn_scale"], m["bn_bias"]))
    return pool_max(h, 2) if initial else h.mean(2)


# ---------------------------------------------------------------------------
# CIC
# ---------------------------------------------------------------------------


def _cic_init(randn, cin: int, cout: int, bottleneck: int, curve, mlp_num: int = 2) -> Params:
    planes = cin // bottleneck
    p: Params = {"conv1": _dense_init(randn, cin, planes),
                 "conv2": _dense_init(randn, planes, cout),
                 "lpfa": _lpfa_init(randn, planes, planes, mlp_num, False)}
    if cin != cout:
        p["shortcut"] = _dense_init(randn, cin, cout)
    if curve is not None:
        p["start_att"] = randn(planes, 1) * planes**-0.5
        p["walk"] = _walk_init(randn, planes)
        p["agg"] = _curve_agg_init(randn, planes)
    return p


@torch.no_grad()
def curve_starts(score: torch.Tensor, curve_num: int) -> torch.Tensor:
    """The ``curve_num`` start points of the curves: the top start scores
    [B, N] -> [B, CN] (CurveGrouping)."""
    return torch.topk(score, curve_num, dim=-1).indices


def _cic(p: Params, xyz: torch.Tensor, x: torch.Tensor, stage: CICStage):
    n = xyz.shape[1]
    if n != stage.npoint:
        # MaskedMaxPool: FPS + ball group + max
        centers = po.gather_points(xyz, po.furthest_point_sample(xyz, stage.npoint))
        nidx = po.ball_query(centers, xyz, stage.radius, min(stage.k, n))
        x = pool_max(po.group_points(centers, xyz, nidx, x)[1], 2)
        xyz = centers
    shortcut = x
    c1 = p["conv1"]
    h = _lrelu(_bn(x @ c1["w"], c1["bn_scale"], c1["bn_bias"]))
    k_eff = min(stage.k, xyz.shape[1] - 1)
    nidx = po.knn(xyz, xyz, k_eff + 1)[1][..., 1:]  # self dropped
    if stage.curve is not None:
        cn, cl = stage.curve
        cn = min(cn, xyz.shape[1])
        score = torch.sigmoid((h @ p["start_att"])[..., 0])  # [B, N]
        h = h * score[..., None]
        curves = _walk(p["walk"], h, nidx, curve_starts(score, cn), cl)
        h = _curve_agg(p["agg"], h, curves)
    h = _lpfa(p["lpfa"], h, xyz, nidx, initial=False)
    c2 = p["conv2"]
    h = _bn(h @ c2["w"], c2["bn_scale"], c2["bn_bias"])
    if "shortcut" in p:
        sc = p["shortcut"]
        shortcut = _bn(shortcut @ sc["w"], sc["bn_scale"], sc["bn_bias"])
    return xyz, _lrelu(h + shortcut)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def init(cfg: CurveNetConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    def build():
        randn = _randn(generator)
        params: Params = {"embed": _lpfa_init(randn, 9, cfg.embed_dim, 1, True)}
        cin = cfg.embed_dim
        for i, st in enumerate(cfg.stages):
            params[f"cic{i}a"] = _cic_init(randn, cin, st.out_channels, 2, st.curve)
            params[f"cic{i}b"] = _cic_init(randn, st.out_channels, st.out_channels, 4, st.curve)
            cin = st.out_channels
        params["head"] = _head_init(randn, 2 * cin, cfg.head_fcs, cfg.num_classes)
        return params

    return _init_on(device, build)


def forward(params: Params, points: torch.Tensor, cfg: CurveNetConfig) -> torch.Tensor:
    xyz = points[..., :3]
    n = xyz.shape[1]
    x = _lpfa(params["embed"], None, xyz, po.knn(xyz, xyz, min(cfg.k, n))[1], initial=True)
    for i, st in enumerate(cfg.stages):
        if st.npoint > xyz.shape[1]:
            st = dataclasses.replace(st, npoint=xyz.shape[1])
        xyz, x = _cic(params[f"cic{i}a"], xyz, x, st)
        xyz, x = _cic(params[f"cic{i}b"], xyz, x, st)
    return _head(torch.cat([pool_max(x, 1), x.mean(1)], -1), params["head"])


def _register() -> None:
    _register_entries({"CurveNet": (init, forward, CurveNetConfig)})


_register()

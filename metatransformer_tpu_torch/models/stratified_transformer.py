"""Stratified Transformer segmentation backbone.

Port of ``metatransformer_tpu/models/stratified_transformer.py``
(``PointCloud/openpoints/models/backbone/Stratified_transformer.py``): a
KPConv stem, stages of shifted-window point attention where each query
attends to every point of its fine window and to FPS-downsampled points of
the surrounding 2x coarse window outside it (the "stratified" keys), with
a contextual relative-position bias (cRPE) from per-axis quantised tables,
TransitionDown (FPS + kNN + LayerNorm + linear + max) between the stages,
and an interpolation decoder.

As in the reference, the pair sets are a dense [B, N, N] bool mask over
dense multi-head attention (plain torch products; no attention kernel of
the port applies to a masked [B, N, N, H] logit sum with a bias), with the
masked logits filled with -1e9. Three choices of the port:

- the cRPE bias is a gather of the per-query and per-key table products
  by the quantised index, where the reference sums one-hot einsums of
  width 2 x ``quant_len`` (16): each one-hot product has one non-zero
  term, so the gather computes the same sum exactly, without the
  [B, N, N, 16] one-hot a table axis (512 MiB at b = 8 and 1,024 points);
- the window membership (:func:`window_masks`, a ``floor`` of the
  coordinates) and the cRPE index (:func:`crpe_index`, a ``floor`` after
  rounding to 1e-5) are choices at a rounding edge, each a named function
  without gradient, so a check can record and replay them;
- every FPS (the stratified keys, TransitionDown) is
  :func:`..ops.point_ops.furthest_point_sample`, the FPS kernel on the
  card; the stem's leaky ReLU and TransitionDown's max take their
  gradients through :func:`..ops.gates.act_gate` /
  :func:`.point_baselines.max_winners`.

The GELU is ``jax.nn.gelu``'s default, the tanh form; BatchNorm takes
eps 1e-5 and LayerNorm 1e-6, as the reference's. The KPConv kernel points
are the reference's deterministic centre + Fibonacci sphere. Registered
as ``StratifiedTransformer``: ``forward(params, points [B, N, 3], cfg,
features=None) -> [B, N, num_classes]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.point_baselines import (
    Params, _init_on, _lrelu, _register_entries, pool_max,
)
from metatransformer_tpu_torch.ops import point_interp, point_ops


@dataclasses.dataclass(frozen=True)
class StratifiedConfig:
    """The reference's defaults (num_classes 13 for S3DIS, ratio 0.25,
    k 16, the KPConv stem) with the paper's S3DIS channel, depth and head
    ladder."""

    num_classes: int = 13
    in_channels: int = 3  # per-point features; xyz drives the geometry
    channels: Tuple[int, ...] = (48, 96, 192, 384)
    depths: Tuple[int, ...] = (2, 2, 6, 2)  # depths[0] unused (the KPConv stem)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: float = 0.16  # stage 1's fine window edge; x2 a stage
    quant_size: float = 0.04  # stage 1's cRPE quantisation; x2 a stage
    grid_size: float = 0.04  # the stem KPConv's influence scale
    downsample_scale: int = 4  # the stratified keys' FPS sparsity
    ratio: float = 0.25  # TransitionDown's keep ratio
    k: int = 16  # TransitionDown's kNN and the stem's ball-query cap
    sigma: float = 1.0
    n_kernel_pts: int = 15
    mlp_ratio: float = 4.0

    @property
    def quant_len(self) -> int:
        # the window and the quantisation double together, so one value
        return int((2 * self.window_size + 1e-4) // self.quant_size)


# --- primitives --------------------------------------------------------------


def _bn(p: Params, x):
    """Train-mode batch statistics over every axis but the channels, eps
    1e-5."""
    var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _ln(p: Params, x):
    var, mean = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _norm_init(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _trunc(generator: torch.Generator):
    """The reference's ``truncated_normal(key, -2, 2, shape)``."""
    def draw(*shape):
        t = torch.empty(shape)
        return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return draw


def _linear_init(trunc, i: int, o: int, bias: bool = True) -> Params:
    p = {"w": trunc(i, o) * 0.02}
    if bias:
        p["b"] = torch.zeros(o)
    return p


def _linear(p: Params, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _kernel_points(n: int, radius: float) -> np.ndarray:
    """The deterministic centre + Fibonacci-sphere dispositions."""
    pts = [np.zeros(3)]
    m = n - 1
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(m):
        z = 1.0 - 2.0 * (i + 0.5) / m
        r = np.sqrt(max(1.0 - z * z, 0.0))
        th = golden * i
        pts.append(np.array([r * np.cos(th), r * np.sin(th), z]) * radius)
    return np.stack(pts).astype(np.float32)  # [n, 3]


# --- the KPConv stem -----------------------------------------------------------


def _kpconv(p: Params, xyz, feats, nidx, kp, infl: float):
    """The linear-correlation KPConv: out_i = sum_j sum_k
    max(0, 1 - |x_j - x_i - kp_k| / infl) (f_j W_k)."""
    xj = point_ops.gather_points(xyz, nidx)  # [B, N, M, 3]
    fj = point_ops.gather_points(feats, nidx)  # [B, N, M, C]
    disp = xj - xyz[:, :, None, :]
    d = torch.linalg.vector_norm(disp[:, :, :, None, :] - kp, dim=-1)  # [B, N, M, K]
    w = torch.clamp_min(1.0 - d / infl, 0.0)
    return torch.einsum("bnkc,kco->bno", torch.einsum("bnmk,bnmc->bnkc", w, fj), p["w"])


def _stem(p: Params, xyz, feats, cfg: StratifiedConfig):
    radius = 2.5 * cfg.grid_size * cfg.sigma
    nidx = point_ops.ball_query(xyz, xyz, radius, min(cfg.k, xyz.shape[1]))
    infl = cfg.grid_size * cfg.sigma
    kp = torch.as_tensor(_kernel_points(cfg.n_kernel_pts, infl), device=xyz.device,
                         dtype=xyz.dtype)
    h = _lrelu(_bn(p["bn1"], _kpconv(p["kp1"], xyz, feats, nidx, kp, infl)))
    # KPConvResBlock, its in == out: an identity shortcut
    u = _lrelu(_bn(p["ubn1"], _linear(p["unary1"], h)))
    u = _kpconv(p["kp2"], xyz, u, nidx, kp, infl)
    u = _lrelu(_bn(p["ubn2"], _linear(p["unary2"], u)))
    return h + u


# --- TransitionDown -------------------------------------------------------------


def _transition_down(p: Params, xyz, feats, cfg: StratifiedConfig):
    n = xyz.shape[1]
    m = max(int(n * cfg.ratio), 1)
    new_xyz = point_ops.gather_points(xyz, point_ops.furthest_point_sample(xyz, m))
    _, nidx = point_ops.knn(new_xyz, xyz, min(cfg.k, n))
    h = _linear(p["lin"], _ln(p["norm"], point_ops.gather_points(feats, nidx)))
    return new_xyz, pool_max(h, 2)


# --- stratified window attention ------------------------------------------------


@torch.no_grad()
def window_masks(xyz: torch.Tensor, ws: float, shifted: bool,
                 down_mask: torch.Tensor) -> torch.Tensor:
    """The reference's pair set as a dense [B, N, N] bool mask: pairs in
    one fine window, or a downsampled key in the same 2x coarse window but
    another fine window (the stratified pairs). A shifted block offsets
    both grids by half a window. No gradient."""
    mn = xyz.amin(1, keepdim=True)
    fc = torch.floor((xyz - mn + (0.5 * ws if shifted else 0.0)) / ws)
    cc = torch.floor((xyz - mn + (ws if shifted else 0.0)) / (2.0 * ws))
    fine = (fc[:, :, None, :] == fc[:, None, :, :]).all(-1)
    coarse = (cc[:, :, None, :] == cc[:, None, :, :]).all(-1)
    return fine | (coarse & down_mask[:, None, :] & ~fine)


@torch.no_grad()
def crpe_index(xyz: torch.Tensor, ws: float, quant: float, l2: int) -> torch.Tensor:
    """The per-axis quantised relative-position index [B, N, M, 3] (int64)
    of every pair: the offset rounded to 1e-5, shifted by 2 ws, over the
    quantisation, floored and clipped to the table. No gradient."""
    rel = xyz[:, :, None, :] - xyz[:, None, :, :]
    rel = torch.round(rel * 1e5) / 1e5
    return torch.floor((rel + 2.0 * ws - 1e-4) / quant).clamp(0, l2 - 1).long()


def crpe_bias(q: torch.Tensor, k: torch.Tensor, rel_q: torch.Tensor, rel_k: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """The cRPE bias [B, H, N, M]: sum over the axes a of q_n . Tq[idx, a]
    and k_m . Tk[idx, a], as gathers of the per-query / per-key products
    with every table row (q, k [B, N, H, d]; tables [L2, H, d, 3]; idx
    [B, N, M, 3]), accumulated in the reference's order."""
    b, n, h, _ = q.shape
    m = k.shape[1]
    qdot = torch.einsum("bnhd,lhda->bhnla", q, rel_q)  # [B, H, N, L2, 3]
    kdot = torch.einsum("bmhd,lhda->bhmla", k, rel_k)
    bias = q.new_zeros(b, h, n, m)
    for a in range(3):
        ia = idx[..., a]  # [B, N, M]
        bias = bias + qdot[..., a].gather(3, ia[:, None].expand(b, h, n, m))
        bias = bias + kdot[..., a].gather(3, ia.transpose(1, 2)[:, None].expand(b, h, m, n)
                                          ).transpose(2, 3)
    return bias


def _window_attention(p: Params, feats, allowed, idx, heads: int):
    b, n, c = feats.shape
    hd = c // heads
    qkv = _linear(p["qkv"], feats).reshape(b, n, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = q * hd**-0.5  # the scale before both the dot and the cRPE
    attn = q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1)  # [B, H, N, M]
    attn = attn + crpe_bias(q, k, p["rel_q"], p["rel_k"], idx)
    attn = torch.where(allowed[:, None], attn, -1e9)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).reshape(b, n, c)
    return _linear(p["proj"], out)


def _block(p: Params, feats, allowed, idx, heads: int):
    feats = feats + _window_attention(p["attn"], _ln(p["ln1"], feats), allowed, idx, heads)
    return feats + _linear(p["fc2"], _gelu(_linear(p["fc1"], _ln(p["ln2"], feats))))


def _stage(params: List[Params], feats, xyz, ws: float, quant: float, cfg: StratifiedConfig,
           stage_idx: int):
    """One stage: one FPS draw of stratified keys, the blocks alternating
    unshifted / shifted windows."""
    b, n = xyz.shape[:2]
    didx = point_ops.furthest_point_sample(xyz, max(n // cfg.downsample_scale, 1))
    down_mask = torch.zeros(b, n, dtype=torch.bool, device=xyz.device)
    down_mask.scatter_(1, didx, True)
    masks = {shifted: window_masks(xyz, ws, shifted, down_mask) for shifted in (False, True)}
    idx = crpe_index(xyz, ws, quant, 2 * cfg.quant_len)
    for i, bp in enumerate(params):
        feats = _block(bp, feats, masks[bool(i % 2)], idx, cfg.num_heads[stage_idx])
    return feats


# --- the whole model -------------------------------------------------------------


def init(cfg: StratifiedConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters with the reference's keys and shapes
    (drawn on the CPU, moved to ``device``; None: the card)."""
    def build():
        trunc = _trunc(generator)
        l2 = 2 * cfg.quant_len
        c0, n_kp = cfg.channels[0], cfg.n_kernel_pts
        d2 = max(c0 // 4, 1)

        def kpconv(cin, cout):
            return {"w": trunc(n_kp, cin, cout) * np.sqrt(1.0 / (cin * n_kp))}

        params: Dict[str, Any] = {
            "stem": {"kp1": kpconv(cfg.in_channels, c0), "bn1": _norm_init(c0),
                     "unary1": _linear_init(trunc, c0, d2, bias=False), "ubn1": _norm_init(d2),
                     "kp2": kpconv(d2, d2), "unary2": _linear_init(trunc, d2, c0, bias=False),
                     "ubn2": _norm_init(c0), "bn2": _norm_init(c0)},
            "down0": {"norm": _norm_init(c0),
                      "lin": _linear_init(trunc, c0, cfg.channels[1], bias=False)},
            "stages": [], "downs": [], "ups": [],
        }
        for s in range(1, len(cfg.channels)):
            c, heads = cfg.channels[s], cfg.num_heads[s]
            hd, hidden = c // heads, int(c * cfg.mlp_ratio)
            params["stages"].append([{
                "ln1": _norm_init(c),
                "attn": {"qkv": _linear_init(trunc, c, 3 * c), "proj": _linear_init(trunc, c, c),
                         "rel_q": trunc(l2, heads, hd, 3) * 0.02,
                         "rel_k": trunc(l2, heads, hd, 3) * 0.02},
                "ln2": _norm_init(c),
                "fc1": _linear_init(trunc, c, hidden),
                "fc2": _linear_init(trunc, hidden, c),
            } for _ in range(cfg.depths[s])])
            if s < len(cfg.channels) - 1:
                params["downs"].append({"norm": _norm_init(c),
                                        "lin": _linear_init(trunc, c, cfg.channels[s + 1],
                                                            bias=False)})
        for s in range(len(cfg.channels) - 1, 0, -1):
            ci, co = cfg.channels[s], cfg.channels[s - 1]
            params["ups"].append({"norm1": _norm_init(co), "lin1": _linear_init(trunc, co, co),
                                  "norm2": _norm_init(ci), "lin2": _linear_init(trunc, ci, co)})
        params["head"] = {"fc1": _linear_init(trunc, c0, c0), "norm": _norm_init(c0),
                          "fc2": _linear_init(trunc, c0, cfg.num_classes)}
        return params

    return _init_on(device, build)


def forward(params: Params, points: torch.Tensor, cfg: StratifiedConfig,
            features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B, N, 3] (features [B, N, in_channels], else the first
    ``in_channels`` columns of ``points``) -> per-point logits
    [B, N, num_classes]."""
    xyz = points[..., :3]
    feats = features if features is not None else points[..., :cfg.in_channels]
    feats = _stem(params["stem"], xyz, feats, cfg)
    skips = [(xyz, feats)]
    xyz_s, feats_s = _transition_down(params["down0"], xyz, feats, cfg)
    n_stage = len(cfg.channels) - 1
    for s in range(1, n_stage + 1):
        ws = cfg.window_size * 2.0 ** (s - 1)
        quant = cfg.quant_size * 2.0 ** (s - 1)
        feats_s = _stage(params["stages"][s - 1], feats_s, xyz_s, ws, quant, cfg, s)
        if s < n_stage:
            skips.append((xyz_s, feats_s))
            xyz_s, feats_s = _transition_down(params["downs"][s - 1], xyz_s, feats_s, cfg)
    for up in params["ups"]:
        skip_xyz, skip_feats = skips.pop()
        interp = point_interp.three_interpolation(
            skip_xyz, xyz_s, _linear(up["lin2"], _ln(up["norm2"], feats_s)))
        feats_s = _linear(up["lin1"], _ln(up["norm1"], skip_feats)) + interp
        xyz_s = skip_xyz
    h = params["head"]
    return _linear(h["fc2"], _gelu(_ln(h["norm"], _linear(h["fc1"], feats_s))))


def _register() -> None:
    _register_entries({"StratifiedTransformer": (init, forward, StratifiedConfig)})


_register()

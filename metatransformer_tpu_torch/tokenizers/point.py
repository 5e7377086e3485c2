"""Point-cloud tokenizer: FPS subsample + kNN group + conv embed.

Port of ``metatransformer_tpu/tokenizers/point.py`` (PointPatchEmbed): FPS
downsample by ``sample_ratio``, kNN(32) or ball-query grouping,
relative-position features (feature_type dp / fj / dp_fj / dp_df / df), two
1x1-conv stages with a max-pool bottleneck in between, final pool over the
group -> one token per center.

The "Conv2d 1x1" stages are matmuls over the channel axis of channels-last
[B, M, K, C]; FPS (a hand-written CUDA kernel on the card) and kNN come
from :mod:`metatransformer_tpu_torch.ops.point_ops`. InstanceNorm is the
stateless normalisation over (M, K) per channel with the biased variance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.ops import point_ops


# conv-input channel count per feature_type
def _feature_channels(feature_type: str, in_channels: int) -> int:
    return {
        "dp": 3,
        "fj": in_channels,
        "df": in_channels,
        "dp_fj": 3 + in_channels,
        "dp_df": 3 + in_channels,
    }[feature_type]


@dataclasses.dataclass(frozen=True)
class PointTokenizerConfig:
    sample_ratio: float = 0.25
    group_size: int = 32
    in_channels: int = 3
    embed_dim: int = 768
    layers: int = 4
    subsample: str = "fps"  # "fps" | "random"
    group: str = "knn"  # "knn" | "ballquery"
    radius: float = 0.1
    feature_type: str = "dp_fj"
    relative_xyz: bool = True
    normalize_dp: bool = False
    norm: str = "in2d"  # "in2d" | "none"
    reduction: str = "max"  # "max" | "mean"
    # Matmul precision of the conv stack. "highest" = fp32 operands (TF32
    # off), the parity setting. "default" = operands rounded to bf16,
    # products accumulated in fp32 on the tensor cores and handed back in
    # fp32 with an fp32 bias: no rounding of the result, so InstanceNorm and
    # ReLU see the fp32 sums. It is the serving setting, matching the BF16
    # encoder the stack feeds; the stack holds most of the point path's
    # arithmetic (K = 32 multiplies every stage).
    precision: str = "highest"  # "highest" | "default"

    @property
    def channels(self) -> Tuple[int, ...]:
        c0 = _feature_channels(self.feature_type, self.in_channels)
        half = self.layers // 2
        chans = [c0] + [self.embed_dim] * half + [self.embed_dim * 2] * (half - 1)
        chans.append(self.embed_dim)
        return tuple(chans)


def init(
    cfg: PointTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """Normal(0, cin**-0.5) weights drawn on the CPU, zero biases, moved to
    ``device`` (None: the card)."""
    device = _device.resolve(device)
    chans = list(cfg.channels)
    half = cfg.layers // 2
    params: Dict[str, torch.Tensor] = {}
    # stages 0..half-1 run over chans; stage `half` sees the max-pool concat
    for i in range(cfg.layers):
        cin = chans[i] * (2 if i == half else 1)
        cout = chans[i + 1]
        params[f"w{i}"] = (torch.randn(cin, cout, generator=generator) * cin**-0.5).to(device)
        params[f"b{i}"] = torch.zeros(cout, dtype=torch.float32, device=device)
    return params


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over the (M, K) axes per channel."""
    var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _conv_stage(x, params, cfg, idx, with_norm_act, mm):
    x = enc.linear_at(x, params[f"w{idx}"], params[f"b{idx}"], mm)
    if with_norm_act:
        if cfg.norm == "in2d":
            x = _instance_norm(x)
        x = torch.relu(x)
    return x


def _pool(x: torch.Tensor, cfg: PointTokenizerConfig) -> torch.Tensor:
    """Reduce over the group axis K: [B, M, K, C] -> [B, M, 1, C]."""
    if cfg.reduction in ("mean", "avg"):
        return x.mean(dim=2, keepdim=True)
    return x.amax(dim=2, keepdim=True)


def apply(
    params: Dict[str, torch.Tensor],
    points: torch.Tensor,  # [B, N, 3]
    cfg: PointTokenizerConfig,
    features: Optional[torch.Tensor] = None,  # [B, N, C]; default = xyz
    generator: Optional[torch.Generator] = None,  # for subsample='random'
    mm: Optional[str] = None,  # None -> cfg.precision
    return_grouped: bool = False,
):
    """-> (center_p [B, M, 3], tokens [B, M, embed_dim]); with
    ``return_grouped`` also the relative grouped coords dp [B, M, K, 3]
    (the reconstruction target of the masked point ViT)."""
    if mm is None:
        mm = cfg.precision
    b, n, _ = points.shape
    m = int(n * cfg.sample_ratio)
    x = points if features is None else features

    if cfg.subsample == "fps":
        idx = point_ops.furthest_point_sample(points, m)
    else:
        if generator is None:
            raise ValueError("random subsample needs a torch.Generator")
        idx = point_ops.random_sample(generator, points, m)
    center_p = point_ops.gather_points(points, idx)  # [B, M, 3]

    if cfg.group == "knn":
        _, nidx = point_ops.knn(center_p, points, cfg.group_size)
    else:
        nidx = point_ops.ball_query(center_p, points, cfg.radius, cfg.group_size)
    dp, fj = point_ops.group_points(
        center_p, points, nidx, x,
        relative_xyz=cfg.relative_xyz, normalize_dp=cfg.normalize_dp,
    )  # dp [B,M,K,3], fj [B,M,K,C]

    if cfg.feature_type == "dp":
        feats = dp
    elif cfg.feature_type == "fj":
        feats = fj
    elif cfg.feature_type == "dp_fj":
        feats = torch.cat([dp, fj], dim=-1)
    else:  # df / dp_df: subtract center features
        center_x = point_ops.gather_points(x, idx)[:, :, None, :]
        df = fj - center_x
        feats = df if cfg.feature_type == "df" else torch.cat([dp, df], dim=-1)

    half = cfg.layers // 2
    h = feats
    for i in range(half):
        h = _conv_stage(h, params, cfg, i, with_norm_act=(i != half - 1), mm=mm)
    h = torch.cat([_pool(h, cfg).expand_as(h), h], dim=-1)
    for i in range(half, cfg.layers):
        h = _conv_stage(h, params, cfg, i, with_norm_act=(i != cfg.layers - 1), mm=mm)
    tokens = _pool(h, cfg)[:, :, 0, :]  # [B, M, D]
    if return_grouped:
        return center_p, tokens, dp
    return center_p, tokens

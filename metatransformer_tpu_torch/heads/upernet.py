"""UperNet decode head: PPM + FPN fusion -> per-pixel class logits.

Port of ``metatransformer_tpu/heads/upernet.py`` (the ADE20K UperNet recipe
on the Meta-Transformer backbone). The PPM pools the 1/32 map to 1, 2, 3
and 6 cells (an antialiased resize, as ``jax.image.resize`` downsamples),
FPN laterals fuse the four scales, everything is resized to 1/4 and a
fusion conv and a classifier give the logits. NHWC maps, HWIO weights,
conv + GroupNorm + ReLU blocks, the ReLU's gradient through
:func:`..ops.gates.act_gate`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.vit_adapter import _to, conv2d, group_norm, resize
from metatransformer_tpu_torch.ops.gates import gated_relu


@dataclasses.dataclass(frozen=True)
class UperNetConfig:
    in_dim: int = 768  # all 4 scales share the backbone dim
    channels: int = 512
    num_classes: int = 150  # ADE20K
    pool_scales: tuple = (1, 2, 3, 6)


def _conv_gn(randn, cin, cout, k=3):
    return {
        "w": randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin)),
        "b": torch.zeros(cout),
        "gn_scale": torch.ones(cout),
        "gn_bias": torch.zeros(cout),
    }


def init(cfg: UperNetConfig, generator: torch.Generator,
         device: _device.Device = None) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, moved to ``device``)."""
    device = _device.resolve(device)
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    c = cfg.channels
    params: Dict[str, Any] = {}
    for i in range(len(cfg.pool_scales)):
        params[f"ppm{i}"] = _conv_gn(randn, cfg.in_dim, c, k=1)
    params["ppm_bottleneck"] = _conv_gn(randn, cfg.in_dim + len(cfg.pool_scales) * c, c)
    for i in range(3):  # laterals for f1 ... f3
        params[f"lateral{i}"] = _conv_gn(randn, cfg.in_dim, c, k=1)
        params[f"fpn{i}"] = _conv_gn(randn, c, c)
    params["fusion"] = _conv_gn(randn, 4 * c, c)
    params["cls_w"] = randn(1, 1, c, cfg.num_classes) * c**-0.5
    params["cls_b"] = torch.zeros(cfg.num_classes)
    return _to(params, device)


def _apply_cb(x, p):
    x = conv2d(x, p["w"], p["b"])
    return gated_relu(group_norm(x, p["gn_scale"], p["gn_bias"]))


def apply(params: Dict[str, Any], feats: List[torch.Tensor], cfg: UperNetConfig) -> torch.Tensor:
    """feats = [f1 ... f4] NHWC -> logits at f1's resolution [B, H/4, W/4, C]."""
    f1, f2, f3, f4 = feats
    h4, w4 = f4.shape[1:3]

    # PPM on f4
    ppm_outs = [f4]
    for i, scale in enumerate(cfg.pool_scales):
        pooled = _apply_cb(resize(f4, (scale, scale)), params[f"ppm{i}"])
        ppm_outs.append(resize(pooled, (h4, w4)))
    top = _apply_cb(torch.cat(ppm_outs, -1), params["ppm_bottleneck"])

    # FPN top-down
    laterals = [_apply_cb(f, params[f"lateral{i}"]) for i, f in enumerate((f1, f2, f3))]
    laterals.append(top)
    for i in (2, 1, 0):
        laterals[i] = laterals[i] + resize(laterals[i + 1], laterals[i].shape[1:3])
    outs = [_apply_cb(laterals[i], params[f"fpn{i}"]) for i in range(3)] + [laterals[3]]
    target = tuple(outs[0].shape[1:3])
    outs = [resize(o, target) if tuple(o.shape[1:3]) != target else o for o in outs]
    fused = _apply_cb(torch.cat(outs, -1), params["fusion"])
    return conv2d(fused, params["cls_w"], params["cls_b"])

"""BEiT-style transformer blocks (rel-pos bias + LayerScale), in PyTorch.

Port of ``metatransformer_tpu/core/beit.py``: separate q / v biases and an
unbiased k (UniPerceiver's ``k_bias`` where the tree has one), a per-layer
relative-position bias table indexed by a precomputed geometry index, and
LayerScale ``gamma_1`` / ``gamma_2`` on both residuals. Leaves are stacked
``[depth, ...]`` with linear weights ``[in, out]``, the reference's layout.
Attention is plain (materialised logits): no kernel takes the bias table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BEiTConfig:
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6  # BEiT uses eps=1e-6
    window: Tuple[int, int] = (14, 14)  # patch grid (img 224 / patch 16)
    init_values: float = 0.1  # LayerScale init

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def num_relative_distance(self) -> int:
        wh, ww = self.window
        return (2 * wh - 1) * (2 * ww - 1) + 3


def relative_position_index(window: Tuple[int, int]) -> np.ndarray:
    """[Wh*Ww+1, Wh*Ww+1] int index into the bias table; the +1 row and
    column are the cls token's three special distances."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    nrd = (2 * wh - 1) * (2 * ww - 1) + 3
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = nrd - 3
    idx[0:, 0] = nrd - 2
    idx[0, 0] = nrd - 1
    return idx


def windowed_relative_position_index(full_window: Tuple[int, int], win: int) -> np.ndarray:
    """[win*win, win*win] indices into the full grid's table for a win x
    win window (no cls row): in-window offsets are a subset of the full
    grid's, so one table serves windowed blocks too."""
    wh, ww = full_window
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def param_shapes(cfg: BEiTConfig) -> Dict[str, tuple]:
    d, m, h = cfg.dim, cfg.mlp_dim, cfg.num_heads
    return {
        "norm1_scale": (d,), "norm1_bias": (d,),
        "qkv_w": (d, 3 * d),
        "q_bias": (d,), "v_bias": (d,),  # k has no bias
        "rel_pos_table": (cfg.num_relative_distance, h),
        "proj_w": (d, d), "proj_b": (d,),
        "gamma_1": (d,), "gamma_2": (d,),
        "norm2_scale": (d,), "norm2_bias": (d,),
        "fc1_w": (d, m), "fc1_b": (m,),
        "fc2_w": (m, d), "fc2_b": (d,),
    }


def init(cfg: BEiTConfig, generator: torch.Generator, device: _device.Device = None) -> Params:
    """Trunc-normal .02 weights, ones LN scales, LayerScale at
    ``init_values``, zeros elsewhere; drawn on the CPU, moved to ``device``."""
    device = _device.resolve(device)
    params = {}
    for name, shape in param_shapes(cfg).items():
        full = (cfg.depth,) + shape
        if name.endswith("_w"):
            w = torch.empty(full)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            params[name] = w * 0.02
        elif "scale" in name:
            params[name] = torch.ones(full)
        elif name.startswith("gamma"):
            params[name] = torch.full(full, cfg.init_values)
        else:
            params[name] = torch.zeros(full)
    return {k: v.to(device) for k, v in params.items()}


def attention(
    x: torch.Tensor,
    p: Params,
    cfg: BEiTConfig,
    rel_index: Optional[torch.Tensor],  # [T, T] int, or None for no rel bias
    precision: enc.Precision,
) -> torch.Tensor:
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    cd = precision.compute_dtype
    xc = x.to(cd)
    w = p["qkv_w"].to(cd).reshape(d, 3, h, hd)
    q = torch.einsum("btd,dhk->bhtk", xc, w[:, 0]) + p["q_bias"].to(cd).reshape(h, 1, hd)
    k = torch.einsum("btd,dhk->bhtk", xc, w[:, 1])
    if "k_bias" in p:  # UniPerceiver's in_proj has a full qkv bias
        k = k + p["k_bias"].to(cd).reshape(h, 1, hd)
    v = torch.einsum("btd,dhk->bhtk", xc, w[:, 2]) + p["v_bias"].to(cd).reshape(h, 1, hd)
    logits = torch.einsum("bhtk,bhsk->bhts", q * float(hd) ** -0.5, k).float()
    if rel_index is not None:
        bias = p["rel_pos_table"][rel_index]  # [T, T, H]
        logits = logits + bias.permute(2, 0, 1)[None].float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhts,bhsk->bhtk", probs, v)
    proj = p["proj_w"].to(cd).reshape(h, hd, d)
    out = torch.einsum("bhtk,hkd->btd", o, proj) + p["proj_b"].to(cd)
    return out.to(x.dtype)


def block(
    x: torch.Tensor,
    p: Params,
    cfg: BEiTConfig,
    rel_index: Optional[torch.Tensor],
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """BEiT Block: pre-LN + LayerScale residuals."""
    h = enc.layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.ln_eps)
    x = x + p["gamma_1"].to(x.dtype) * attention(h, p, cfg, rel_index, precision)
    h = enc.layer_norm(x, p["norm2_scale"], p["norm2_bias"], cfg.ln_eps)
    return x + p["gamma_2"].to(x.dtype) * enc.mlp(h, p, precision)


def encode(
    params: Params,
    x: torch.Tensor,  # [B, T, D]; T = Wh*Ww+1 when use_rel_bias
    cfg: BEiTConfig,
    precision: enc.Precision = enc.FP32,
    use_rel_bias: bool = True,
) -> torch.Tensor:
    """The whole BEiT stack as a loop over the stacked layer params."""
    rel_index = None
    if use_rel_bias:
        t = cfg.window[0] * cfg.window[1] + 1
        if x.shape[1] != t:
            raise ValueError(f"T={x.shape[1]} does not match window {cfg.window} (+cls={t})")
        rel_index = torch.from_numpy(relative_position_index(cfg.window)).to(x.device)
    x = x.to(precision.compute_dtype)
    layers = {k: v.unbind(0) for k, v in params.items()}
    for i in range(cfg.depth):
        x = block(x, {k: v[i] for k, v in layers.items()}, cfg, rel_index, precision)
    return x

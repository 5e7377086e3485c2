"""Windowed attention for square token grids.

Port of ``metatransformer_tpu/ops/window_attention.py``: attention
restricted to non-overlapping windows of the 2D token grid, as the
ViT-Adapter's windowed blocks run it. Partitioning is a reshape and a
permute; the windows then go through an ordinary block as a batch. The grid
is padded with zeros to a window multiple and there is no key mask, as in
the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, grid_h: int, grid_w: int, window: int) -> torch.Tensor:
    """[B, H*W, C] grid tokens -> [B*nW, window*window, C]."""
    b, _, c = x.shape
    nh, nw = grid_h // window, grid_w // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window * window, c)


def window_unpartition(x: torch.Tensor, batch: int, grid_h: int, grid_w: int,
                       window: int) -> torch.Tensor:
    """Inverse of :func:`window_partition` -> [B, H*W, C]."""
    c = x.shape[-1]
    nh, nw = grid_h // window, grid_w // window
    x = x.reshape(batch, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, grid_h * grid_w, c)


def windowed_block(x: torch.Tensor, block_fn, grid_h: int, grid_w: int,
                   window: int = 14) -> torch.Tensor:
    """A per-token transformer block (``block_fn``: [Bw, w*w, C] -> same)
    with window-restricted attention: pad the grid to a window multiple,
    partition, apply, unpartition, crop. LayerNorm, MLP and the residual are
    per token, so only attention sees the windows."""
    b, _, c = x.shape
    gh = -(-grid_h // window) * window
    gw = -(-grid_w // window) * window
    padded = (gh, gw) != (grid_h, grid_w)
    if padded:
        xg = F.pad(x.reshape(b, grid_h, grid_w, c), (0, 0, 0, gw - grid_w, 0, gh - grid_h))
        x = xg.reshape(b, gh * gw, c)
    out = window_unpartition(block_fn(window_partition(x, gh, gw, window)), b, gh, gw, window)
    if padded:
        out = out.reshape(b, gh, gw, c)[:, :grid_h, :grid_w].reshape(b, grid_h * grid_w, c)
    return out


def windowed_attention(x: torch.Tensor, attn_fn, grid_h: int, grid_w: int,
                       window: int = 14) -> torch.Tensor:
    """Apply ``attn_fn`` within non-overlapping windows (the grid divides
    the window)."""
    xw = window_partition(x, grid_h, grid_w, window)
    return window_unpartition(attn_fn(xw), x.shape[0], grid_h, grid_w, window)

"""Classification heads.

Port of ``metatransformer_tpu/heads/cls.py``: the plain ``mlp_head``
(LayerNorm + Linear) and the openpoints ``ClsHead`` MLP stack
(Linear -> ReLU per hidden layer, dropout before each Linear at train
time).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class ClsHeadConfig:
    in_dim: int
    num_classes: int
    # Hidden layer widths; () = single Linear (timm-style mlp_head).
    mlps: Sequence[int] = ()
    use_norm: bool = True  # LayerNorm before the stack (mlp_head style)
    dropout: float = 0.0  # applied before each Linear at train time
    ln_eps: float = 1e-6

    def __post_init__(self):
        object.__setattr__(self, "mlps", tuple(self.mlps))


def init(
    cfg: ClsHeadConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """LN ones/zeros; Normal(0, din**-0.5) weights drawn on the CPU."""
    device = _device.resolve(device)
    dims = [cfg.in_dim, *cfg.mlps, cfg.num_classes]
    params: Dict[str, torch.Tensor] = {}
    if cfg.use_norm:
        params["norm_scale"] = torch.ones(cfg.in_dim, device=device)
        params["norm_bias"] = torch.zeros(cfg.in_dim, device=device)
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(din, dout, generator=generator) * din**-0.5
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros(dout, device=device)
    return params


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ClsHeadConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[B, in_dim] features -> [B, num_classes] logits.

    Each Linear promotes its input to the weight's dtype, as JAX's type
    promotion does, so bf16 features give fp32 logits.
    """
    if cfg.use_norm:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        x = (
            (xf - mean) * torch.rsqrt(var + cfg.ln_eps) * params["norm_scale"]
            + params["norm_bias"]
        ).to(x.dtype)
    n_layers = len(cfg.mlps) + 1
    for i in range(n_layers):
        if train and cfg.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout needs a torch.Generator at train time")
            keep = (
                torch.rand(x.shape, generator=generator, device=x.device)
                < 1.0 - cfg.dropout
            )
            x = torch.where(keep, x / (1.0 - cfg.dropout), 0.0)
        w = params[f"w{i}"]
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt) @ w.to(dt) + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x

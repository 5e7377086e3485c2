"""Multi-dataset fusion (MDF): per-dataset norms and domain attention.

Port of ``metatransformer_tpu/models/mdf.py`` (the 3DTrans joint Waymo +
nuScenes training): ``pcdet/utils/uni3d_norm.py`` (UniNorm: one norm a
dataset, switched by ``dataset_from_flag``) and the SE-style domain
attention of ``mdf_models/dense_cr.py`` (one SE adapter a dataset, their
outputs mixed by a softmax router).

As in the reference, the per-dataset parameters are stacked on a leading
axis and gathered by the dataset id, which is a Python int or a 0-d integer
tensor here; the gradient reaches only the gathered row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.models.vit_adapter import _to

Params = Dict[str, torch.Tensor]
DatasetId = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class UniNormConfig:
    channels: int
    num_datasets: int = 2
    eps: float = 1e-5


def uni_norm_init(cfg: UniNormConfig) -> Params:
    return {"scale": torch.ones(cfg.num_datasets, cfg.channels),
            "bias": torch.zeros(cfg.num_datasets, cfg.channels)}


def uni_norm_apply(params: Params, x: torch.Tensor, dataset_id: DatasetId,
                   cfg: UniNormConfig) -> torch.Tensor:
    """x [..., C] normalised over every axis but the channels, then the
    dataset's affine (UniNorm: shared compute, a dataset's own affine)."""
    axes = tuple(range(x.dim() - 1))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + cfg.eps)
    return xn * params["scale"][dataset_id] + params["bias"][dataset_id]


@dataclasses.dataclass(frozen=True)
class DomainAttentionConfig:
    channels: int
    num_datasets: int = 2
    reduction: int = 16

    @property
    def hidden(self) -> int:
        return max(self.channels // self.reduction, 4)


def domain_attention_init(cfg: DomainAttentionConfig, generator: torch.Generator) -> Params:
    c, h, d = cfg.channels, cfg.hidden, cfg.num_datasets
    return {"se_w1": torch.randn(d, c, h, generator=generator) * c**-0.5,  # per-dataset SE
            "se_w2": torch.randn(d, h, c, generator=generator) * h**-0.5,
            "route_w": torch.randn(c, d, generator=generator) * c**-0.5}  # the router


def domain_attention_apply(params: Params, x: torch.Tensor,
                           cfg: DomainAttentionConfig) -> torch.Tensor:
    """x [B, ..., C] recalibrated by every dataset's SE excitation, mixed by
    a softmax router over the datasets (dense_cr.py's domain attention)."""
    axes = tuple(range(1, x.dim() - 1))
    squeeze = x.mean(axes)  # [B, C]
    h = torch.relu(torch.einsum("bc,dch->bdh", squeeze, params["se_w1"]))
    exc = torch.sigmoid(torch.einsum("bdh,dhc->bdc", h, params["se_w2"]))
    route = torch.softmax(squeeze @ params["route_w"], -1)  # [B, D]
    gate = torch.einsum("bdc,bd->bc", exc, route)
    return x * gate.reshape(gate.shape[0], *([1] * len(axes)), gate.shape[-1])


# --- the MDF-wired classifier (build_network_multi_db's wiring example) -------


@dataclasses.dataclass(frozen=True)
class MDFClassifierConfig:
    in_dim: int = 16
    hidden: int = 32
    num_classes: int = 4
    num_datasets: int = 2

    @property
    def norm1(self) -> UniNormConfig:
        return UniNormConfig(self.hidden, self.num_datasets)

    @property
    def dattn(self) -> DomainAttentionConfig:
        return DomainAttentionConfig(self.hidden, self.num_datasets, reduction=4)


def mdf_classifier_init(cfg: MDFClassifierConfig, generator: torch.Generator,
                        device: _device.Device = None):
    """Seeded parameters with the reference's keys and shapes (drawn on the
    CPU, moved to ``device``; None: the card)."""
    params = {"fc1_w": torch.randn(cfg.in_dim, cfg.hidden, generator=generator) * cfg.in_dim**-0.5,
            "fc1_b": torch.zeros(cfg.hidden), "norm1": uni_norm_init(cfg.norm1),
            "dattn": domain_attention_init(cfg.dattn, generator),
            "head_w": torch.randn(cfg.hidden, cfg.num_classes, generator=generator)
            * cfg.hidden**-0.5,
            "head_b": torch.zeros(cfg.num_classes)}
    return _to(params, _device.resolve(device))


def mdf_classifier_forward(params, x: torch.Tensor, dataset_id: DatasetId,
                           cfg: MDFClassifierConfig) -> torch.Tensor:
    """x [B, in_dim] -> logits [B, num_classes]."""
    h = uni_norm_apply(params["norm1"], x @ params["fc1_w"] + params["fc1_b"], dataset_id,
                       cfg.norm1)
    h = domain_attention_apply(params["dattn"], torch.relu(h)[:, None, :], cfg.dattn)[:, 0]
    return h @ params["head_w"] + params["head_b"]

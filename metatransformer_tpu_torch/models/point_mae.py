"""Masked point ViT: MAE-style self-supervised point-cloud pretraining.

Port of ``metatransformer_tpu/models/point_mae.py``: a point-ViT encoder
over the *visible* groups only (random per-sample masking by argsort of
uniform noise), a small decoder that fills masked slots with a learned mask
token, a linear head predicting the K grouped relative coordinates of every
patch, and a per-patch Chamfer-L1 reconstruction loss over the flattened
(B*L, K, 3) patch batch (all patches, as the reference's shipped loss).

:func:`forward_at` takes the shuffle, so two implementations can be held to
one mask; :func:`forward` draws it from a ``torch.Generator``. The model
runs under the FP32 policy, as in the reference; at the default geometry
(64 groups, 16 visible) both encoders see short sequences and materialise
their attention. The positional MLPs use the tanh form of GELU (the
reference calls ``jax.nn.gelu`` with its default here, unlike the point
classifier's exact erf).

The reference's model-registry hook waits for ``utils/registry.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.ops import point_interp
from metatransformer_tpu_torch.tokenizers import point as point_tok


@dataclasses.dataclass(frozen=True)
class MaskedPointViTConfig:
    """Defaults of the reference: sample_ratio 0.0625, group 32, feature dp;
    decoder 192 x 4, 16 heads; mask_ratio 0.75."""

    dim: int = 384
    depth: int = 12
    num_heads: int = 6
    decoder_dim: int = 192
    decoder_depth: int = 4
    decoder_heads: int = 16
    mask_ratio: float = 0.75
    sample_ratio: float = 0.0625
    group_size: int = 32

    @property
    def encoder(self) -> enc.EncoderConfig:
        return enc.EncoderConfig(
            dim=self.dim, depth=self.depth, num_heads=self.num_heads, ln_eps=1e-6
        )

    @property
    def decoder(self) -> enc.EncoderConfig:
        return enc.EncoderConfig(
            dim=self.decoder_dim, depth=self.decoder_depth,
            num_heads=self.decoder_heads, ln_eps=1e-6,
        )

    @property
    def tokenizer(self) -> point_tok.PointTokenizerConfig:
        return point_tok.PointTokenizerConfig(
            sample_ratio=self.sample_ratio,
            group_size=self.group_size,
            embed_dim=self.dim,
            feature_type="dp",
        )


def _pos_mlp(p: Dict[str, torch.Tensor], xyz: torch.Tensor) -> torch.Tensor:
    return F.gelu(xyz @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


def init(
    cfg: MaskedPointViTConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    d, dd = cfg.dim, cfg.decoder_dim
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=device)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)

    def xavier(i, o):
        bound = (6.0 / (i + o)) ** 0.5
        return ((torch.rand(i, o, generator=generator) * 2.0 - 1.0) * bound).to(device)

    def pos_mlp(out_dim):
        return {
            "w1": (randn(3, 128) * (2.0 / 3) ** 0.5).to(device), "b1": zeros(128),
            "w2": (randn(128, out_dim) * (1.0 / 128) ** 0.5).to(device), "b2": zeros(out_dim),
        }

    return {
        "tokenizer": point_tok.init(cfg.tokenizer, generator, device),
        "cls_token": (randn(1, 1, d) * 0.02).to(device),
        "cls_pos": (randn(1, 1, d) * 0.02).to(device),
        "pos_mlp": pos_mlp(d),
        "encoder": enc.init(cfg.encoder, generator, device),
        "enc_ln_scale": ones(d), "enc_ln_bias": zeros(d),
        "decoder_embed": {"w": xavier(d, dd), "b": zeros(dd)},
        "mask_token": (randn(1, 1, dd) * 0.02).to(device),
        "decoder_cls_pos": (randn(1, 1, dd) * 0.02).to(device),
        "decoder_pos_mlp": pos_mlp(dd),
        "decoder": enc.init(cfg.decoder, generator, device),
        "dec_ln_scale": ones(dd), "dec_ln_bias": zeros(dd),
        "decoder_pred": {"w": xavier(dd, cfg.group_size * 3), "b": zeros(cfg.group_size * 3)},
    }


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def forward_at(
    params: Dict[str, Any],
    points: torch.Tensor,  # [B, N, 3]
    ids_shuffle: torch.Tensor,  # [B, L] a permutation of the L groups per sample
    cfg: MaskedPointViTConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pretrain forward for a given shuffle (its first ``len_keep``
    entries are the visible groups): -> (chamfer-L1 loss, pred [B, L, K*3])."""
    centers, tokens, dp = point_tok.apply(
        params["tokenizer"], points[..., :3], cfg.tokenizer, return_grouped=True
    )
    b, l, d = tokens.shape
    len_keep = max(int(l * (1.0 - cfg.mask_ratio)), 1)
    pos = _pos_mlp(params["pos_mlp"], centers)  # [B, L, D]

    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :len_keep]
    x_vis = _take(tokens, ids_keep)
    pos_vis = _take(pos, ids_keep)

    # encoder over cls + visible tokens, pos added each block
    x = torch.cat([params["cls_token"].expand(b, 1, d), x_vis], dim=1)
    p = torch.cat([params["cls_pos"].expand(b, 1, d), pos_vis], dim=1)
    x = enc.encode(params["encoder"], x, cfg.encoder, pos=p, pos_each_block=True)
    x = enc.layer_norm(x, params["enc_ln_scale"], params["enc_ln_bias"], 1e-6)

    # decoder: embed, fill masked slots with the mask token, unshuffle
    de = params["decoder_embed"]
    x = x @ de["w"] + de["b"]  # [B, 1 + len_keep, DD]
    dd = cfg.decoder_dim
    mask_tok = params["mask_token"].expand(b, l - len_keep, dd)
    x_ = _take(torch.cat([x[:, 1:], mask_tok], dim=1), ids_restore)  # [B, L, DD]
    x = torch.cat([x[:, :1], x_], dim=1)  # cls back in front
    dec_pos = torch.cat(
        [params["decoder_cls_pos"].expand(b, 1, dd),
         _pos_mlp(params["decoder_pos_mlp"], centers)], dim=1,
    )
    x = enc.encode(params["decoder"], x, cfg.decoder, pos=dec_pos, pos_each_block=True)
    x = enc.layer_norm(x, params["dec_ln_scale"], params["dec_ln_bias"], 1e-6)
    dp_pred = params["decoder_pred"]
    pred = (x @ dp_pred["w"] + dp_pred["b"])[:, 1:]  # [B, L, K*3]

    # per-patch chamfer-L1 over the flattened patch batch
    k = cfg.group_size
    loss = point_interp.chamfer_l1_loss(
        pred.reshape(b * l, k, 3), dp.reshape(b * l, k, 3)
    )
    return loss, pred


def forward(
    params: Dict[str, Any],
    points: torch.Tensor,  # [B, N, 3]
    generator: torch.Generator,
    cfg: MaskedPointViTConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pretrain forward with a shuffle drawn from ``generator`` (on its
    own device): random masking by per-sample argsort of uniform noise."""
    b, n, _ = points.shape
    l = int(n * cfg.sample_ratio)
    noise = torch.rand(b, l, generator=generator, device=generator.device)
    ids_shuffle = torch.argsort(noise, dim=1).to(points.device)
    return forward_at(params, points, ids_shuffle, cfg)


def _register() -> None:
    """Register the model as ``MaskedPointViT`` (utils/registry.py)."""
    import types

    from metatransformer_tpu_torch.utils.registry import MODELS

    if "MaskedPointViT" not in MODELS._entries:
        MODELS._entries["MaskedPointViT"] = types.SimpleNamespace(
            init=init, forward=forward, Config=MaskedPointViTConfig
        )


_register()

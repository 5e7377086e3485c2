"""Point-cloud classifier (Meta-Transformer point backbone + ClsHead).

Port of ``metatransformer_tpu/models/point_classifier.py``: the point
tokenizer (FPS + kNN + conv embed), a cls token with its own position, a
2-layer MLP positional embedding of the 3D centers (Linear(3, 128) + exact
GELU, Linear(128, dim)) added at the input of EVERY block, final
LayerNorm(eps 1e-6), pool = concat(cls, max over tokens), and the ClsHead
MLP [512, 256] with dropout 0.5.

At the default geometry (1024 points -> 256 groups, T = 257) under the BF16
policy every block runs the fused sublayers of
:mod:`metatransformer_tpu_torch.ops.fused_block`. The positional MLP and
the head are small and stay fp32 under both policies; only the tokenizer's
conv stack follows ``precision.mm``.

:class:`PointClassifier` is the serving wrapper: it holds the parameters on
one device, already cast for its precision policy, and maps a batch of
clouds to logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.models.image_classifier import ImageClassifier
from metatransformer_tpu_torch.tokenizers import point as point_tok


@dataclasses.dataclass(frozen=True)
class PointClassifierConfig:
    tokenizer: point_tok.PointTokenizerConfig = point_tok.PointTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 40  # ModelNet40
    global_feat: str = "cls,max"
    ln_eps: float = 1e-6
    head_dropout: float = 0.5

    @property
    def head(self) -> cls_head.ClsHeadConfig:
        n_feats = len(self.global_feat.split(","))
        return cls_head.ClsHeadConfig(
            in_dim=n_feats * self.encoder.dim,
            num_classes=self.num_classes,
            mlps=(512, 256),
            use_norm=False,
            dropout=self.head_dropout,
        )


def init_backbone(
    tokenizer: point_tok.PointTokenizerConfig,
    encoder: enc.EncoderConfig,
    generator: torch.Generator,
    device: torch.device,
) -> Dict[str, Any]:
    """The leaves the classifier and the segmenter share: tokenizer,
    encoder, cls token and position, positional MLP, final LayerNorm."""
    d = encoder.dim
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    return {
        "tokenizer": point_tok.init(tokenizer, generator, device),
        "encoder": enc.init(encoder, generator, device),
        "cls_token": (randn(1, 1, d) * 0.02).to(device),
        "cls_pos": (randn(1, 1, d) * 0.02).to(device),
        "posmlp_w0": (randn(3, 128) * 3**-0.5).to(device),
        "posmlp_b0": zeros(128),
        "posmlp_w1": (randn(128, d) * 128**-0.5).to(device),
        "posmlp_b1": zeros(d),
        "norm_scale": torch.ones(d, dtype=torch.float32, device=device),
        "norm_bias": zeros(d),
    }


def init(
    cfg: PointClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    params = init_backbone(cfg.tokenizer, cfg.encoder, generator, device)
    params["head"] = cls_head.init(cfg.head, generator, device)
    return params


def _pos_mlp(params: Dict[str, Any], centers: torch.Tensor) -> torch.Tensor:
    h = centers @ params["posmlp_w0"] + params["posmlp_b0"]
    return F.gelu(h) @ params["posmlp_w1"] + params["posmlp_b1"]  # exact erf


def encode_groups(
    params: Dict[str, Any],
    points: torch.Tensor,
    tokenizer: point_tok.PointTokenizerConfig,
    encoder: enc.EncoderConfig,
    ln_eps: float,
    features: Optional[torch.Tensor],
    precision: enc.Precision,
):
    """Tokenize, prepend the cls token, run the encoder with the position
    added at every block, final LayerNorm.
    -> (center_p [B, M, 3], x [B, 1 + M, D] in the compute dtype)."""
    center_p, tokens = point_tok.apply(
        params["tokenizer"], points, tokenizer, features, mm=precision.mm
    )
    b, _, d = tokens.shape
    cd = precision.compute_dtype
    # cast once here: the encoder would cast the same tensor at every block
    pos = torch.cat(
        [params["cls_pos"].expand(b, 1, d), _pos_mlp(params, center_p)], dim=1
    ).to(cd)
    x = torch.cat([params["cls_token"].to(tokens.dtype).expand(b, 1, d), tokens], dim=1)
    x = enc.encode(
        params["encoder"], x, encoder, pos=pos, pos_each_block=True, precision=precision
    )
    x = enc.layer_norm(x, params["norm_scale"], params["norm_bias"], ln_eps)
    return center_p, x


def forward(
    params: Dict[str, Any],
    points: torch.Tensor,  # [B, N, 3]
    cfg: PointClassifierConfig,
    features: Optional[torch.Tensor] = None,
    precision: enc.Precision = enc.FP32,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """-> logits [B, num_classes] (fp32: the head promotes)."""
    _, x = encode_groups(
        params, points, cfg.tokenizer, cfg.encoder, cfg.ln_eps, features, precision
    )
    feats = []
    body = x[:, 1:, :]
    for kind in cfg.global_feat.split(","):
        if kind == "cls":
            feats.append(x[:, 0, :])
        elif kind == "max":
            feats.append(body.amax(dim=1))
        elif kind in ("avg", "mean"):
            feats.append(body.mean(dim=1))
    gf = torch.cat(feats, dim=-1)
    return cls_head.apply(params["head"], gf, cfg.head, train=train, generator=generator)


class PointClassifier(ImageClassifier):
    """Serving wrapper, constructed like :class:`ImageClassifier` from a
    :class:`PointClassifierConfig` and its parameters: they are held as
    buffers on one device (None: the card), cast once for ``precision``.
    [B, N, 3] float clouds -> [B, num_classes] logits."""

    @torch.no_grad()
    def forward(
        self, points: torch.Tensor, features: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return forward(self.params(), points, self.cfg, features, self.precision)

"""Image / Infrared / X-Ray classification model (the flagship pipeline).

Port of ``metatransformer_tpu/models/image_classifier.py``: a raw
[B, 224, 224, 3] NHWC image (uint8 or float) -> logits through the patch
tokenizer, cls token + learned positional embedding, the shared encoder,
final LayerNorm, cls pool and the LN + Linear head.

:class:`ImageClassifier` is the serving wrapper: it holds the parameters
on one device, already cast for its precision policy, and maps a batch of
images to logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.models import classifier
from metatransformer_tpu_torch.tokenizers import image as image_tok


@dataclasses.dataclass(frozen=True)
class ImageClassifierConfig:
    tokenizer: image_tok.ImageTokenizerConfig = image_tok.ImageTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    num_classes: int = 1000

    @property
    def classifier(self) -> classifier.ClassifierConfig:
        return classifier.ClassifierConfig(
            encoder=self.encoder,
            head=cls_head.ClsHeadConfig(
                in_dim=self.encoder.dim, num_classes=self.num_classes
            ),
            seq_len=self.tokenizer.num_patches,
            num_prefix_tokens=1,
            pos_embed="learned",
            pool="cls",
        )


def init(
    cfg: ImageClassifierConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    params = classifier.init_wrapper(cfg.classifier, generator, device)
    params["tokenizer"] = image_tok.init(cfg.tokenizer, generator, device)
    params["encoder"] = enc.init(cfg.encoder, generator, device)
    return params


def forward(
    params: Dict[str, Any],
    images: torch.Tensor,
    cfg: ImageClassifierConfig,
    precision: enc.Precision = enc.FP32,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    tok_cfg = cfg.tokenizer
    return classifier.forward(
        params,
        images,
        cfg.classifier,
        lambda p, x: image_tok.apply(p, x, tok_cfg),
        precision,
        train=train,
        generator=generator,
    )


def load_encoder(params: Dict[str, Any], encoder_params) -> Dict[str, Any]:
    """Swap in converted frozen encoder weights (the released checkpoint)."""
    out = dict(params)
    out["encoder"] = encoder_params
    return out


class ImageClassifier(nn.Module):
    """Serving wrapper: parameters on one device, cast once for ``precision``.

    The parameter tree is held as buffers named ``<group>__<leaf>``, so
    ``.to(device)`` and ``state_dict()`` see every leaf; :meth:`params`
    rebuilds the nested tree that :func:`forward` takes.
    """

    _SEP = "__"

    def __init__(
        self,
        cfg: ImageClassifierConfig,
        params: Dict[str, Any],
        *,
        precision: enc.Precision = enc.FP32,
        device: _device.Device = None,
    ):
        super().__init__()
        device = _device.resolve(device)
        self.cfg = cfg
        self.precision = precision
        params = dict(params)
        params["encoder"] = enc.cast_params(params["encoder"], precision)
        for name, leaf in self._flatten(params).items():
            self.register_buffer(name, leaf.to(device))

    @classmethod
    def _flatten(cls, tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
        flat = {}
        for k, v in tree.items():
            if cls._SEP in k:
                raise ValueError(f"parameter name {k!r} contains {cls._SEP!r}")
            if isinstance(v, dict):
                flat.update(cls._flatten(v, prefix + k + cls._SEP))
            else:
                flat[prefix + k] = v
        return flat

    def params(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for name, leaf in self.named_buffers():
            *groups, last = name.split(self._SEP)
            node = tree
            for g in groups:
                node = node.setdefault(g, {})
            node[last] = leaf
        return tree

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images (uint8 or float) -> [B, num_classes] logits."""
        return forward(self.params(), images, self.cfg, self.precision)
